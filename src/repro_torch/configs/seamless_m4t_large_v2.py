"""seamless-m4t-large-v2 — [arXiv:2308.11596; hf]

Copy of `repro.configs.seamless_m4t_large_v2`; keep the two in step.

Encoder-decoder transformer BACKBONE only (24 enc + 24 dec layers,
d_model=1024, 16H MHA, d_ff=8192, vocab=256206). The audio/modality
frontend is a STUB: input_specs() provides precomputed frame embeddings
(B, S, d_model). Full attention -> long_500k skipped. Has a decoder ->
decode shapes run (self-KV + cross-KV over encoder states).
"""
from repro_torch.configs.base import ModelConfig, register


@register("seamless-m4t-large-v2")
def seamless_m4t_large_v2() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="encdec",
        num_layers=24,        # decoder layers
        encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256_206,
        act="relu",
        norm="layernorm",
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skipped_shapes={
            "long_500k": "pure full-attention enc-dec — long_500k requires "
            "sub-quadratic attention"
        },
        notes="multimodal enc-dec; frontend stubbed as precomputed frame "
        "embeddings per the assignment.",
    )

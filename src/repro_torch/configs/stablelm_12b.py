"""stablelm-12b — [hf:stabilityai/stablelm-2-1_6b; hf]

Copy of `repro.configs.stablelm_12b`; keep the two in step.

40L d_model=5120 32H (GQA kv=8) d_ff=13824 vocab=100352. LayerNorm family.
Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, register


@register("stablelm-12b")
def stablelm_12b() -> ModelConfig:
    return ModelConfig(
        name="stablelm-12b",
        family="dense",
        num_layers=40,
        d_model=5120,
        num_heads=32,
        num_kv_heads=8,
        head_dim=160,
        d_ff=13_824,
        vocab_size=100_352,
        act="silu",
        norm="layernorm",
        rope_theta=10_000.0,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skipped_shapes={
            "long_500k": "pure full-attention arch — long_500k requires "
            "sub-quadratic attention"
        },
    )

"""yi-9b — [arXiv:2403.04652; hf]

Copy of `repro.configs.yi_9b`; keep the two in step.

48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000. llama-arch GQA.
Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, register


@register("yi-9b")
def yi_9b() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        family="dense",
        num_layers=48,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11_008,
        vocab_size=64_000,
        act="silu",
        norm="rmsnorm",
        rope_theta=10_000.0,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skipped_shapes={
            "long_500k": "pure full-attention arch — long_500k requires "
            "sub-quadratic attention"
        },
    )

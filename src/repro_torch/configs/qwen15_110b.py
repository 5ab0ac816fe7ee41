"""qwen1.5-110b — [hf:Qwen/Qwen1.5-0.5B; hf]

Copy of `repro.configs.qwen15_110b`; keep the two in step.

80L d_model=8192 64H (GQA kv=8) d_ff=49152 vocab=152064, QKV bias.
Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen1.5-110b")
def qwen15_110b() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-110b",
        family="dense",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=49_152,
        vocab_size=152_064,
        qkv_bias=True,
        act="silu",
        norm="rmsnorm",
        rope_theta=1_000_000.0,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skipped_shapes={
            "long_500k": "pure full-attention arch — long_500k requires "
            "sub-quadratic attention"
        },
        notes="largest dense arch (~111B); memory-roofline stress cell.",
    )

"""deepseek-moe-16b — [arXiv:2401.06066; hf]

Copy of `repro.configs.deepseek_moe_16b`; keep the two in step.

28L d_model=2048 16H (MHA kv=16) moe_d_ff=1408 vocab=102400,
2 shared + 64 routed experts top-6, fine-grained. First layer is a dense
FFN with hidden 10944 (per the published config). Full attention ->
long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("deepseek-moe-16b")
def deepseek_moe_16b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        num_layers=28,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,  # routed-expert hidden size
        vocab_size=102_400,
        act="silu",
        norm="rmsnorm",
        rope_theta=10_000.0,
        moe=MoEConfig(
            num_experts=64,
            top_k=6,
            d_ff_expert=1408,
            num_shared_experts=2,
            d_ff_shared=2 * 1408,
            first_dense_layers=1,
            d_ff_dense=10_944,
        ),
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skipped_shapes={
            "long_500k": "pure full-attention arch — long_500k requires "
            "sub-quadratic attention"
        },
        notes="fine-grained MoE with shared experts; skewed small-payload "
        "all-to-all exercises the RotorLB/VLB mode.",
    )

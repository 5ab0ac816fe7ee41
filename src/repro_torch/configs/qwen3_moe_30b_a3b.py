"""qwen3-moe-30b-a3b — [hf:Qwen/Qwen3-30B-A3B; hf]

Copy of `repro.configs.qwen3_moe_30b_a3b`; keep the two in step.

48L d_model=2048 32H (GQA kv=4) d_ff=768(expert) vocab=151936,
MoE 128 experts top-8, no shared experts, every layer sparse
(decoder_sparse_step=1, mlp_only_layers=[]). head_dim=128 and per-head
QK-norm per the published HF config. Full (global) attention -> long_500k
is skipped per the assignment's sub-quadratic rule.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("qwen3-moe-30b-a3b")
def qwen3_moe_30b_a3b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-moe-30b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=768,  # == expert hidden size; all FFNs are MoE
        vocab_size=151_936,
        qk_norm=True,
        act="silu",
        norm="rmsnorm",
        rope_theta=1_000_000.0,
        moe=MoEConfig(
            num_experts=128,
            top_k=8,
            d_ff_expert=768,
        ),
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skipped_shapes={
            "long_500k": "pure full-attention arch (global softmax attention "
            "every layer) — long_500k requires sub-quadratic attention"
        },
        notes="128-expert top-8 MoE; the paper-technique showcase arch "
        "(rotor all-to-all expert dispatch == Opera bulk shuffle).",
    )

"""llama-3.2-vision-90b — [hf:meta-llama/Llama-3.2-11B-Vision; unverified]

Copy of `repro.configs.llama32_vision_90b`; keep the two in step.

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. Every 5th layer
is a cross-attention layer over image tokens (20 cross + 80 self, matching
the 11B->90B scaling of the published cross_attention_layers pattern).
The vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (B, num_image_tokens, d_model). Full attention -> long_500k
skipped.
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama-3.2-vision-90b")
def llama32_vision_90b() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b",
        family="vlm",
        num_layers=100,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28_672,
        vocab_size=128_256,
        act="silu",
        norm="rmsnorm",
        rope_theta=500_000.0,
        cross_attn_every=5,
        num_image_tokens=1600,  # 1601 in HF (tile 448/14 + cls); 1600 keeps
        # the token dim mesh-divisible, delta noted in DESIGN.md
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skipped_shapes={
            "long_500k": "pure full-attention arch — long_500k requires "
            "sub-quadratic attention"
        },
        notes="largest assigned arch (~88B); FSDP+TP stress cell.",
    )

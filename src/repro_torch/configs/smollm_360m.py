"""smollm-360m — [hf:HuggingFaceTB/SmolLM-135M; hf]

Copy of `repro.configs.smollm_360m`; keep the two in step.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152. llama-arch small.
Full attention -> long_500k skipped.
"""
from repro_torch.configs.base import ModelConfig, register


@register("smollm-360m")
def smollm_360m() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        family="dense",
        num_layers=32,
        d_model=960,
        num_heads=15,
        num_kv_heads=5,
        head_dim=64,
        d_ff=2560,
        vocab_size=49_152,
        act="silu",
        norm="rmsnorm",
        tie_embeddings=True,
        shapes=("train_4k", "prefill_32k", "decode_32k"),
        skipped_shapes={
            "long_500k": "pure full-attention arch — long_500k requires "
            "sub-quadratic attention"
        },
        notes="smallest arch; DP/collective-bound cell (grad sync dominates).",
    )

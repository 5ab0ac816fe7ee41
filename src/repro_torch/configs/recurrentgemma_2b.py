"""recurrentgemma-2b — [arXiv:2402.19427; hf]

Copy of `repro.configs.recurrentgemma_2b`; keep the two in step.

26L d_model=2560 10H (MQA kv=1, head_dim=256) d_ff=7680 vocab=256000.
Griffin block pattern: (rglru, rglru, local_attn) repeating, window 2048,
lru_width=2560. Sub-quadratic (local attention + recurrent state) ->
runs long_500k.
"""
from repro_torch.configs.base import HybridConfig, ModelConfig, register


@register("recurrentgemma-2b")
def recurrentgemma_2b() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        num_layers=26,
        d_model=2560,
        num_heads=10,
        num_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256_000,
        act="gelu",
        norm="rmsnorm",
        tie_embeddings=True,
        hybrid=HybridConfig(
            pattern=("rglru", "rglru", "local_attn"),
            local_window=2048,
            lru_width=2560,
        ),
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        notes="RG-LRU + local attention 1:2; decode state = LRU state + a "
        "fixed 2048-token local KV window regardless of context.",
    )

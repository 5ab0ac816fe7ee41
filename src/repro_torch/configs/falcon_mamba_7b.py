"""falcon-mamba-7b — [arXiv:2410.05355; unverified]

Copy of `repro.configs.falcon_mamba_7b`; keep the two in step.

64L d_model=4096 attention-free Mamba-1, ssm_state=16, vocab=65024.
d_inner = 2*d_model = 8192, conv kernel 4, dt_rank = ceil(4096/16) = 256.
Recurrent (O(1)/token) -> runs long_500k.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register("falcon-mamba-7b")
def falcon_mamba_7b() -> ModelConfig:
    return ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        num_layers=64,
        d_model=4096,
        num_heads=1,       # unused (attention-free)
        num_kv_heads=1,
        head_dim=1,
        d_ff=0,            # no FFN: mamba block is the whole mixer
        vocab_size=65_024,
        act="silu",
        norm="rmsnorm",
        ssm=SSMConfig(state_dim=16, conv_kernel=4, expand=2),
        shapes=("train_4k", "prefill_32k", "decode_32k", "long_500k"),
        notes="mamba1 arch; decode state is O(d_inner*(state+conv)) per "
        "layer regardless of context length.",
    )

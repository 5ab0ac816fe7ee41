"""Model configuration system.

Copy of `repro.configs.base` without the dry-run input specs
(`input_specs` builds `jax.ShapeDtypeStruct` stand-ins; the port has no
dry run yet).  Every architecture of the JAX package is a `ModelConfig`
registered under its public id; `get_config` raises `KeyError` for any
other name.  Keep the dataclasses in step with the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional, Tuple


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0           # routed experts
    top_k: int = 0
    d_ff_expert: int = 0           # per-expert FFN hidden size
    num_shared_experts: int = 0    # always-on shared experts (DeepSeekMoE)
    d_ff_shared: int = 0           # total hidden size of the shared branch
    first_dense_layers: int = 0    # leading layers that use a dense FFN
    d_ff_dense: int = 0            # hidden size for those dense layers
    capacity_factor: float = 1.25
    router_aux_weight: float = 1e-2


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_kernel: int = 4
    expand: int = 2
    dt_rank: int = 0               # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class HybridConfig:
    # RecurrentGemma-style block pattern, repeated (+ truncated) to num_layers.
    pattern: Tuple[str, ...] = ()  # entries: "rglru" | "local_attn"
    local_window: int = 2048
    lru_width: int = 0             # 0 -> d_model


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    act: str = "silu"              # silu | gelu | relu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    # enc-dec (family == "encdec"): num_layers counts DECODER layers.
    encoder_layers: int = 0
    # vlm: every `cross_attn_every`-th layer is a cross-attention layer;
    # cross-attn layers are *included* in num_layers (Llama-3.2-V style).
    cross_attn_every: int = 0
    num_image_tokens: int = 0
    # shape-set policy
    shapes: Tuple[str, ...] = ("train_4k", "prefill_32k", "decode_32k")
    skipped_shapes: Dict[str, str] = field(default_factory=dict)
    # numerics / distribution knobs (overridable per run)
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"            # full | none
    norm_upcast: bool = True       # False: bf16 normalize (fp32 reductions)
    loss_chunk_vocab: int = 0      # >0: vocab-chunked CE (no full logits)
    grad_sync: str = "rotor"       # rotor | xla    (inter-pod gradient sync)
    moe_dispatch: str = "rotor"    # rotor | xla | rotor_vlb
    notes: str = ""

    # ---------------- derived -------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def dt_rank_(self) -> int:
        if self.ssm is None:
            return 0
        return self.ssm.dt_rank or -(-self.d_model // 16)

    @property
    def d_inner_(self) -> int:
        return 0 if self.ssm is None else self.ssm.expand * self.d_model

    @property
    def lru_width_(self) -> int:
        if self.hybrid is None:
            return 0
        return self.hybrid.lru_width or self.d_model

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind for heterogeneous stacks."""
        if self.family == "hybrid":
            p = self.hybrid.pattern
            return tuple(p[i % len(p)] for i in range(self.num_layers))
        if self.family == "vlm" and self.cross_attn_every:
            return tuple(
                "cross_attn" if (i + 1) % self.cross_attn_every == 0 else "self_attn"
                for i in range(self.num_layers)
            )
        if self.family == "moe":
            m = self.moe
            return tuple(
                "dense" if i < m.first_dense_layers else "moe"
                for i in range(self.num_layers)
            )
        if self.family == "ssm":
            return ("ssm",) * self.num_layers
        return ("self_attn",) * self.num_layers

    def param_count(self) -> int:
        """Analytic parameter count (exact for our implementation)."""
        from repro_torch.models.model import count_params  # no cycle

        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params

        return count_params(self, active_only=True)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def _load_archs() -> None:
    # import side-effect registration of the ported arch modules
    from repro_torch.configs import (  # noqa: F401
        deepseek_moe_16b,
        falcon_mamba_7b,
        llama32_vision_90b,
        qwen3_moe_30b_a3b,
        qwen15_110b,
        recurrentgemma_2b,
        seamless_m4t_large_v2,
        smollm_360m,
        stablelm_12b,
        yi_9b,
    )


def get_config(name: str) -> ModelConfig:
    _load_archs()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> Tuple[str, ...]:
    _load_archs()
    return tuple(sorted(_REGISTRY))


# --------------------------------------------------------------------------
# Reduced configs for CPU smoke tests: same family/structure, tiny dims.
# --------------------------------------------------------------------------


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    kw: Dict[str, Any] = dict(
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        head_dim=16,
        d_ff=128,
        vocab_size=256,
    )
    if cfg.family == "moe":
        kw["num_layers"] = 3
        kw["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=8,
            top_k=2,
            d_ff_expert=32,
            d_ff_shared=64 if cfg.moe.num_shared_experts else 0,
            d_ff_dense=128 if cfg.moe.first_dense_layers else 0,
        )
    elif cfg.family == "ssm":
        kw["num_layers"] = 2
        kw["ssm"] = dataclasses.replace(cfg.ssm, state_dim=4)
        kw["num_heads"] = 1
        kw["num_kv_heads"] = 1
        kw["head_dim"] = 1
        kw["d_ff"] = 0
    elif cfg.family == "hybrid":
        kw["num_layers"] = 5  # pattern(3) x 1 + tail 2 — exercises the plan
        kw["hybrid"] = dataclasses.replace(
            cfg.hybrid, local_window=8, lru_width=64
        )
    elif cfg.family == "encdec":
        kw["num_layers"] = 2
        kw["encoder_layers"] = 2
    elif cfg.family == "vlm":
        kw["num_layers"] = 4
        kw["cross_attn_every"] = 2
        kw["num_image_tokens"] = 8
    else:
        kw["num_layers"] = 2
    return cfg.replace(**kw)

"""Primitive layers: parameter containers, inits, norms, rotary
embeddings, activations.

Port of `repro.models.layers`.  Parameters live in `ParamTree`s, addressed by the same names as
the JAX package's dict pytree.  The JAX package keeps float32 masters
and casts most weights to the compute dtype at every use; for serving
the port stores each weight in the dtype its use casts it to
(`storage_dtype`), which gives the same forward bits in a fraction of
the memory.  For training (`storage_config(cfg, masters=True)`) every
leaf is a float32 master at ``param_dtype`` with ``requires_grad``:
every use casts, so the forward's bits are the same.  Inits
draw from an explicit `torch.Generator` with the JAX package's
distributions (not its bits: tests carry JAX parameters across with
`models.convert.params_from_numpy`).
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# Weights the JAX forward casts to the compute dtype at every use
# (attention.py:51,63-64,252; moe.py:129-131, 181-183; ffn.py; the causal
# conv's "w"/"b", layers.py:121-122; ssm.py:51,53,89,114; rglru.py:47-48,
# 75-76, 81); the embedding is cast at use too (model.py:77-78) unless it
# doubles as the f32 head.  Everything else (router, norm scales,
# lm_head, the SSM's A_log/D/dt_bias, the RG-LRU's lambda) is used in
# float32.
COMPUTE_STORED = frozenset({
    "wq", "wk", "wv", "wo", "bq", "bk", "bv",
    "w_gate", "w_up", "w_down", "w_in", "b_in", "w_out", "b_out",
    "shared_gate", "shared_up", "shared_down",
    "w", "b", "in_proj", "x_proj", "dt_proj", "out_proj",
    "w_y", "w_x", "w_a", "w_i",
})


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def storage_config(cfg, masters: bool):
    """The config a parameter tree is stored by: `cfg` itself (serving),
    or with ``masters`` every leaf at ``param_dtype`` (training)."""
    return cfg.replace(compute_dtype=cfg.param_dtype) if masters else cfg


def storage_dtype(cfg, name: str) -> torch.dtype:
    """The dtype the port keeps parameter leaf `name` in."""
    if name in COMPUTE_STORED or (name == "embed" and not cfg.tie_embeddings):
        return torch_dtype(cfg.compute_dtype)
    return torch.float32


class ParamTree(nn.Module):
    """Nested parameters addressed like the JAX package's pytree
    (``tree["attn"]["wq"]``, ``"bq" in tree``).  Dict values become
    subtrees, lists `nn.ModuleList`s, tensors frozen `nn.Parameter`s
    (``requires_grad_()`` makes training masters of them); modules are
    kept as they are."""

    def __init__(self, entries: Mapping):
        super().__init__()
        for name, value in entries.items():
            setattr(self, name, _wrap(value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _wrap(value):
    if isinstance(value, nn.Module):
        return value
    if isinstance(value, Mapping):
        return ParamTree(value)
    if isinstance(value, (list, tuple)):
        return nn.ModuleList([_wrap(v) for v in value])
    if isinstance(value, torch.Tensor):
        return nn.Parameter(value, requires_grad=False)
    raise TypeError(f"cannot hold {type(value)} in a ParamTree")


def normal_init(gen: torch.Generator, shape, scale: float,
                dtype: torch.dtype) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (x * scale).to(dtype)


def dense_init(gen, d_in: int, d_out: int, dtype) -> torch.Tensor:
    """Fan-in scaled normal (std = 1/sqrt(d_in))."""
    return normal_init(gen, (d_in, d_out), d_in**-0.5, dtype)


def embed_init(gen, vocab: int, d: int, dtype) -> torch.Tensor:
    # d^-0.5 keeps tied-head logits O(1) at init
    return normal_init(gen, (vocab, d), d**-0.5, dtype)


def act_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),  # jax.nn.gelu
        "relu": F.relu,
    }[name]


# ---------------- norms ----------------------------------------------------


def init_norm(kind: str, d: int, device) -> Dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(kind: str, p, x: torch.Tensor, eps: float = 1e-6,
               upcast: bool = True) -> torch.Tensor:
    """upcast=True materializes the normalized stream in fp32 (safest);
    upcast=False keeps the reduction in fp32 but the normalize/scale in
    the compute dtype."""
    dt = x.dtype
    x32 = x.float()
    if kind == "rmsnorm":
        var = x32.square().mean(-1, keepdim=True)
        inv = torch.rsqrt(var + eps)
        if not upcast:
            return x * inv.to(dt) * p["scale"].to(dt)
        y = x32 * inv
    else:  # layernorm
        mu = x32.mean(-1, keepdim=True)
        var = x32.var(-1, keepdim=True, unbiased=False)
        inv = torch.rsqrt(var + eps)
        if not upcast:
            y = (x - mu.to(dt)) * inv.to(dt) * p["scale"].to(dt)
            return y + p["bias"].to(dt) if "bias" in p else y
        y = (x32 - mu) * inv
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(dt)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head QK-norm (Qwen3): normalize over the head_dim axis."""
    x32 = x.float()
    var = x32.square().mean(-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# ---------------- rotary ----------------------------------------------------


def rope_frequencies(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


@functools.lru_cache(maxsize=8)
def _rope_table(head_dim: int, theta: float,
                device: torch.device) -> torch.Tensor:
    # made once per device: a copy from host memory at every layer would
    # wait for the card to drain its queue
    return torch.as_tensor(rope_frequencies(head_dim, theta),
                           dtype=torch.float32, device=device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, head_dim); positions: (seq,) or (B, seq) at decode."""
    freqs = _rope_table(x.shape[-1], theta, x.device)
    ang = positions.float()[..., None] * freqs  # (..., seq, hd/2)
    if positions.dim() == 2:  # (B, seq): align with (B, H, seq, hd/2)
        ang = ang[:, None, :, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------- causal depthwise conv (mamba / griffin) ------------------


def init_causal_conv(gen: torch.Generator, channels: int, kernel: int,
                     dtype: torch.dtype) -> Dict:
    return {
        "w": normal_init(gen, (channels, kernel), kernel**-0.5, dtype),
        "b": torch.zeros((channels,), dtype=dtype, device=gen.device),
    }


def apply_causal_conv(
    p, x: torch.Tensor, state: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d.  x: (B, S, C); state: (B, K-1, C), the
    last K-1 inputs, oldest first.  Returns (y, new_state).

    new_state is always K-1 rows, right-aligned: after a prompt shorter
    than K-1 tokens its leading rows are the zeros that stood before the
    prompt, so decode convolves over the causal history.  The JAX
    package returns the same rows (layers.py:132) but its callers keep
    ``x_pre[:, -(K-1):]``, which is shorter then (ROADMAP.md Queue 3, R3)."""
    w = p["w"].to(x.dtype)  # (C, K)
    b = p["b"].to(x.dtype)
    K = w.shape[1]
    if state is None:
        state = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    xp = torch.cat([state, x], dim=1)  # (B, S+K-1, C)
    S = x.shape[1]
    y = xp[:, 0:S] * w[:, 0]
    for i in range(1, K):
        y = y + xp[:, i:i + S] * w[:, i]
    y = y + b
    new_state = xp[:, -(K - 1):] if K > 1 else state
    return y, new_state

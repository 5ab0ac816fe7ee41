"""Mamba-1 selective-state-space block (falcon-mamba-7b).

Port of `repro.models.ssm`.  Prefill computes the step sizes and the
input/output projections (dt, B, C) for the whole sequence with plain
matmuls and runs the recurrence through `kernels.mamba_scan`, which on
the card is the hand-written Hopper kernel and also returns the final
state; the JAX package runs a chunked `lax.associative_scan` there
(ssm.py:98-111), the same function.  Decode carries (conv_state,
ssm_state) and is one plain torch step, as in the JAX package.

With `tp` (the mixer split over `model` where `d_inner` divides,
`models.sharding.computes_tp`), as GSPMD partitions the JAX mixer under
its rules, a rank computes its own block of the d_inner channels: the
input enters through `tp_enter`, ``in_proj`` is held as the rank's x
columns beside its z columns (`models.sharding.held_columns`), the conv,
``A_log``, ``D`` and ``dt_bias`` are the rank's channels, ``x_proj``'s
rows and ``dt_proj``'s columns too.  The rank's x gives a partial
(dt_r, B, C) projection, summed over `model` by `tp_sum` (every rank's
channels read all of it, so its backward sums as well); the scan runs on
the rank's channels (on the card the kernel, with its chunk states for
the backward kernel when autograd records), and ``out_proj``'s rows give
a partial output, summed by `tp_exit`.  Both partial products are taken
and summed in float32 and rounded once to the compute dtype, as the
whole product is (`split_product`): rounded a rank at a time, bf16's
noise moved 8 layers' logits as far from one rank's as bf16 is from
float32.  Decode does the same with the
rank's block of the conv state (B, K-1, Di / tp) and of the SSM state
(B, Di / tp, N).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.mamba_scan import mamba_scan
from repro_torch.models.layers import (
    apply_causal_conv,
    dense_init,
    init_causal_conv,
    storage_dtype,
)
from repro_torch.models.parallel import (ParallelContext, split_product,
                                        tp_enter, tp_exit, tp_sum)


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    s = cfg.ssm
    D, Di, N, R = cfg.d_model, cfg.d_inner_, s.state_dim, cfg.dt_rank_
    dt = storage_dtype(cfg, "in_proj")
    dev = gen.device
    # S4D-real init for A
    A = torch.arange(1, N + 1, dtype=torch.float32, device=dev).repeat(Di, 1)
    u = torch.rand((Di,), generator=gen, device=dev, dtype=torch.float32)
    step = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return {
        "in_proj": dense_init(gen, D, 2 * Di, dt),
        "conv": init_causal_conv(gen, Di, s.conv_kernel, dt),
        "x_proj": dense_init(gen, Di, R + 2 * N, dt),
        "dt_proj": dense_init(gen, R, Di, dt),
        "dt_bias": torch.log(torch.expm1(step)),   # softplus^-1(step)
        "A_log": torch.log(A),
        "D": torch.ones((Di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, Di, D, dt),
    }


def _ssm_params(p, x: torch.Tensor, cfg: ModelConfig,
                tp: Optional[ParallelContext] = None):
    """dt (B,T,Di), Bmat (B,T,N), Cmat (B,T,N) from the conv output x;
    with `tp`, x and dt the rank's channels, the projection of x summed
    over `model` in float32."""
    R, N = cfg.dt_rank_, cfg.ssm.state_dim
    dbc = split_product(x, p["x_proj"], tp, tp_sum)
    dt_r, Bm, Cm = torch.split(dbc, [R, N, N], dim=-1)
    dt = dt_r @ p["dt_proj"].to(x.dtype)
    dt = F.softplus(dt.float() + p["dt_bias"])
    return dt, Bm.float().contiguous(), Cm.float().contiguous()


def mamba_mix(p, u: torch.Tensor, cfg: ModelConfig,
              return_state: bool = False,
              tp: Optional[ParallelContext] = None):
    """Full-sequence mixer (train, prefill).  u: (B, S, D).

    With return_state=True also returns (conv_state (B, K-1, Di) in u's
    dtype, ssm_state (B, Di, N) f32) for decode.  The conv state is the
    last K-1 conv inputs right-aligned, zeros first for a prompt shorter
    than K-1 (`layers.apply_causal_conv`; ROADMAP.md Queue 3, R3).  With
    `tp`, `p` holds the rank's channels (the module's docstring) and the
    states are its channels' (Di / tp)."""
    u = tp_enter(u, tp)
    xz = u @ p["in_proj"].to(u.dtype)
    x_pre, z = xz.chunk(2, dim=-1)
    x, conv_state = apply_causal_conv(p["conv"], x_pre)
    x = F.silu(x)
    dt, Bm, Cm = _ssm_params(p, x, cfg, tp)
    A = -torch.exp(p["A_log"])  # (Di, N)
    y, h_last = mamba_scan(x, dt, Bm, Cm, A, p["D"])
    y = y.to(u.dtype) * F.silu(z)
    out = split_product(y, p["out_proj"], tp, tp_exit)
    if return_state:
        return out, conv_state, h_last
    return out


def mamba_decode(
    p,
    u: torch.Tensor,            # (B, 1, D)
    cfg: ModelConfig,
    conv_state: torch.Tensor,   # (B, K-1, Di)
    ssm_state: torch.Tensor,    # (B, Di, N)
    tp: Optional[ParallelContext] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token step; O(1) in context length.  Returns (y, the new
    conv state, the new ssm state); the states passed in are not
    written.  With `tp`, `p` and both states are the rank's channels'."""
    u = tp_enter(u, tp)
    xz = u @ p["in_proj"].to(u.dtype)
    x, z = xz.chunk(2, dim=-1)
    x, conv_state = apply_causal_conv(p["conv"], x, conv_state)
    x = F.silu(x)
    dt, Bm, Cm = _ssm_params(p, x, cfg, tp)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt[:, 0, :, None] * A)                      # (B,Di,N)
    dBx = (dt[:, 0] * x[:, 0].float())[..., None] * Bm[:, 0, None, :]
    h = dA * ssm_state + dBx
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])
    y = y + x[:, 0].float() * p["D"]
    y = y[:, None].to(u.dtype) * F.silu(z)
    return split_product(y, p["out_proj"], tp, tp_exit), conv_state, h

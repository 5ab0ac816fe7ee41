"""Griffin/RecurrentGemma recurrent block: causal conv + RG-LRU, gated.

Port of `repro.models.rglru`.  RG-LRU (arXiv:2402.19427):
    r_t = sigmoid(W_a x_t)                       (recurrence gate)
    i_t = sigmoid(W_x x_t)                       (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)       (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
The gates are plain torch in float32.  Prefill runs the length-S
recurrence through `kernels.rglru_scan` (the hand-written Hopper kernel
on the card) with h0 passed in, where the JAX package folds h0 into
``bx[:, 0]`` and runs `lax.associative_scan` (rglru.py:58-66): the same
function.  Decode is one plain step.  The full block is
    y = W_out( gelu(W_y x) * RG-LRU(conv1d(W_x' x)) ).

With `tp` (the block split over `model` where `lru_width` divides,
`models.sharding.computes_tp`), as GSPMD partitions the JAX block under
its rules, a rank computes its own block of the Dl channels: the input
enters through `tp_enter`, ``w_y`` and ``w_x`` give the rank's columns,
the conv and ``lambda`` are its channels; the gates' products ``x_r @
w_a[rows r]`` and ``x_r @ w_i[rows r]`` are partial sums over `model`,
reduce-scattered in one call on both to the rank's channels
(`tp_scatter`); the scan runs on those channels (on the card the kernel
and its backward kernel), and ``w_out``'s rows give a partial output,
summed by `tp_exit`, each partial product taken and summed in float32
(`split_product`).  Decode does the same with the rank's block of the
conv state (B, 3, Dl / tp) and of the LRU state (B, Dl / tp).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.models.layers import (
    act_fn,
    apply_causal_conv,
    dense_init,
    init_causal_conv,
    storage_dtype,
)
from repro_torch.models.parallel import (ParallelContext, split_product,
                                        tp_enter, tp_exit, tp_scatter)

_C = 8.0
CONV_KERNEL = 4


def init_rglru_block(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    D, Dl = cfg.d_model, cfg.lru_width_
    dt = storage_dtype(cfg, "w_y")
    # Lambda init so that a^c in [0.9, 0.999] (paper appendix)
    lo, hi = 0.9**2, 0.999**2
    u = lo + (hi - lo) * torch.rand((Dl,), generator=gen, device=gen.device,
                                    dtype=torch.float32)
    lam = torch.log(torch.expm1(-torch.log(u) / (2 * _C)))  # softplus^-1
    return {
        "w_y": dense_init(gen, D, Dl, dt),
        "w_x": dense_init(gen, D, Dl, dt),
        "conv": init_causal_conv(gen, Dl, CONV_KERNEL, dt),
        "w_a": dense_init(gen, Dl, Dl, dt),
        "w_i": dense_init(gen, Dl, Dl, dt),
        "lambda": lam,
        "w_out": dense_init(gen, Dl, D, dt),
    }


def _gates(p, x: torch.Tensor, tp: Optional[ParallelContext] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, bx) of the recurrence, float32, from the conv output x; with
    `tp`, x and the gates the rank's channels, the gates' partial
    products reduce-scattered over `model` in float32."""
    if tp is None:
        ga = (x @ p["w_a"].to(x.dtype)).float()
        gi = (x @ p["w_i"].to(x.dtype)).float()
    else:   # both partial products in f32, one reduce-scatter
        x32 = x.float()
        ga, gi = tp_scatter(torch.stack([x32 @ p["w_a"].float(),
                                         x32 @ p["w_i"].float()], -2),
                            tp, -1).unbind(-2)
    r = torch.sigmoid(ga)
    i = torch.sigmoid(gi)
    log_a = -_C * F.softplus(p["lambda"]) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * (i * x.float())


def rglru_block_mix(p, u: torch.Tensor, cfg: ModelConfig,
                    return_state: bool = False,
                    tp: Optional[ParallelContext] = None):
    """Full-sequence recurrent block (train, prefill).  u: (B, S, D).

    With return_state=True also returns (conv_state (B, 3, Dl), the last
    conv inputs right-aligned, zeros first for a prompt shorter than 3
    (ROADMAP.md Queue 3, R3); lru_state (B, Dl) f32).  With `tp`, `p`
    holds the rank's channels (the module's docstring) and the states
    are its channels' (Dl / tp)."""
    gelu = act_fn("gelu")
    u = tp_enter(u, tp)
    y_branch = gelu(u @ p["w_y"].to(u.dtype))
    x_pre = u @ p["w_x"].to(u.dtype)
    x, conv_state = apply_causal_conv(p["conv"], x_pre)
    a, bx = _gates(p, x, tp)
    h0 = torch.zeros((u.shape[0], x.shape[-1]), dtype=torch.float32,
                     device=u.device)
    hs = rglru_scan(a, bx, h0)
    out = split_product(hs.to(u.dtype) * y_branch, p["w_out"], tp, tp_exit)
    if return_state:
        return out, conv_state, hs[:, -1]
    return out


def rglru_block_decode(
    p,
    u: torch.Tensor,            # (B, 1, D)
    cfg: ModelConfig,
    conv_state: torch.Tensor,   # (B, K-1, Dl)
    lru_state: torch.Tensor,    # (B, Dl)
    tp: Optional[ParallelContext] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step.  Returns (y, the new conv state, the new lru state);
    the states passed in are not written.  With `tp`, `p` and both
    states are the rank's channels'."""
    gelu = act_fn("gelu")
    u = tp_enter(u, tp)
    y_branch = gelu(u @ p["w_y"].to(u.dtype))
    x = u @ p["w_x"].to(u.dtype)
    x, conv_state = apply_causal_conv(p["conv"], x, conv_state)
    a, bx = _gates(p, x, tp)
    h = a[:, 0] * lru_state + bx[:, 0]
    out = h[:, None].to(u.dtype) * y_branch
    return split_product(out, p["w_out"], tp, tp_exit), conv_state, h


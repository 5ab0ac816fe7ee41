"""Plain PyTorch version of the Mamba-1 selective-scan kernel.

Port of `repro.kernels.mamba_scan.ref.mamba_scan_ref`, the sequential
recurrence in float32, which also returns the final state ``h_S``: the
state the kernel carries across the sequence and decode continues from
(the JAX model's `mamba_mix` returns it beside ``y``, ssm.py:117-118).
`mamba_scan_bwd_ref` is its explicit backward.  `ops.mamba_scan` runs
the first on CPU tensors, where autograd differentiates it; the CUDA
kernels in ``csrc/mamba_scan.cu`` and ``csrc/mamba_scan_bwd.cu`` are held
against the two on the card.

Both take the forward's chunk states as the kernels do: asked with
``states=True``, `mamba_scan_ref` also returns the state before each
chunk of `STATE_CHUNK` steps, (B, ceil(S / STATE_CHUNK), D, N);
`mamba_scan_bwd_ref` given them rebuilds each chunk's states from its
saved one, and gives the same bits as without them.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

# steps between the forward's saved states (kChunk of csrc/mamba_scan.cu,
# kStep of csrc/mamba_scan_bwd.cu)
STATE_CHUNK = 16


def mamba_scan_ref(
    x: torch.Tensor,    # (B, S, D)  conv+silu'd inputs
    dt: torch.Tensor,   # (B, S, D)  softplus'd step sizes
    Bm: torch.Tensor,   # (B, S, N)
    Cm: torch.Tensor,   # (B, S, N)
    A: torch.Tensor,    # (D, N)     negative
    D: torch.Tensor,    # (D,)
    states: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """h_t = exp(dt_t*A) h_{t-1} + dt_t*B_t*x_t from h_0 = 0;
    y_t = C_t . h_t + D*x_t.  Returns (y (B, S, D), h_S (B, D, N)), both
    float32, and with `states` the state before each chunk of
    `STATE_CHUNK` steps, (B, ceil(S / STATE_CHUNK), D, N) float32."""
    Bsz, S, Dd = x.shape
    N = A.shape[1]
    x32, dt32 = x.float(), dt.float()
    B32, C32, A32 = Bm.float(), Cm.float(), A.float()
    h = torch.zeros((Bsz, Dd, N), dtype=torch.float32, device=x.device)
    ys, kept = [], []
    for t in range(S):
        if t % STATE_CHUNK == 0:
            kept.append(h)
        dA = torch.exp(dt32[:, t, :, None] * A32)                  # (B,D,N)
        dBx = (dt32[:, t] * x32[:, t])[..., None] * B32[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, C32[:, t]))
    y = torch.stack(ys, dim=1) + x32 * D.float()
    if states:
        return y, h, torch.stack(kept, dim=1)
    return y, h


def mamba_scan_bwd_ref(x, dt, Bm, Cm, A, D, dy: torch.Tensor,
                       dhS: Optional[torch.Tensor] = None,
                       states: Optional[torch.Tensor] = None):
    """The explicit backward of `mamba_scan_ref`: the states rebuilt from
    zero, or each chunk's from the forward's chunk `states` where given
    (the same bits), then the state's gradient g walked from the end from
    dhS (zero when None), g_t = exp(dt_{t+1} A) g_{t+1} + C_t dy_t; from g
    and the states h_t (h_{-1} = 0),
        dx = dy D + dt sum_n g B,   ddt = sum_n g (A exp(dt A) h_{t-1} + x B),
        dB_t = sum_d g dt x,   dC_t = sum_d dy h_t,
        dA = sum_{b,t} g dt exp(dt A) h_{t-1},   dD = sum_{b,t} dy x.
    Returns (dx in x's dtype, ddt, dBm, dCm in their inputs' dtypes, dA,
    dD float32), what the CUDA kernel in ``csrc/mamba_scan_bwd.cu``
    computes."""
    Bsz, S, Dd = x.shape
    x32, dt32, dy32 = x.float(), dt.float(), dy.float()
    B32, C32, A32 = Bm.float(), Cm.float(), A.float()
    h = torch.zeros((Bsz, Dd, A.shape[1]), dtype=torch.float32,
                    device=x.device)
    if states is not None and states.shape != (
            Bsz, -(-S // STATE_CHUNK), Dd, A.shape[1]):
        raise ValueError(f"states {tuple(states.shape)} do not fit x "
                         f"{tuple(x.shape)} and A {tuple(A.shape)}")
    prevs, hs, es = [], [], []   # h_{t-1}, h_t, exp(dt_t A)
    for t in range(S):
        if states is not None and t % STATE_CHUNK == 0:
            h = states[:, t // STATE_CHUNK].float()
        prevs.append(h)
        e = torch.exp(dt32[:, t, :, None] * A32)
        h = e * h + (dt32[:, t] * x32[:, t])[..., None] * B32[:, t, None, :]
        hs.append(h)
        es.append(e)
    g = torch.zeros_like(h) if dhS is None else dhS.float()
    dA = torch.zeros_like(A32)
    dx, ddt, dB, dC = [], [], [], []
    for t in range(S - 1, -1, -1):
        g = g + C32[:, t, None, :] * dy32[:, t, :, None]
        prev = prevs[t]
        dx.append(dt32[:, t] * (g * B32[:, t, None, :]).sum(-1))
        ddt.append((g * (A32 * es[t] * prev + x32[:, t, :, None]
                         * B32[:, t, None, :])).sum(-1))
        dB.append(torch.einsum("bdn,bd->bn", g, dt32[:, t] * x32[:, t]))
        dC.append(torch.einsum("bdn,bd->bn", hs[t], dy32[:, t]))
        dA = dA + (g * dt32[:, t, :, None] * es[t] * prev).sum(0)
        g = es[t] * g
    flip = lambda parts: torch.stack(parts[::-1], dim=1)  # noqa: E731
    return ((flip(dx) + dy32 * D.float()).to(x.dtype), flip(ddt).to(dt.dtype),
            flip(dB).to(Bm.dtype), flip(dC).to(Cm.dtype), dA,
            (dy32 * x32).sum((0, 1)))

"""Plain PyTorch version of the Mamba-1 selective-scan kernel.

Port of `repro.kernels.mamba_scan.ref.mamba_scan_ref`, the sequential
recurrence in float32, which also returns the final state ``h_S``: the
state the kernel carries across the sequence and decode continues from
(the JAX model's `mamba_mix` returns it beside ``y``, ssm.py:117-118).
`ops.mamba_scan` runs it on CPU tensors; the CUDA kernel in
``csrc/mamba_scan.cu`` is held against it on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch


def mamba_scan_ref(
    x: torch.Tensor,    # (B, S, D)  conv+silu'd inputs
    dt: torch.Tensor,   # (B, S, D)  softplus'd step sizes
    Bm: torch.Tensor,   # (B, S, N)
    Cm: torch.Tensor,   # (B, S, N)
    A: torch.Tensor,    # (D, N)     negative
    D: torch.Tensor,    # (D,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = exp(dt_t*A) h_{t-1} + dt_t*B_t*x_t from h_0 = 0;
    y_t = C_t . h_t + D*x_t.  Returns (y (B, S, D), h_S (B, D, N)), both
    float32."""
    Bsz, S, Dd = x.shape
    N = A.shape[1]
    x32, dt32 = x.float(), dt.float()
    B32, C32, A32 = Bm.float(), Cm.float(), A.float()
    h = torch.zeros((Bsz, Dd, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        dA = torch.exp(dt32[:, t, :, None] * A32)                  # (B,D,N)
        dBx = (dt32[:, t] * x32[:, t])[..., None] * B32[:, t, None, :]
        h = dA * h + dBx
        ys.append(torch.einsum("bdn,bn->bd", h, C32[:, t]))
    y = torch.stack(ys, dim=1)
    return y + x32 * D.float(), h

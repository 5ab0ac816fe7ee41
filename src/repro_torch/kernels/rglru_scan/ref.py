"""Plain PyTorch version of the RG-LRU diagonal-recurrence kernel.

Port of `repro.kernels.rglru_scan.ref.rglru_scan_ref`: the sequential
recurrence in float32, and `rglru_scan_bwd_ref`, its explicit backward.
`ops.rglru_scan` runs the first on CPU tensors, where autograd
differentiates it; the CUDA kernels in ``csrc/rglru_scan.cu`` and
``csrc/rglru_scan_bwd.cu`` are held against the two on the card.
"""
from __future__ import annotations

import torch


def rglru_scan_ref(a: torch.Tensor, bx: torch.Tensor,
                   h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + bx_t.  a, bx: (B, S, D); h0: (B, D).
    Returns the full state sequence (B, S, D) float32."""
    h = h0.float()
    a32, b32 = a.float(), bx.float()
    out = []
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        out.append(h)
    return torch.stack(out, dim=1)


def rglru_scan_bwd_ref(a: torch.Tensor, hs: torch.Tensor, h0: torch.Tensor,
                       dhs: torch.Tensor):
    """The explicit backward of `rglru_scan_ref`: from the gradients dhs
    of every state, g_t = dhs_t + a_{t+1} g_{t+1} walked from the end;
    da_t = g_t h_{t-1} (h0 at t = 0), dbx_t = g_t, dh0 = a_0 g_0.  hs is
    the forward's output.  Returns (da, dbx) in a's dtype and dh0 float32,
    what the CUDA kernel in ``csrc/rglru_scan_bwd.cu`` computes."""
    a32, h32, g32 = a.float(), hs.float(), dhs.float()
    prev = torch.cat([h0.float()[:, None], h32[:, :-1]], dim=1)
    q = torch.zeros_like(h0, dtype=torch.float32)
    gs = []
    for t in range(a.shape[1] - 1, -1, -1):
        g = g32[:, t] + q
        gs.append(g)
        q = a32[:, t] * g
    g = torch.stack(gs[::-1], dim=1)
    return (g * prev).to(a.dtype), g.to(a.dtype), q

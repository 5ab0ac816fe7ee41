"""Plain PyTorch version of the RG-LRU diagonal-recurrence kernel.

Port of `repro.kernels.rglru_scan.ref.rglru_scan_ref`: the sequential
recurrence in float32.  `ops.rglru_scan` runs it on CPU tensors; the
CUDA kernel in ``csrc/rglru_scan.cu`` is held against it on the card.
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

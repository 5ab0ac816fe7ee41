"""Public entry of the RG-LRU scan kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels import forward_only, pick
from repro_torch.kernels.rglru_scan.kernel import rglru_scan_fwd
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref


def rglru_scan(
    a: torch.Tensor,    # (B, S, D) decay gates in (0, 1)
    bx: torch.Tensor,   # (B, S, D) gated inputs
    h0: torch.Tensor,   # (B, D)
) -> torch.Tensor:
    """Every state h_t of h_t = a_t * h_{t-1} + bx_t from h0, (B, S, D)
    float32.

    CUDA tensors launch the Hopper kernel (`kernel.rglru_scan_fwd`,
    which counts the launch and walks any S and D, so no block sizes are
    picked here; it has no backward kernel, so it raises where autograd
    records, `forward_only`); CPU tensors run `ref.rglru_scan_ref`, which
    autograd differentiates."""
    kernel = forward_only("rglru_scan", rglru_scan_fwd)
    return pick(a, kernel, rglru_scan_ref)(a, bx, h0)

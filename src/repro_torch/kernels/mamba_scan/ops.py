"""Public entry of the selective-scan kernel."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import forward_only, pick
from repro_torch.kernels.mamba_scan.kernel import mamba_scan_fwd
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref


def mamba_scan(
    x: torch.Tensor,    # (B, S, D)
    dt: torch.Tensor,   # (B, S, D)
    Bm: torch.Tensor,   # (B, S, N)
    Cm: torch.Tensor,   # (B, S, N)
    A: torch.Tensor,    # (D, N)
    D: torch.Tensor,    # (D,)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 selective scan from a zero state; returns (y (B, S, D),
    h_S (B, D, N)), both float32.

    CUDA tensors launch the Hopper kernel (`kernel.mamba_scan_fwd`,
    which counts the launch; it has no backward kernel, so it raises where
    autograd records, `forward_only`); CPU tensors run
    `ref.mamba_scan_ref`, which autograd differentiates.  The JAX op picks
    block sizes that divide S and D; the kernel masks ragged edges itself,
    so none are picked here."""
    kernel = forward_only("mamba_scan", mamba_scan_fwd)
    return pick(x, kernel, mamba_scan_ref)(x, dt, Bm, Cm, A, D)

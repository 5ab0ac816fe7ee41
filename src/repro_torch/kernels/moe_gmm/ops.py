"""Public entry of the grouped expert-FFN kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels import forward_only, pick
from repro_torch.kernels.moe_gmm.kernel import moe_gmm_fwd
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref


def moe_gmm(
    h: torch.Tensor,   # (E, C, D)
    wg: torch.Tensor,  # (E, D, F)
    wu: torch.Tensor,
    wd: torch.Tensor,  # (E, F, D)
) -> torch.Tensor:
    """``silu(h @ wg) * (h @ wu) @ wd`` per expert, f32 inside, in h's
    dtype.

    CUDA tensors launch the Hopper kernel (`kernel.moe_gmm_fwd`, which
    counts the launch; it has no backward kernel, so it raises where
    autograd records, `forward_only`); CPU tensors run `ref.moe_gmm_ref`,
    which autograd differentiates."""
    kernel = forward_only("moe_gmm", moe_gmm_fwd)
    return pick(h, kernel, moe_gmm_ref)(h, wg, wu, wd)

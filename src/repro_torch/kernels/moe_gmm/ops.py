"""Public entry of the grouped expert-FFN kernel, differentiable on the
card."""
from __future__ import annotations

import torch

from repro_torch.kernels import pick, records
from repro_torch.kernels.moe_gmm.kernel import moe_gmm_bwd, moe_gmm_fwd
from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref


class MoeGmmFn(torch.autograd.Function):
    """`fwd` as one differentiable function of (h, wg, wu, wd) with `bwd`
    as its backward: on the card the kernels, `moe_gmm_fwd` and
    `moe_gmm_bwd`.  The forward saves its four inputs; the backward
    recomputes the activation from them."""

    @staticmethod
    def forward(ctx, h, wg, wu, wd, fwd, bwd):
        ctx.save_for_backward(h, wg, wu, wd)
        ctx.bwd = bwd
        return fwd(h, wg, wu, wd)

    @staticmethod
    def backward(ctx, dout):
        return (*ctx.bwd(*ctx.saved_tensors, dout.contiguous()), None, None)


def _on_card(h, wg, wu, wd):
    if records(h, wg, wu, wd):
        return MoeGmmFn.apply(h, wg, wu, wd, moe_gmm_fwd, moe_gmm_bwd)
    return moe_gmm_fwd(h, wg, wu, wd)


def moe_gmm(
    h: torch.Tensor,   # (E, C, D)
    wg: torch.Tensor,  # (E, D, F)
    wu: torch.Tensor,
    wd: torch.Tensor,  # (E, F, D)
) -> torch.Tensor:
    """``silu(h @ wg) * (h @ wu) @ wd`` per expert, f32 inside, in h's
    dtype.

    CUDA tensors launch the Hopper kernel (`kernel.moe_gmm_fwd`, which
    counts the launch); when autograd records, through `MoeGmmFn`, whose
    backward is the backward kernel.  CPU tensors run `ref.moe_gmm_ref`,
    which autograd differentiates."""
    return pick(h, _on_card, moe_gmm_ref)(h, wg, wu, wd)

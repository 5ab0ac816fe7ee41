"""Public entry of the grouped expert-FFN kernel, differentiable on the
card."""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import pick, records
from repro_torch.kernels.moe_gmm.kernel import moe_gmm_bwd, moe_gmm_fwd
from repro_torch.kernels.moe_gmm.ref import check_act, moe_gmm_ref


class MoeGmmFn(torch.autograd.Function):
    """`fwd` as one differentiable function of (h, wg, wu, wd) with `bwd`
    as its backward: on the card the kernels, `moe_gmm_fwd` and
    `moe_gmm_bwd`, both bound to the gate's activation.  The forward
    saves its four inputs; the backward recomputes the activation from
    them."""

    @staticmethod
    def forward(ctx, h, wg, wu, wd, fwd, bwd):
        ctx.save_for_backward(h, wg, wu, wd)
        ctx.bwd = bwd
        return fwd(h, wg, wu, wd)

    @staticmethod
    def backward(ctx, dout):
        return (*ctx.bwd(*ctx.saved_tensors, dout.contiguous()), None, None)


def _on_card(h, wg, wu, wd, act):
    if records(h, wg, wu, wd):
        return MoeGmmFn.apply(h, wg, wu, wd,
                              functools.partial(moe_gmm_fwd, act=act),
                              functools.partial(moe_gmm_bwd, act=act))
    return moe_gmm_fwd(h, wg, wu, wd, act)


def moe_gmm(
    h: torch.Tensor,   # (E, C, D)
    wg: torch.Tensor,  # (E, D, F)
    wu: torch.Tensor,
    wd: torch.Tensor,  # (E, F, D)
    act: str = "silu",
) -> torch.Tensor:
    """``act(h @ wg) * (h @ wu) @ wd`` per expert, f32 inside, in h's
    dtype; `act` one of ``ref.ACTS`` (silu, gelu in its tanh form, relu),
    any other name raises.

    CUDA tensors launch the Hopper kernel (`kernel.moe_gmm_fwd`, which
    counts the launch); when autograd records, through `MoeGmmFn`, whose
    backward is the backward kernel.  CPU tensors run `ref.moe_gmm_ref`,
    which autograd differentiates."""
    check_act(act)
    return pick(h, _on_card, moe_gmm_ref)(h, wg, wu, wd, act)

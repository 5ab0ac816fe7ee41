"""Public entry of the selective-scan kernel, differentiable on the card."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import pick, records
from repro_torch.kernels.mamba_scan.kernel import (
    mamba_scan_bwd,
    mamba_scan_fwd,
)
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref


class MambaScanFn(torch.autograd.Function):
    """`fwd` as one differentiable function of (x, dt, Bm, Cm, A, D) with
    `bwd` as its backward: on the card the kernels, `mamba_scan_fwd` and
    `mamba_scan_bwd`.  The forward is asked for its chunk states (the state
    before every `ref.STATE_CHUNK` steps) and saves them beside its six
    inputs; the backward rebuilds each chunk's states from them and takes
    the gradients of both outputs, y and h_S (h_S's None when it is
    unused)."""

    @staticmethod
    def forward(ctx, x, dt, Bm, Cm, A, D, fwd, bwd):
        y, h, states = fwd(x, dt, Bm, Cm, A, D, True)
        ctx.save_for_backward(x, dt, Bm, Cm, A, D, states)
        ctx.bwd = bwd
        ctx.set_materialize_grads(False)   # an unused h_S's gradient: None
        return y, h

    @staticmethod
    def backward(ctx, dy, dhS):
        *inputs, states = ctx.saved_tensors
        dy = torch.zeros_like(inputs[0], dtype=torch.float32) \
            if dy is None else dy.contiguous()
        dhS = None if dhS is None else dhS.contiguous()
        grads = ctx.bwd(*inputs, dy, dhS, states)
        return (*grads, None, None)


def _on_card(x, dt, Bm, Cm, A, D):
    args = (x, dt, Bm, Cm, A, D)
    if records(*args):
        return MambaScanFn.apply(*args, mamba_scan_fwd, mamba_scan_bwd)
    return mamba_scan_fwd(*args)


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
    which counts the launch); when autograd records, through
    `MambaScanFn`, whose forward also keeps the chunk states and whose
    backward is the backward kernel; a serving call keeps none.  CPU tensors run
    `ref.mamba_scan_ref`, which autograd differentiates.  The JAX op picks
    block sizes that divide S and D; the kernels mask ragged edges
    themselves, so none are picked here."""
    return pick(x, _on_card, mamba_scan_ref)(x, dt, Bm, Cm, A, D)

"""Public entry of the RG-LRU scan kernel, differentiable on the card."""
from __future__ import annotations

import torch

from repro_torch.kernels import pick, records
from repro_torch.kernels.rglru_scan.kernel import (
    rglru_scan_bwd,
    rglru_scan_fwd,
)
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref


class RglruScanFn(torch.autograd.Function):
    """`fwd` as one differentiable function of (a, bx, h0) with `bwd` as
    its backward: on the card the kernels, `rglru_scan_fwd` and
    `rglru_scan_bwd`.  The forward saves a, h0 and its own output, every
    state; the backward walks them from the end."""

    @staticmethod
    def forward(ctx, a, bx, h0, fwd, bwd):
        hs = fwd(a, bx, h0)
        ctx.save_for_backward(a, h0, hs)
        ctx.bwd = bwd
        return hs

    @staticmethod
    def backward(ctx, dhs):
        a, h0, hs = ctx.saved_tensors
        da, dbx, dh0 = ctx.bwd(a, hs, h0, dhs.contiguous())
        return da, dbx, dh0, None, None


def _on_card(a, bx, h0):
    if records(a, bx, h0):
        return RglruScanFn.apply(a, bx, h0, rglru_scan_fwd, rglru_scan_bwd)
    return rglru_scan_fwd(a, bx, h0)


def rglru_scan(
    a: torch.Tensor,    # (B, S, D) decay gates in (0, 1)
    bx: torch.Tensor,   # (B, S, D) gated inputs
    h0: torch.Tensor,   # (B, D)
) -> torch.Tensor:
    """Every state h_t of h_t = a_t * h_{t-1} + bx_t from h0, (B, S, D)
    float32.

    CUDA tensors launch the Hopper kernel (`kernel.rglru_scan_fwd`,
    which counts the launch and walks any S and D, so no block sizes are
    picked here); when autograd records, through `RglruScanFn`, whose
    backward is the backward kernel.  CPU tensors run
    `ref.rglru_scan_ref`, which autograd differentiates."""
    return pick(a, _on_card, rglru_scan_ref)(a, bx, h0)

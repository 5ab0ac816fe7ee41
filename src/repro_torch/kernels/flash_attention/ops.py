"""Public entry of the flash attention kernel, differentiable on the card."""
from __future__ import annotations

import torch

from repro_torch.kernels import pick, records
from repro_torch.kernels.flash_attention.kernel import (
    bwd_head_dim,
    flash_attention_bwd,
    flash_attention_fwd,
)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


class FlashAttentionFn(torch.autograd.Function):
    """The kernels as one differentiable function of folded q, k, v
    (BH, S, hd): the forward launches `flash_attention_fwd` with its lse
    and saves q, k, v, o and lse; the backward launches
    `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, group: int, causal: bool, window: int):
        bwd_head_dim(q.shape[-1])   # raises before the forward runs
        o, lse = flash_attention_fwd(q, k, v, group, causal, window,
                                     return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = (group, causal, window)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do.contiguous(), lse,
                                         *ctx.args)
        return dq, dk, dv, None, None, None


def _on_card(q, k, v, causal, window):
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    # heads folded into rows; transposed projections are copied here
    args = (q.reshape(B * Hq, Sq, hd).contiguous(),
            k.reshape(B * Hkv, Sk, hd).contiguous(),
            v.reshape(B * Hkv, Sk, hd).contiguous(), Hq // Hkv, causal, window)
    if records(q, k, v):
        o = FlashAttentionFn.apply(*args)
    else:
        o = flash_attention_fwd(*args)
    return o.reshape(B, Hq, Sq, hd)


def flash_attention(
    q: torch.Tensor,   # (B, Hq, Sq, hd)
    k: torch.Tensor,   # (B, Hkv, Sk, hd)
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    """GQA attention with right-aligned query positions; (B, Hq, Sq, hd)
    in q's dtype.

    CUDA tensors launch the Hopper kernel (`kernel.flash_attention_fwd`,
    which counts the launch and masks ragged lengths itself, so no block
    sizes are picked here); when autograd records (an input requires grad
    and grad mode is on) through `FlashAttentionFn`, whose backward is the
    backward kernel.  CPU tensors run `ref.flash_attention_ref`, which
    autograd differentiates."""
    return pick(q, _on_card, flash_attention_ref)(q, k, v, causal, window)

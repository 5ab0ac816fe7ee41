"""Public entry of the flash attention kernel."""
from __future__ import annotations

import torch

from repro_torch.kernels import pick
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def _on_card(q, k, v, causal, window):
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    # heads folded into rows; transposed projections are copied here
    o = flash_attention_fwd(
        q.reshape(B * Hq, Sq, hd).contiguous(),
        k.reshape(B * Hkv, Sk, hd).contiguous(),
        v.reshape(B * Hkv, Sk, hd).contiguous(), Hq // Hkv, causal, window)
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
    sizes are picked here); CPU tensors run `ref.flash_attention_ref`."""
    return pick(q, _on_card, flash_attention_ref)(q, k, v, causal, window)

"""Plain PyTorch version of the flash attention kernel (GQA, causal, window).

Port of `repro.kernels.flash_attention.ref.flash_attention_ref`: the
whole ``(Sq, Sk)`` score matrix in float32, masked with the finite
``-1e30`` (so a row that is masked everywhere gives the mean of V, as
the reference does), softmax, then ``P @ V``, rounded once to q's
dtype.  `ops.flash_attention` runs it on CPU tensors; the CUDA kernel in
``csrc/flash_attention.cu`` is held against it on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def attention_mask(sq: int, sk: int, causal: bool, window: int,
                   device=None) -> torch.Tensor:
    """(Sq, Sk) bool, True where query i may attend key j; query
    positions are right-aligned (``i + Sk - Sq``)."""
    qpos = torch.arange(sq, device=device) + (sk - sq)
    kpos = torch.arange(sk, device=device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window > 0:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    return mask


def flash_attention_ref(
    q: torch.Tensor,   # (B, Hq, Sq, hd)
    k: torch.Tensor,   # (B, Hkv, Sk, hd)
    v: torch.Tensor,
    causal: bool = True,
    window: int = 0,
) -> torch.Tensor:
    B, Hq, Sq, hd = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Sq, hd).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * hd**-0.5
    mask = attention_mask(Sq, Sk, causal, window, device=q.device)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, Hq, Sq, hd).to(q.dtype)

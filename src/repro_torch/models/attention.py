"""Attention: GQA with RoPE and QK-norm, prefill through the flash
attention kernel (causal, bidirectional, or within a sliding window),
decode against a KV cache or a ring-buffer window cache, and
cross-attention over encoder states or image embeddings.

Port of `repro.models.attention`.  Self-attention always applies RoPE
(no caller of the JAX package turns it off); it is causal, full or
windowed (the local attention of recurrentgemma), or bidirectional (the
encoder of seamless-m4t).  Where the JAX package runs
`chunked_attention` (attention.py:248), or `block_local_attention` for
a window shorter than the sequence (:245-246), the port calls
`kernels.flash_attention` with the window, the same function (mask
``0 <= q - k < window``), which on the card is the hand-written Hopper
kernel.  `block_local_attention` is kept as a plain function beside it
and tested against both.  Cross-attention (attention.py:296-317) has no
RoPE and no mask: its prefill goes through the same kernel, non-causal,
over K/V projected once from the source (`project_cross_kv`).  Decode
attention (one query against a cache, self or cross) stays plain torch:
no TPU kernel computes it in the JAX package.  A cross cache may be
longer than its source (a serving slot sized for the longest); decode
masks it at the source's length (`cross_attention_decode`), where the
JAX package attends over the zero padding too (ROADMAP.md Queue 3, R4).
Trained on a mesh whose `model` axis divides both head counts, a layer
computes this rank's heads alone (`models.sharding.computes_tp`): the
projections, the QKV bias, the q/k norms, RoPE and the kernel on them,
and the output projection's partial sum added over `model`.

Served on a mesh, decode follows its cache's cut over `model`
(`models.sharding.kv_split`).  Cut by KV heads, a rank projects its
query heads and the KV heads of their groups, writes them into its
block, attends, and adds the output projection's partials over `model`,
as in training.  Cut by positions (a cache of 1,024 positions or more,
flash-decoding style), a rank holds L / tp positions of every KV head:
the step's q, k and v are gathered over `model` (one gather of a few KB,
where the heads split), the rank that holds a row's position writes
it, and each rank attends every head over its positions; the maxima
are combined over `model` (`core.comm.all_reduce_max`), then the sums
of exponentials and the unnormalised outputs (`tp_exit`), as
`models.model._lse_gold` combines a logsumexp.  Its heads' part goes
through its rows of the output projection.  A prefill's K/V come from
the rank's heads and are gathered over `model` where the cache is cut
by positions (`models.kvcache.recut`).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.comm import all_reduce_max
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.kvcache import gather_heads
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    rms_head_norm,
    storage_dtype,
)
from repro_torch.models.parallel import ParallelContext, tp_enter, tp_exit

NEG_INF = -1e30


# ---------------- params ---------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   cross: bool = False) -> Dict:
    """A cross-attention layer has no QK-norm (attention.py:42)."""
    hd = cfg.head_dim_
    dq = cfg.num_heads * hd
    dkv = cfg.num_kv_heads * hd
    dt = storage_dtype(cfg, "wq")
    dev = gen.device
    p = {
        "wq": dense_init(gen, cfg.d_model, dq, dt),
        "wk": dense_init(gen, cfg.d_model, dkv, dt),
        "wv": dense_init(gen, cfg.d_model, dkv, dt),
        "wo": dense_init(gen, dq, cfg.d_model, dt),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((dq,), dtype=dt, device=dev)
        p["bk"] = torch.zeros((dkv,), dtype=dt, device=dev)
        p["bv"] = torch.zeros((dkv,), dtype=dt, device=dev)
    if cfg.qk_norm and not cross:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=dev)
    return p


def _project_q(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The query heads `p["wq"]` holds: every head, or a rank's contiguous
    part of them when the layer is split over `model`."""
    B, S, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(B, S, -1, cfg.head_dim_).transpose(1, 2)
    if "q_norm" in p:
        q = rms_head_norm(p["q_norm"], q)
    return q  # (B, Hq, S, hd)


def _project_kv(p, x: torch.Tensor, cfg: ModelConfig):
    B, S, _ = x.shape
    hd = cfg.head_dim_
    k = x @ p["wk"].to(x.dtype)
    v = x @ p["wv"].to(x.dtype)
    if "bk" in p:
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    k = k.reshape(B, S, -1, hd).transpose(1, 2)
    v = v.reshape(B, S, -1, hd).transpose(1, 2)
    if "k_norm" in p:
        k = rms_head_norm(p["k_norm"], k)
    return k, v  # (B, Hkv, S, hd)


def block_local_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window: int,
) -> torch.Tensor:
    """Sliding-window causal attention in O(S * 2W): each query block of
    size W attends to its own and the previous key block (covers any
    window <= W).  Port of attention.py:149; the model runs
    `kernels.flash_attention` with the window instead, the same function."""
    B, Hq, S, hd = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    W = min(window, S)
    S_in = S
    if S % W:  # pad to a block multiple; padded keys are causally masked
        pad = W - S % W
        q, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (q, k, v))
        S = S + pad
    nb = S // W
    scale = hd**-0.5

    qb = q.reshape(B, Hkv, G, nb, W, hd)
    kb = k.reshape(B, Hkv, nb, W, hd)
    vb = v.reshape(B, Hkv, nb, W, hd)
    # previous block (zeros before block 0)
    kprev = torch.cat([torch.zeros_like(kb[:, :, :1]), kb[:, :, :-1]], dim=2)
    vprev = torch.cat([torch.zeros_like(vb[:, :, :1]), vb[:, :, :-1]], dim=2)
    k2 = torch.cat([kprev, kb], dim=3)  # (B,Hkv,nb,2W,hd)
    v2 = torch.cat([vprev, vb], dim=3)

    s = torch.einsum("bhgnqd,bhnkd->bhgnqk", qb.float(), k2.float()) * scale
    qi = torch.arange(W, device=q.device)
    ki = torch.arange(2 * W, device=q.device) - W  # relative to block start
    rel = qi[:, None] - ki[None, :]  # distance q - k
    mask = (rel >= 0) & (rel < W if window >= S else rel < window)
    # block 0 has no previous block
    blk0 = torch.arange(nb, device=q.device) == 0
    mask_full = mask[None] & ~(blk0[:, None, None] & (ki < 0)[None, None, :])
    s = torch.where(mask_full[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgnqk,bhnkd->bhgnqd", p, v2.float())
    return out.reshape(B, Hq, S, hd)[:, :, :S_in].to(q.dtype)


def _decode_scores(q, k_cache, kv_len, window: int, lo: int = 0):
    """Scores (B, Hkv, G, S) of one query a row against the cache, whose
    entries are positions lo, lo + 1, ...: masked past each row's
    `kv_len` valid entries, and within the last `window` of them."""
    B, Hq, _, hd = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float()) * hd**-0.5
    idx = lo + torch.arange(S, device=q.device)[None, :]
    kv_len = kv_len.reshape(-1, 1)
    valid = idx < kv_len
    if window > 0:
        valid &= idx >= kv_len - window
    return torch.where(valid[:, None, None, :], s, NEG_INF)


def decode_attention(
    q: torch.Tensor,          # (B, Hq, 1, hd)
    k_cache: torch.Tensor,    # (B, Hkv, S, hd)
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,     # (B,): valid cache entries
    window: int = 0,
) -> torch.Tensor:
    B, Hq, _, hd = q.shape
    p = torch.softmax(_decode_scores(q, k_cache, kv_len, window), dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return out.reshape(B, Hq, 1, hd).to(q.dtype)


def decode_attention_split(
    q: torch.Tensor,          # (B, Hq, 1, hd): every head
    k_cache: torch.Tensor,    # (B, Hkv, L / tp, hd): this rank's positions
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,     # (B,): valid entries of the whole cache
    seq: ParallelContext,
    window: int = 0,
) -> torch.Tensor:
    """`decode_attention` over a cache cut by positions over `seq`'s
    model axis, this rank's block from position ``i L / tp`` on: the
    scores' maxima combined over `model` (`core.comm.all_reduce_max`),
    then each rank's sum of exponentials and unnormalised output from
    them added over `model` (one `tp_exit`), and divided."""
    B, Hq, _, hd = q.shape
    lo = seq.mesh.coords[seq.tp_axis] * k_cache.shape[2]
    s = _decode_scores(q, k_cache, kv_len, window, lo)
    top = all_reduce_max(s.amax(-1), seq.mesh, seq.tp_axis)
    p = torch.exp(s - top[..., None])       # 0 where masked
    o = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    both = tp_exit(torch.cat([o, p.sum(-1, keepdim=True)], -1), seq)
    out = both[..., :hd] / both[..., hd:]
    return out.reshape(B, Hq, 1, hd).to(q.dtype)


def _decode_out(p, o: torch.Tensor, x: torch.Tensor,
                tp: Optional[ParallelContext],
                seq: Optional[ParallelContext]) -> torch.Tensor:
    """A decode step's attention output (B, H, 1, hd) through the output
    projection: with `tp`, the rank's heads (its part of every head when
    the cache is cut by positions) through its rows, added over
    `model`."""
    B = x.shape[0]
    if tp is not None and seq is not None:
        n = tp.tp_size
        o = o.reshape(B, n, -1, *o.shape[2:])[:, tp.mesh.coords[tp.tp_axis]]
    return tp_exit(o.reshape(B, 1, -1) @ p["wo"].to(x.dtype), tp)


# ---------------- module-level apply ---------------------------------------


def attention_block(
    p,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,          # (S,)
    window: int = 0,
    causal: bool = True,
    return_kv: bool = False,
    tp: Optional[ParallelContext] = None,
):
    """Self-attention over a full sequence (prefill): causal, within the
    last `window` positions when window > 0, or bidirectional with
    causal=False (an encoder layer).  With `tp`, `p` holds this rank's
    heads (`models.sharding.computes_tp`): `x` enters the split block
    (`models.parallel.tp_enter`), the kernel runs on the rank's query
    heads and the KV heads of their groups, and the output projection's
    partial sums are added over `model` (`tp_exit`).

    With return_kv=True also returns the (roped) K/V actually used — the
    exact tensors a decode cache must contain: for a window no longer
    than the sequence, the trailing `window` entries rolled so that
    position t sits in ring slot t % window (attention.py:253-259)."""
    B, S, _ = x.shape
    x = tp_enter(x, tp)
    q = apply_rope(_project_q(p, x, cfg), positions, cfg.rope_theta)
    k, v = _project_kv(p, x, cfg)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=causal, window=window)
    y = tp_exit(o.transpose(1, 2).reshape(B, S, -1) @ p["wo"].to(x.dtype),
                tp)
    if return_kv:
        if window > 0 and S >= window:
            k, v = k[:, :, -window:], v[:, :, -window:]
            k = torch.roll(k, S % window, dims=2)
            v = torch.roll(v, S % window, dims=2)
        return y, k, v
    return y


def attention_block_decode(
    p,
    x: torch.Tensor,                  # (B, 1, D)
    cfg: ModelConfig,
    pos: torch.Tensor,                # (B,) current position
    k_cache: torch.Tensor,            # (B, Hkv, S, hd), written in place
    v_cache: torch.Tensor,
    window: int = 0,
    tp: Optional[ParallelContext] = None,
    seq: Optional[ParallelContext] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step: write the new K/V into the caches (in place,
    where the JAX package returns updated copies), attend over them.  A
    cache exactly `window` long is a ring: position t goes to slot
    t % window (attention.py:281-283).  Returns (y, k_cache, v_cache).
    With `tp`, `p` holds this rank's heads (`attention_block`); with
    `seq`, the caches are this rank's positions of every KV head, slot t
    on rank t // (S / tp) of the whole cache's S (the module's
    docstring)."""
    B = x.shape[0]
    x = tp_enter(x, tp)
    q = apply_rope(_project_q(p, x, cfg), pos[:, None], cfg.rope_theta)
    k, v = _project_kv(p, x, cfg)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    if tp is not None and seq is not None:
        q, k, v = gather_heads((q, k, v), tp)
    n = k_cache.shape[2]
    S = n * (seq.tp_size if seq is not None else 1)
    ring = window > 0 and S == window
    slot = pos % window if ring else torch.clamp(pos, max=S - 1)
    bidx = torch.arange(B, device=x.device)
    if seq is None:
        k_cache[bidx, :, slot] = k[:, :, 0].to(k_cache.dtype)
        v_cache[bidx, :, slot] = v[:, :, 0].to(v_cache.dtype)
    else:   # the row's slot on the rank that holds it, the others as they are
        local = slot - seq.mesh.coords[seq.tp_axis] * n
        mine = ((local >= 0) & (local < n))[:, None, None]
        at = local.clamp(0, n - 1)
        for cache, new in ((k_cache, k), (v_cache, v)):
            cache[bidx, :, at] = torch.where(
                mine, new[:, :, 0].to(cache.dtype), cache[bidx, :, at])
    kv_len = torch.clamp(pos + 1, max=S)
    window = 0 if ring else window
    if seq is None:
        o = decode_attention(q, k_cache, v_cache, kv_len, window=window)
    else:
        o = decode_attention_split(q, k_cache, v_cache, kv_len, seq, window)
    return _decode_out(p, o, x, tp, seq), k_cache, v_cache


def project_cross_kv(p, src: torch.Tensor, cfg: ModelConfig,
                     tp: Optional[ParallelContext] = None):
    """Cross-attention K/V (B, Hkv, Sx, hd) from encoder states or image
    embeddings (B, Sx, D), computed once a prefill (attention.py:313);
    with `tp`, the KV heads of this rank's part (`attention_block`)."""
    return _project_kv(p, tp_enter(src, tp), cfg)


def cross_attention_block(
    p,
    x: torch.Tensor,                  # (B, S, D)
    cfg: ModelConfig,
    cross_k: torch.Tensor,            # (B, Hkv, Sx, hd)
    cross_v: torch.Tensor,
    tp: Optional[ParallelContext] = None,
) -> torch.Tensor:
    """Every query attends every source position: no RoPE, no mask
    (attention.py:296-310), through the flash kernel; with `tp`, this
    rank's heads, their partial outputs added over `model`
    (`attention_block`)."""
    B, S, _ = x.shape
    o = flash_attention(_project_q(p, tp_enter(x, tp), cfg), cross_k,
                        cross_v, causal=False)
    return tp_exit(o.transpose(1, 2).reshape(B, S, -1) @ p["wo"].to(x.dtype),
                   tp)


def cross_attention_decode(
    p,
    x: torch.Tensor,                  # (B, 1, D)
    cfg: ModelConfig,
    cross_k: torch.Tensor,            # (B, Hkv, Lx, hd)
    cross_v: torch.Tensor,
    src_len: torch.Tensor,            # (B,): valid source positions
    tp: Optional[ParallelContext] = None,
    seq: Optional[ParallelContext] = None,
) -> torch.Tensor:
    """One decode step's cross-attention over the cache, masked past each
    row's source length (the JAX package attends all Lx: R4); `tp` and
    `seq` as `attention_block_decode`'s."""
    x = tp_enter(x, tp)
    q = _project_q(p, x, cfg)
    if seq is None:
        o = decode_attention(q, cross_k, cross_v, src_len)
    else:
        if tp is not None:
            q, = gather_heads((q,), tp)
        o = decode_attention_split(q, cross_k, cross_v, src_len, seq)
    return _decode_out(p, o, x, tp, seq)

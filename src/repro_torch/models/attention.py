"""Attention: GQA with RoPE and QK-norm, prefill through the flash
attention kernel, and decode against a KV cache.

Port of `repro.models.attention` for causal full (global)
self-attention with RoPE, the attention of the ported architectures.
Where the JAX package runs `chunked_attention` (attention.py:248), the
port calls `kernels.flash_attention` — the same function, which on the
card is the hand-written Hopper kernel.  Decode attention
(one query against the cache) stays plain torch: no TPU kernel computes
it in the JAX package.  Sliding windows
(`block_local_attention`, ring-buffer caches), attention without RoPE
and cross-attention wait for the slices whose models use them
(ROADMAP.md Queue 1); the flash kernel already takes a window.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.layers import (
    apply_rope,
    dense_init,
    rms_head_norm,
    storage_dtype,
)

NEG_INF = -1e30


# ---------------- params ---------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig) -> Dict:
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
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((hd,), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.ones((hd,), dtype=torch.float32, device=dev)
    return p


def _project_q(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    B, S, _ = x.shape
    q = x @ p["wq"].to(x.dtype)
    if "bq" in p:
        q = q + p["bq"].to(x.dtype)
    q = q.reshape(B, S, cfg.num_heads, cfg.head_dim_).transpose(1, 2)
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
    k = k.reshape(B, S, cfg.num_kv_heads, hd).transpose(1, 2)
    v = v.reshape(B, S, cfg.num_kv_heads, hd).transpose(1, 2)
    if "k_norm" in p:
        k = rms_head_norm(p["k_norm"], k)
    return k, v  # (B, Hkv, S, hd)


def decode_attention(
    q: torch.Tensor,          # (B, Hq, 1, hd)
    k_cache: torch.Tensor,    # (B, Hkv, S, hd)
    v_cache: torch.Tensor,
    kv_len: torch.Tensor,     # (B,): valid cache entries
) -> torch.Tensor:
    B, Hq, _, hd = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k_cache.float()) * hd**-0.5
    valid = torch.arange(S, device=q.device)[None, :] < kv_len.reshape(-1, 1)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v_cache.float())
    return out.reshape(B, Hq, 1, hd).to(q.dtype)


# ---------------- module-level apply ---------------------------------------


def attention_block(
    p,
    x: torch.Tensor,
    cfg: ModelConfig,
    positions: torch.Tensor,          # (S,)
    return_kv: bool = False,
):
    """Causal self-attention over a full sequence (prefill).

    With return_kv=True also returns the (roped) K/V actually used — the
    exact tensors a decode cache must contain."""
    B, S, _ = x.shape
    q = apply_rope(_project_q(p, x, cfg), positions, cfg.rope_theta)
    k, v = _project_kv(p, x, cfg)
    k = apply_rope(k, positions, cfg.rope_theta)
    o = flash_attention(q, k, v, causal=True)
    y = o.transpose(1, 2).reshape(B, S, -1) @ p["wo"].to(x.dtype)
    if return_kv:
        return y, k, v
    return y


def attention_block_decode(
    p,
    x: torch.Tensor,                  # (B, 1, D)
    cfg: ModelConfig,
    pos: torch.Tensor,                # (B,) current position
    k_cache: torch.Tensor,            # (B, Hkv, S, hd), written in place
    v_cache: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step: write the new K/V at `pos` into the caches (in
    place, where the JAX package returns updated copies), attend over
    them.  Returns (y, k_cache, v_cache)."""
    q = apply_rope(_project_q(p, x, cfg), pos[:, None], cfg.rope_theta)
    k, v = _project_kv(p, x, cfg)
    k = apply_rope(k, pos[:, None], cfg.rope_theta)
    S = k_cache.shape[2]
    slot = torch.clamp(pos, max=S - 1)
    bidx = torch.arange(x.shape[0], device=x.device)
    k_cache[bidx, :, slot] = k[:, :, 0].to(k_cache.dtype)
    v_cache[bidx, :, slot] = v[:, :, 0].to(v_cache.dtype)
    o = decode_attention(q, k_cache, v_cache, torch.clamp(pos + 1, max=S))
    return o.reshape(x.shape[0], 1, -1) @ p["wo"].to(x.dtype), k_cache, v_cache

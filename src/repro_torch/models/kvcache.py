"""Decode state: KV caches, ring window caches, cross-attention caches,
SSM and LRU states.

Port of `repro.models.kvcache`.  A ``decoder`` layer (encdec) keeps its
self K/V and the cross K/V of the encoder's output, both `L` long as in
the JAX package (kvcache.py:28-35); a ``cross_attn`` layer (vlm) the
cross K/V of `num_image_tokens` image embeddings.  The JAX
package threads a cache pytree through `lax.scan`; the port keeps one
dict per layer, in `StackPlan.kinds` order, each leaf a view of one
zero-filled tensor stacked over the layers of that kind (kinds differ in
leaves and shapes).  Decode writes into those views in place
(`models.attention.attention_block_decode`,
`models.transformer.apply_layer`).

On a mesh each rank holds its block of every leaf
(`models.sharding.cache_slice`), in a `CacheBlocks`, which also tells
how each K/V leaf is cut over `model`: a block alone does not (512
positions may be a whole cache or a quarter of 2,048).  The conv, SSM
and LRU states are the rank's channels where its mixer splits over
`model`, else whole.  `recut` moves a
K/V block from one cut to another (a prefill's heads to a slot's
positions, a short cross source into a longer slot).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.comm import all_gather
from repro_torch.models.layers import torch_dtype
from repro_torch.models.parallel import ParallelContext
from repro_torch.models.sharding import KV_LEAVES, cache_slice, kv_split


def layer_cache_shape(cfg: ModelConfig, kind: str, B: int, L: int) -> Dict:
    hd = cfg.head_dim_
    Hkv = cfg.num_kv_heads
    cd = torch_dtype(cfg.compute_dtype)
    if kind in ("self_attn", "moe", "dense"):
        return {"k": ((B, Hkv, L, hd), cd), "v": ((B, Hkv, L, hd), cd)}
    if kind == "local_attn":
        W = min(cfg.hybrid.local_window, L)
        return {"k": ((B, Hkv, W, hd), cd), "v": ((B, Hkv, W, hd), cd)}
    if kind == "decoder":   # the encoder's length is at most L
        return {name: ((B, Hkv, L, hd), cd) for name in ("k", "v", "ck", "cv")}
    if kind == "cross_attn":
        n = cfg.num_image_tokens
        return {"ck": ((B, Hkv, n, hd), cd), "cv": ((B, Hkv, n, hd), cd)}
    if kind == "ssm":
        s = cfg.ssm
        Di = cfg.d_inner_
        return {
            "conv": ((B, s.conv_kernel - 1, Di), cd),
            "ssm": ((B, Di, s.state_dim), torch.float32),
        }
    if kind == "rglru":
        Dl = cfg.lru_width_
        return {
            "conv": ((B, 3, Dl), cd),
            "lru": ((B, Dl), torch.float32),
        }
    raise ValueError(f"no decode state for {kind!r} layers")


class CacheBlocks(list):
    """A rank's blocks of the decode state on a mesh, one dict a layer as
    a whole cache's, and `cuts`, one dict a layer: each K/V leaf's cut
    over `model` (`models.sharding.kv_split`: "positions", "heads" or
    None)."""

    def __init__(self, layers, cuts: List[Dict[str, Optional[str]]]):
        super().__init__(layers)
        self.cuts = cuts


def gather_heads(ts, tp: ParallelContext) -> list:
    """Each tensor of `ts` (B, H / tp, S, hd), this rank's heads, with
    every rank's heads (B, H, S, hd), in one all-gather over `model`."""
    mesh, axis = tp.mesh, tp.tp_axis
    n, B = tp.tp_size, ts[0].shape[0]
    flat = torch.cat([t.reshape(B, -1) for t in ts], dim=1)
    got = all_gather(flat[None], mesh, ((0, (axis,)),))    # (n, B, ...)
    out, at = [], 0
    for t in ts:
        size = t[0].numel()
        part = got[:, :, at:at + size].reshape((n,) + tuple(t.shape))
        out.append(part.transpose(0, 1).reshape(
            B, n * t.shape[1], *t.shape[2:]))
        at += size
    return out


def recut(ts, was: Optional[str], to: Optional[str], length: int,
          pctx: ParallelContext) -> list:
    """K/V tensors `ts` (B, H', n, hd) of one layer, cut over `model` by
    `was` ("heads", "positions" or None, `models.sharding.kv_split`), as
    this rank's blocks cut by `to` of a whole leaf of `length` positions:
    `ts` as they are where the cuts agree (and, cut by positions, the
    lengths), else gathered over `model` (one all-gather) and cut again,
    the source's positions zero-padded to `length` where `to` cuts
    them."""
    tp = pctx.tp_size
    n = ts[0].shape[2] * (tp if was == "positions" else 1)
    if n > length:
        raise ValueError(f"{n} source positions > the cache's {length}")
    if was == to and (to != "positions" or n == length):
        return list(ts)
    if was == "heads":
        ts = gather_heads(ts, pctx)
    elif was == "positions":
        both = all_gather(torch.cat(list(ts), 1), pctx.mesh,
                          ((2, (pctx.tp_axis,)),))
        ts = both.split([t.shape[1] for t in ts], 1)
    i = pctx.mesh.coords[pctx.tp_axis]
    if to == "heads":
        h = ts[0].shape[1] // tp
        return [t[:, i * h:(i + 1) * h] for t in ts]
    if to == "positions":
        per = length // tp
        return [F.pad(t, (0, 0, 0, length - n))[:, :, i * per:(i + 1) * per]
                for t in ts]
    return list(ts)


def init_cache(cfg: ModelConfig, B: int, L: int, device=None,
               pctx: Optional[ParallelContext] = None
               ) -> List[Dict[str, torch.Tensor]]:
    """Zero-filled decode state, one dict per layer.  Given a mesh
    `pctx`, a `CacheBlocks` of this rank's block of every leaf
    (`models.sharding.cache_slice`, as `models.sharding.cache_spec`
    places it): the batch over the data axes, the K/V caches by
    positions or by KV heads over `model`, and the conv, SSM and LRU
    states by channels over `model` where the width divides, which is
    where their mixers compute on the rank's channels
    (`models.sharding.computes_tp`); else whole."""
    from repro_torch.models.transformer import stack_plan

    mesh = pctx is not None and pctx.mesh is not None
    kinds = stack_plan(cfg).kinds
    caches: List[Dict[str, torch.Tensor]] = [{} for _ in kinds]
    cuts: List[Dict[str, Optional[str]]] = [{} for _ in kinds]
    for kind in dict.fromkeys(kinds):
        layers = [i for i, k in enumerate(kinds) if k == kind]
        for name, (shape, dt) in layer_cache_shape(cfg, kind, B, L).items():
            held = (torch.empty(shape, device="meta")[
                cache_slice(name, shape, pctx)].shape if mesh else shape)
            stacked = torch.zeros((len(layers),) + held, dtype=dt,
                                  device=device)
            for j, i in enumerate(layers):
                caches[i][name] = stacked[j]
                if mesh and name in KV_LEAVES:
                    cuts[i][name] = kv_split(name, shape, pctx)
    return CacheBlocks(caches, cuts) if mesh else caches

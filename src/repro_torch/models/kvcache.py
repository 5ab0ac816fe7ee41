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
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import torch_dtype


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


def init_cache(cfg: ModelConfig, B: int, L: int,
               device=None) -> List[Dict[str, torch.Tensor]]:
    """Zero-filled decode state, one dict per layer."""
    from repro_torch.models.transformer import stack_plan

    kinds = stack_plan(cfg).kinds
    caches: List[Dict[str, torch.Tensor]] = [{} for _ in kinds]
    for kind in dict.fromkeys(kinds):
        layers = [i for i, k in enumerate(kinds) if k == kind]
        for name, (shape, dt) in layer_cache_shape(cfg, kind, B, L).items():
            stacked = torch.zeros((len(layers),) + shape, dtype=dt,
                                  device=device)
            for j, i in enumerate(layers):
                caches[i][name] = stacked[j]
    return caches

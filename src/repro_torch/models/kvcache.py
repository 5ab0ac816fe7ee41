"""Decode state: the KV caches of the ported layer kinds.

Port of `repro.models.kvcache` for self-attention layers (``self_attn``
and ``moe``).  The JAX package threads a cache pytree through
`lax.scan`; the port keeps one list entry per layer, each a view of one
zero-filled tensor stacked over layers.  Decode writes into those views
in place (`models.attention.attention_block_decode`).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import torch_dtype


def layer_cache_shape(cfg: ModelConfig, kind: str, B: int, L: int) -> Dict:
    hd = cfg.head_dim_
    cd = torch_dtype(cfg.compute_dtype)
    if kind in ("self_attn", "moe"):
        shape = (B, cfg.num_kv_heads, L, hd)
        return {"k": (shape, cd), "v": (shape, cd)}
    raise NotImplementedError(
        f"decode state of {kind!r} layers is not ported yet; see ROADMAP.md")


def init_cache(cfg: ModelConfig, B: int, L: int,
               device=None) -> List[Dict[str, torch.Tensor]]:
    """Zero-filled decode state, one ``{"k", "v"}`` per layer."""
    from repro_torch.models.transformer import stack_plan

    kinds = stack_plan(cfg).kinds
    entries = [layer_cache_shape(cfg, kind, B, L) for kind in kinds]
    stacked = {
        name: torch.zeros((len(kinds),) + shape, dtype=dt, device=device)
        for name, (shape, dt) in entries[0].items()
    }
    return [{name: t[i] for name, t in stacked.items()}
            for i in range(len(kinds))]

"""Dense feed-forward blocks: SwiGLU / GeGLU (gated) and plain MLP.

Port of `repro.models.ffn`, for the layers of dense stacks and the dense
prefix layers of MoE stacks (`d_ff` = `d_ff_dense`).  Trained on a mesh
whose `model` axis divides the width, a rank computes its own columns of
it (`models.sharding.computes_tp`): column-parallel in, row-parallel
out, the partial sums added over `model`, then the plain MLP's output
bias once.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import act_fn, dense_init, storage_dtype
from repro_torch.models.parallel import ParallelContext, tp_enter, tp_exit


def gated(cfg: ModelConfig) -> bool:
    return cfg.act in ("silu", "gelu")


def ffn_width(cfg: ModelConfig, kind: str) -> int:
    """The hidden width of a layer's dense FFN: `d_ff_dense` for a MoE
    stack's leading ``dense`` layers where it is set, else `d_ff`
    (transformer.py:132-133)."""
    if kind == "dense" and cfg.moe is not None and cfg.moe.d_ff_dense:
        return cfg.moe.d_ff_dense
    return cfg.d_ff


def init_ffn(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None) -> Dict:
    d_ff = d_ff or cfg.d_ff
    dt = storage_dtype(cfg, "w_in")
    if gated(cfg):
        return {
            "w_gate": dense_init(gen, cfg.d_model, d_ff, dt),
            "w_up": dense_init(gen, cfg.d_model, d_ff, dt),
            "w_down": dense_init(gen, d_ff, cfg.d_model, dt),
        }
    return {
        "w_in": dense_init(gen, cfg.d_model, d_ff, dt),
        "b_in": torch.zeros((d_ff,), dtype=dt, device=gen.device),
        "w_out": dense_init(gen, d_ff, cfg.d_model, dt),
        "b_out": torch.zeros((cfg.d_model,), dtype=dt, device=gen.device),
    }


def apply_ffn(p, x: torch.Tensor, cfg: ModelConfig,
              tp: Optional[ParallelContext] = None) -> torch.Tensor:
    """With `tp`, `p` holds this rank's columns of the width (and the
    whole output bias)."""
    f = act_fn(cfg.act)
    x = tp_enter(x, tp)
    if "w_gate" in p:
        g = f(x @ p["w_gate"].to(x.dtype))
        u = x @ p["w_up"].to(x.dtype)
        return tp_exit((g * u) @ p["w_down"].to(x.dtype), tp)
    h = f(x @ p["w_in"].to(x.dtype) + p["b_in"].to(x.dtype))
    return tp_exit(h @ p["w_out"].to(x.dtype), tp) + p["b_out"].to(x.dtype)

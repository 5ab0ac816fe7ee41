"""Mixture-of-Experts, single-shard path, through the moe_gmm kernel.

Port of the single-shard path of `repro.models.moe.apply_moe`
(moe.py:190-200): softmax top-k routing with renormalized gates,
GShard-style capacity dispatch with a deterministic drop (stable rank
within each expert; dropped slots go to a sentinel row that is thrown
away), the per-expert gated FFN, and the gate-weighted combine, plus
DeepSeekMoE's always-on shared branch (moe.py:179-185, :200).  Where
the JAX package runs three einsums for the routed experts
("kernels/moe_gmm mirrors this", moe.py:128-131), the port calls
`kernels.moe_gmm` — on the card the hand-written Hopper kernel.  That
kernel computes silu only, so `apply_moe` refuses any other activation
rather than silently using silu.  The shared branch is three plain
products outside any kernel in the JAX package, and stays plain
`torch.matmul` here.  The expert-parallel `shard_map` branches (the
dispatch over `core.collectives.rotor_all_to_all`) need the
`ParallelContext` through the model and expert-sharded weights (ROADMAP
Queue 1 item 7b).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.models.layers import (act_fn, dense_init, normal_init,
                                       storage_dtype)


# ---------------- params ---------------------------------------------------


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> Dict:
    m = cfg.moe
    E, D, F = m.num_experts, cfg.d_model, m.d_ff_expert
    dt = storage_dtype(cfg, "w_gate")
    p = {
        "router": dense_init(gen, D, E, torch.float32),  # fp32 router
        "w_gate": normal_init(gen, (E, D, F), D**-0.5, dt),
        "w_up": normal_init(gen, (E, D, F), D**-0.5, dt),
        "w_down": normal_init(gen, (E, F, D), F**-0.5, dt),
    }
    if m.num_shared_experts:
        Fs = m.d_ff_shared
        sdt = storage_dtype(cfg, "shared_gate")
        p["shared_gate"] = dense_init(gen, D, Fs, sdt)
        p["shared_up"] = dense_init(gen, D, Fs, sdt)
        p["shared_down"] = dense_init(gen, Fs, D, sdt)
    return p


# ---------------- routing helpers ------------------------------------------


def _topk_route(logits: torch.Tensor, k: int):
    """softmax -> top-k -> renormalize (Qwen3/DeepSeek norm_topk_prob)."""
    probs = torch.softmax(logits.float(), dim=-1)        # (T, E)
    gates, idx = torch.topk(probs, k, dim=-1)            # (T, k), descending
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    return gates, idx, probs


def _rank_within_expert(e_flat: torch.Tensor, E: int) -> torch.Tensor:
    """rank[i] = #earlier slots assigned to the same expert (stable)."""
    Tk = e_flat.shape[0]
    order = torch.argsort(e_flat, stable=True)
    sorted_e = e_flat[order]
    starts = torch.searchsorted(sorted_e, torch.arange(E, device=e_flat.device))
    rank_sorted = torch.arange(Tk, device=e_flat.device) - starts[sorted_e]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    return rank


def _dispatch_combine_local(
    x_tok: torch.Tensor,  # (T, D)
    gates: torch.Tensor,  # (T, k)
    idx: torch.Tensor,    # (T, k)
    wg, wu, wd,           # (E, D, F), (E, D, F), (E, F, D)
    cfg: ModelConfig,
    capacity: int,
) -> torch.Tensor:
    """Capacity-dispatch, per-expert FFN (the moe_gmm kernel), combine."""
    E = cfg.moe.num_experts
    T, D = x_tok.shape
    k = idx.shape[1]

    e_flat = idx.reshape(-1)
    g_flat = gates.reshape(-1)
    t_flat = torch.arange(T * k, device=x_tok.device) // k  # token of each slot
    rank = _rank_within_expert(e_flat, E)
    keep = rank < capacity
    slot = torch.where(keep, e_flat * capacity + rank, E * capacity)

    # dropped slots all land on the sentinel row E * capacity, cut below
    buf = torch.zeros((E * capacity + 1, D), dtype=x_tok.dtype,
                      device=x_tok.device)
    buf[slot] = x_tok[t_flat]
    h = buf[:-1].reshape(E, capacity, D)

    out = moe_gmm(h, wg.to(h.dtype), wu.to(h.dtype), wd.to(h.dtype))

    flat = torch.cat([out.reshape(E * capacity, D),
                      torch.zeros((1, D), dtype=out.dtype, device=out.device)])
    y_slots = flat[slot] * (g_flat * keep)[:, None].to(out.dtype)
    # the JAX scatter-add y.at[t_flat].add: t_flat is contiguous per
    # token, so it is a sum over k in slot order, from zero
    y_slots = y_slots.reshape(T, k, D)
    y = torch.zeros((T, D), dtype=out.dtype, device=out.device) + y_slots[:, 0]
    for j in range(1, k):
        y = y + y_slots[:, j]
    return y


def _aux_loss(probs: torch.Tensor, idx: torch.Tensor, E: int) -> torch.Tensor:
    """Switch-style load-balance loss: E * sum_e f_e * P_e."""
    T, k = idx.shape
    ones = torch.ones(idx.numel(), dtype=torch.float32, device=idx.device)
    f_e = torch.zeros(E, dtype=torch.float32, device=idx.device).index_add_(
        0, idx.reshape(-1), ones) / (T * k)
    return E * torch.sum(f_e * probs.mean(0))


# ---------------- public apply ----------------------------------------------


def apply_moe(p, x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux_loss) for x (B, S, D): every token of the batch
    competes for one capacity buffer (T = B * S)."""
    if cfg.act != "silu":
        raise NotImplementedError(
            f"act {cfg.act!r}: the moe_gmm kernel computes silu only")
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.num_experts, m.top_k
    T = B * S
    capacity = _capacity(T, k, E, m.capacity_factor)
    logits = x.reshape(T, D).float() @ p["router"]
    gates, idx, probs = _topk_route(logits, k)
    y = _dispatch_combine_local(
        x.reshape(T, D), gates, idx,
        p["w_gate"], p["w_up"], p["w_down"], cfg, capacity,
    ).reshape(B, S, D)
    if m.num_shared_experts:  # always-on branch (DeepSeekMoE)
        f = act_fn(cfg.act)
        g = f(x @ p["shared_gate"].to(x.dtype))
        u = x @ p["shared_up"].to(x.dtype)
        y = y + (g * u) @ p["shared_down"].to(x.dtype)
    return y, _aux_loss(probs, idx, E)


def _capacity(T: int, k: int, E: int, cf: float) -> int:
    c = int(np.ceil(T * k / E * cf))
    return max(4, ((c + 3) // 4) * 4)

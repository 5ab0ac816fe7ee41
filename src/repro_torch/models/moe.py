"""Mixture-of-Experts through the moe_gmm kernel, on one process or with
the experts sharded over the model axis.

Port of `repro.models.moe.apply_moe`: softmax top-k routing with
renormalized gates, GShard-style capacity dispatch with a deterministic
drop (stable rank within each expert; dropped slots go to a sentinel row
that is thrown away), the per-expert gated FFN, and the gate-weighted
combine, plus DeepSeekMoE's always-on shared branch (moe.py:179-185).
Where the JAX package runs three einsums for the routed experts
("kernels/moe_gmm mirrors this", moe.py:128-131), the port calls
`kernels.moe_gmm` — on the card the hand-written Hopper kernel — with
the config's activation (``act_fn(cfg.act)``, moe.py:101: silu, gelu or
relu, each an instantiation of the kernel) in every branch.  The shared
branch is three plain products outside any kernel in the JAX package,
with the same activation (moe.py:182), and stays plain `torch.matmul`
here.

With a mesh whose model axis has tp > 1 ranks, each rank holds E / tp
experts (`models.sharding`) and its data shard's rows, and runs the JAX
package's `shard_map` body as per-rank code (moe.py:202-278):

* the all-to-all branch (S > 1 and S % tp == 0): this rank routes the
  sequence slice at its model coordinate with the capacity of its own
  tokens, sends each expert shard its (E / tp, C, D) buffer by
  ``pctx.moe_dispatch`` (`rotor_all_to_all`, with VLB, or
  `comm.all_to_all` for ``xla``; ``local`` routes as ``rotor``, as in
  the JAX package), runs its experts on tp * C rows, sends the outputs
  back and gathers the slices over the model axis (`rotor_all_gather`:
  the reshard GSPMD makes at the out_spec).  The aux loss is the mean of
  every shard's (`expander_psum_latency` over the model axis, then each
  data axis);
* the local branch (S 1, or S not a multiple of tp): every rank routes
  all of its rows and runs its own experts' buffers; the partial outputs
  are summed by `rotor_all_reduce(mode="direct")`.  The aux loss is this
  rank's, not averaged (moe.py:262).

Every collective is differentiable (`core.comm.ppermute`), so autograd
gives each rank its share of the gradient; `train.trainer` sums them.
These collectives are exact transposes: the shares of the input's
cotangent over the model ranks add up to tp times its gradient, and a
rank's share covers only what it routed.  The branch's input enters
through `models.parallel.tp_enter` with their mean, so that every model
rank reads the whole gradient, as the tensor-parallel blocks before it
(attention split by heads, Megatron's pair) need.  The shared branch
splits by width over `model` where its width divides tp
(`models.sharding.computes_tp`), as the dense FFN does.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.core.comm import all_to_all
from repro_torch.kernels.moe_gmm import moe_gmm
from repro_torch.models.layers import (act_fn, dense_init, normal_init,
                                       storage_dtype)
from repro_torch.models.parallel import (ParallelContext, single_device_ctx,
                                        tp_enter, tp_exit)


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
    wg, wu, wd,           # (E_loc, D, F), (E_loc, D, F), (E_loc, F, D)
    cfg: ModelConfig,
    capacity: int,
    a2a: Optional[Callable] = None,
    n_shards: int = 1,
    expert_offset: int = 0,
) -> torch.Tensor:
    """Capacity-dispatch, (optional) all-to-all, per-expert FFN (the
    moe_gmm kernel), combine.  `a2a` takes and returns (n_shards, E_loc,
    C, D); without it, experts E_loc < E are this rank's, from
    `expert_offset`."""
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
    buf = buf[:-1].reshape(E, capacity, D)

    E_loc = wg.shape[0]
    if a2a is not None:
        sent = a2a(buf.reshape(n_shards, E_loc, capacity, D))
        # sent[s] = the buffer from source shard s for this rank's experts
        h = sent.transpose(0, 1).reshape(E_loc, n_shards * capacity, D)
    else:
        h = buf[expert_offset:expert_offset + E_loc]

    out = moe_gmm(h, wg.to(h.dtype), wu.to(h.dtype), wd.to(h.dtype),
                  cfg.act)

    if a2a is not None:
        back = a2a(out.reshape(E_loc, n_shards, capacity, D).transpose(0, 1))
        # back[s] = this rank's tokens' outputs from expert shard s
        out_full = back.reshape(E, capacity, D)
    elif E_loc != E:
        out_full = torch.cat([
            out.new_zeros((expert_offset, capacity, D)), out,
            out.new_zeros((E - expert_offset - E_loc, capacity, D))])
    else:
        out_full = out

    flat = torch.cat([out_full.reshape(E * capacity, D),
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


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig,
              pctx: ParallelContext = single_device_ctx(),
              shared_tp: Optional[ParallelContext] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux_loss) for x (B, S, D), this rank's rows.  Without
    a mesh, or with one model rank, every token of the batch competes for
    one capacity buffer (T = B * S) and `p` holds every expert; with tp >
    1 model ranks, `p` holds this rank's E / tp experts and the experts
    run expert-parallel (the module's docstring).  With `shared_tp`, `p`
    holds this rank's columns of the shared experts' width."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.num_experts, m.top_k
    tp = pctx.tp_size

    if pctx.mesh is None or tp == 1:   # one shard: no communication
        T = B * S
        capacity = _capacity(T, k, E, m.capacity_factor)
        logits = x.reshape(T, D).float() @ p["router"]
        gates, idx, probs = _topk_route(logits, k)
        y = _dispatch_combine_local(
            x.reshape(T, D), gates, idx,
            p["w_gate"], p["w_up"], p["w_down"], cfg, capacity,
        ).reshape(B, S, D)
        aux = _aux_loss(probs, idx, E)
    else:
        y, aux = _apply_sharded(p, x, cfg, pctx)
    if m.num_shared_experts:  # always-on branch (DeepSeekMoE)
        f = act_fn(cfg.act)
        xs = tp_enter(x, shared_tp)
        g = f(xs @ p["shared_gate"].to(x.dtype))
        u = xs @ p["shared_up"].to(x.dtype)
        y = y + tp_exit((g * u) @ p["shared_down"].to(x.dtype), shared_tp)
    return y, aux


def _apply_sharded(p, x: torch.Tensor, cfg: ModelConfig,
                   pctx: ParallelContext):
    """The JAX package's two `shard_map` bodies (moe.py:217-276) on this
    rank."""
    m = cfg.moe
    B, S, D = x.shape
    E, k = m.num_experts, m.top_k
    mesh, tp_axis, tp = pctx.mesh, pctx.tp_axis, pctx.tp_size
    if E % tp:
        raise ValueError(f"{E} experts do not divide over tp {tp} model ranks")
    E_loc = E // tp
    if p["w_gate"].shape[0] != E_loc:
        raise ValueError(f"expert leaves of {p['w_gate'].shape[0]} experts "
                         f"on a rank of tp {tp}: expected {E_loc} "
                         "(models.sharding.shard_params)")
    me = mesh.coords[tp_axis]
    weights = (p["w_gate"], p["w_up"], p["w_down"])
    x = tp_enter(x, pctx, mean=True)   # the module's docstring

    if S > 1 and S % tp == 0:   # tokens sharded over data x seq / tp
        s = S // tp
        xl = x[:, me * s:(me + 1) * s]
        T = B * s
        capacity = _capacity(T, k, E, m.capacity_factor)
        logits = xl.reshape(T, D).float() @ p["router"]
        gates, idx, probs = _topk_route(logits, k)

        def a2a(buf):
            if pctx.moe_dispatch == "xla":
                return all_to_all(buf, mesh, tp_axis)
            return C.rotor_all_to_all(buf, mesh, tp_axis,
                                      vlb=pctx.moe_dispatch == "rotor_vlb")

        y = _dispatch_combine_local(
            xl.reshape(T, D), gates, idx, *weights, cfg, capacity,
            a2a=a2a, n_shards=tp).reshape(B, s, D)
        # every slice to every model rank, in sequence order
        y = C.rotor_all_gather(y, mesh, tp_axis).transpose(0, 1).reshape(
            B, S, D)
        # the aux loss: the mean of every shard's, over the latency path
        aux = _aux_loss(probs, idx, E)
        aux = C.expander_psum_latency(aux[None], mesh, tp_axis)[0]
        for ax in tuple(pctx.dp_axes)[::-1]:
            aux = C.expander_psum_latency(aux[None], mesh, ax)[0]
        return y, aux / (tp * pctx.dp_size)

    # decode-style: tokens replicated over tp, each rank its own experts,
    # the partial outputs summed over tp (rotor-direct)
    T = B * S
    capacity = _capacity(T, k, E, m.capacity_factor)
    logits = x.reshape(T, D).float() @ p["router"]
    gates, idx, probs = _topk_route(logits, k)
    y = _dispatch_combine_local(
        x.reshape(T, D), gates, idx, *weights, cfg, capacity,
        expert_offset=me * E_loc).reshape(B, S, D)
    y = C.rotor_all_reduce(y, mesh, tp_axis, mode="direct")
    return y, _aux_loss(probs, idx, E)


def _capacity(T: int, k: int, E: int, cf: float) -> int:
    c = int(np.ceil(T * k / E * cf))
    return max(4, ((c + 3) // 4) * 4)

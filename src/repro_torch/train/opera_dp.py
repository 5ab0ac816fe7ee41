"""Opera-DP: the fully-explicit data-parallel trainer.

Port of `repro.train.opera_dp`.  Where the JAX package runs the step in
one `shard_map` over the DP axes, the port runs it on every rank of a
`torch.distributed` world: each rank takes autograd of `loss_fn` on its
shard of the global batch (the single-process path), then

  bulk class    -> gradients via the hierarchical rotor schedule
                   (reduce-scatter over `data`, direct exchange over
                   `pod`, all-gather over `data`) — every byte one hop
                   per phase, Opera's tax-free direct circuits;
  latency class -> scalar telemetry (loss/aux/total) via immediate
                   multi-hop expander gossip (`expander_psum_latency`);
  compression   -> optional int8 + error-feedback on the wire
                   (`compressed_rotor_all_reduce`), a beyond-paper
                   distributed-optimization trick; each rank carries its
                   own error in ``state["err"]``.

Gradients are reduced a JAX leaf at a time (`models.convert.
jax_leaf_groups`: a scanned leaf stacks one leaf a layer), so that the
reduce-scatter's chunks, the order of every addition and the compressed
path's per-leaf scale are the JAX package's.  Then the same AdamW update
on every rank.  The reduced chunks are
gathered, not summed again, so every rank holds the same gradient bits
and the replicas stay bit-identical (with a pod axis of two, whose
direct exchange adds the same two terms on both sides).  On one shard
without compression there is nothing to reduce, and the step is
`train.trainer.make_train_step` itself.  The model runs on each rank as
on one process (`single_device_ctx`, opera_dp.py:41-46): on a mesh with
model ranks they are replicas, each on its data shard's rows.

Best suited to models whose params fit replicated (smollm-class).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.models.convert import jax_leaf_groups
from repro_torch.models.model import loss_fn
from repro_torch.models.parallel import ParallelContext, single_device_ctx
from repro_torch.optim.adamw import (AdamWConfig, adamw_update,
                                     init_opt_state, named_leaves)
from repro_torch.train.trainer import make_train_step, shard_batch


def make_opera_dp_train_step(cfg: ModelConfig, pctx: ParallelContext,
                             opt: AdamWConfig, compress: bool = False
                             ) -> Callable:
    """(state, global batch) -> (state, metrics), run by every rank of
    `pctx.mesh`; the state is written in place.  Metrics {"loss", "aux",
    "total", "grad_norm", "lr"} are 0-d tensors, the same on every rank."""
    if pctx.dp_size == 1 and not compress:
        return make_train_step(cfg, single_device_ctx(), opt)
    mesh = pctx.mesh
    data_axis = pctx.dp_axes[-1]
    pod_axis = pctx.pod_axis
    n_shards = pctx.dp_size

    def sync(g: torch.Tensor, e: torch.Tensor) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
        tot, ne = C.compressed_rotor_all_reduce(g, mesh, data_axis, e)
        if pod_axis is not None:
            tot = C.rotor_all_reduce(tot, mesh, pod_axis, mode="direct")
        return tot / n_shards, ne

    def stacked(ts):
        return ts[0] if len(ts) == 1 else torch.stack(ts)

    def unstacked(t, n):
        return [t] if n == 1 else list(t.unbind(0))

    def train_step(state: Dict, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        params = state["params"]
        names, leaves = zip(*params.named_parameters())
        total, metrics = loss_fn(params, shard_batch(batch, pctx), cfg)
        grads = dict(zip(names, torch.autograd.grad(
            total, leaves, allow_unused=True, materialize_grads=True)))
        out = {"params": params}
        if compress:
            out["err"] = {}
        # one collective a JAX leaf: its chunks, and with compression its
        # scale, are the JAX package's
        for group in jax_leaf_groups(cfg, names):
            g = stacked([grads[k] for k in group])
            if compress:
                g, e = sync(g, stacked([state["err"][k] for k in group]))
                out["err"].update(zip(group, unstacked(e, len(group))))
            else:
                g = C.hierarchical_rotor_all_reduce(
                    g, mesh, data_axis, pod_axis) / n_shards
            grads.update(zip(group, unstacked(g, len(group))))

        # latency class: control-plane scalars cross the fabric immediately
        agg = {}
        for k, v in metrics.items():
            s = C.expander_psum_latency(v.detach()[None], mesh, data_axis)[0]
            if pod_axis is not None:
                s = C.expander_psum_latency(s[None], mesh, pod_axis)[0]
            agg[k] = s / n_shards

        _, out["opt"], om = adamw_update(opt, params, grads, state["opt"])
        agg.update(om)
        return out, agg

    return train_step


def init_opera_dp_state(params, compress: bool = False) -> Dict:
    st = {"params": params, "opt": init_opt_state(params)}
    if compress:
        st["err"] = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device)
                     for k, p in named_leaves(params).items()}
    return st

"""Train-step construction: loss -> grads -> sum over the mesh -> AdamW.

Port of `repro.train.trainer.make_train_step(cfg, pctx, opt)` without its
rotor inter-pod branch (a `shard_map` over the pod axis whose gradient
reduction is `rotor_all_reduce`, trainer.py:69-112; ROADMAP Queue 1 item
7c).  Without a mesh, or on a mesh of one rank, it is the JAX package's
single-device step (trainer.py:56-67): value and grad of
`models.model.loss_fn` (autograd in place of `jax.value_and_grad`), then
`optim.adamw.adamw_update`, with the metrics merged.

On a mesh every rank runs the step, in one order, as the JAX package's
GSPMD program runs on every device, and holds only its blocks of each
leaf and of both AdamW moments, placed by the JAX package's rules under
``pctx.layout`` (`models.sharding`: ``fsdp_tp`` by default, ``dp_only``
or ``tp_only``).  It takes its rows of the global batch (`shard_batch`,
by `batch_spec`) and runs autograd of `loss_fn(..., pctx)` on them.  The
forward computes tensor-parallel over `model` where `models.sharding.
computes_tp` says so (attention by heads, the FFNs and shared experts by
width, the mamba and RG-LRU mixers by channels, the embedding and the
head by vocab; Megatron's pair, so a
`model` rank's autograd gives the gradient of its block once) and
gathers every other leaf whole on use, GSPMD's inserted all-gather (the
``xla`` baseline of trainer.py:3-6), whose backward reduce-scatters the
leaf's gradient over the axes it is cut on; every `model` rank computes
such a leaf's whole use, so the sum over `model` counts it tp times.
The MoE layers run expert-parallel over the model axis with
differentiable collectives.  `sum_grads` then sums each leaf's gradient
with `dist.all_reduce` over the axes it is replicated on (`models.
sharding.replicated_axes`) and divides by the dp data ranks, and by tp
for a leaf that does not compute tensor-parallel.  That is the gradient
of the JAX package's global loss (`jax.grad` through its `shard_map`,
whose transpose divides a replicated output's cotangent by the ranks it
is replicated on and sums a replicated input's over them).
The global norm that AdamW clips by sums each leaf's squares over
exactly the axes it is cut on.  Every rank then runs AdamW on its
blocks, so the ranks that hold one block hold the same bits of it.  The
metrics are averaged over the data ranks (the JAX package's global
cross-entropy; its aux is every shard's mean in the all-to-all branch,
ROADMAP Queue 3 R5 for the local branch).  The rotor pod branch, and
with it ``grad_sync``, waits in item 7c.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.comm import all_reduce
from repro_torch.models.model import loss_fn
from repro_torch.models.parallel import ParallelContext
from repro_torch.models.sharding import (batch_spec, computes_tp,
                                        replicated_axes, sharded_axes)
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state


def dp_index(pctx: ParallelContext) -> int:
    """This rank's shard of the batch: its linear index over the DP axes,
    the first axis major, as ``P(("pod", "data"))`` places the rows."""
    mesh = pctx.mesh
    return int(np.ravel_multi_index(
        [mesh.coords[a] for a in pctx.dp_axes],
        [mesh.shape[a] for a in pctx.dp_axes]))


def shard_batch(batch: Dict[str, torch.Tensor], pctx: ParallelContext
                ) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global batch, as `models.sharding.
    batch_spec` places them: a block of rows over the data axes where
    they divide, else every row."""
    n, i = pctx.dp_size, dp_index(pctx)
    out = {}
    for k, v in batch.items():
        if batch_spec(k, v.shape, pctx)[0] is None:
            out[k] = v
        else:
            rows = v.shape[0] // n
            out[k] = v[i * rows:(i + 1) * rows]
    return out


def _grads(params, total: torch.Tensor):
    names, leaves = zip(*params.named_parameters())
    # a leaf the loss does not reach gets a zero gradient, as jax.grad
    grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                materialize_grads=True)
    return dict(zip(names, grads))


def _squares(grads, device) -> torch.Tensor:
    return sum((torch.sum(torch.square(g.float())) for g in grads),
               torch.zeros((), device=device))


def sum_grads(grads: Dict[str, torch.Tensor], cfg: ModelConfig,
              pctx: ParallelContext
              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Every rank's autograd of its `loss_fn` share, each leaf's already
    reduce-scattered over the axes it is cut on (the backward of its
    gather on use) -> (the gradient of the JAX package's global loss,
    this rank's block of each leaf, summed in place over the axes the
    leaf is replicated on and divided by dp, and by tp where the leaf
    does not compute tensor-parallel; the whole gradient's global norm,
    the same on every rank)."""
    mesh = pctx.mesh
    by_axes: Dict[Tuple[str, ...], list] = {}
    for name, g in grads.items():
        g = all_reduce(g.contiguous(), mesh,
                       replicated_axes(name, g.shape, cfg, pctx))
        once = computes_tp(name, cfg, pctx)
        grads[name] = g.div_(pctx.dp_size * (1 if once else pctx.tp_size))
        cut = tuple(sorted(set(sharded_axes(name, g.shape, cfg, pctx))))
        by_axes.setdefault(cut, []).append(g)
    # the global norm: each leaf's squares summed over exactly the axes
    # it is cut on, in one sum a set of axes
    dev = next(iter(grads.values())).device
    sq = torch.zeros((), device=dev)
    for axes, gs in sorted(by_axes.items()):
        sq = sq + all_reduce(_squares(gs, dev), mesh, axes)
    return grads, torch.sqrt(sq)


def make_train_step(cfg: ModelConfig, pctx: ParallelContext,
                    opt: AdamWConfig) -> Callable:
    """(state, batch) -> (state, metrics): one step on `state` =
    {"params": trainable ParamTree, "opt": optimizer state}, written in
    place; metrics {"loss", "aux", "total", "grad_norm", "lr"} are 0-d
    tensors on the parameters' device.  On a mesh `batch` is the global
    batch, and every rank of `pctx.mesh` calls the step."""
    if pctx.mesh is None or pctx.dp_size * pctx.tp_size == 1:

        def train_step(state: Dict, batch: Dict[str, torch.Tensor]
                       ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
            params = state["params"]
            total, metrics = loss_fn(params, batch, cfg, pctx)
            grads = _grads(params, total)
            _, new_opt, om = adamw_update(opt, params, grads, state["opt"])
            metrics = {k: v.detach() for k, v in metrics.items()}
            metrics.update(om)
            return {"params": params, "opt": new_opt}, metrics

        return train_step

    def train_step(state: Dict, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict, Dict[str, torch.Tensor]]:
        params = state["params"]
        total, metrics = loss_fn(params, shard_batch(batch, pctx), cfg, pctx)
        grads, gnorm = sum_grads(_grads(params, total), cfg, pctx)
        _, new_opt, om = adamw_update(opt, params, grads, state["opt"],
                                      gnorm=gnorm)
        # the JAX package's global metrics: the mean over the data ranks
        keys = list(metrics)
        vals = torch.stack([metrics[k].detach().float() for k in keys])
        all_reduce(vals, pctx.mesh, pctx.dp_axes).div_(pctx.dp_size)
        metrics = dict(zip(keys, vals.unbind(0)))
        metrics.update(om)
        return {"params": params, "opt": new_opt}, metrics

    return train_step


def init_train_state(cfg: ModelConfig, params) -> Dict:
    return {"params": params, "opt": init_opt_state(params)}

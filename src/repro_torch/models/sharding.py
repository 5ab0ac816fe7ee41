"""Which parameters are sharded over the mesh, and a rank's share of them.

Port of the expert rule of `repro.models.sharding.param_spec`
(sharding.py:89-96): a MoE layer's stacked experts (``w_gate``, ``w_up``,
``w_down``, (E, D, F) or (E, F, D)) put their E dim over the model axis
when the axis's size divides it; every other leaf is replicated.  A spec
is a tuple of one axis name or None a dim, as a `PartitionSpec`.  The
JAX rules' FSDP half (the D dim over the data axes) and the TP rules of
the dense weights (`_MATRIX_RULES`, `batch_spec`, `cache_spec`) come
with their readers (ROADMAP Queue 1 item 7c).

`shard_params` cuts a whole parameter tree to this rank's experts and
`gather_params` puts the whole tensors back (an all-gather over the
model axis); `local_slice` gives the cut for a leaf by name, which
`models.convert` and `train.checkpoint` apply to whole numpy arrays.
`replicated_axes` names the axes a leaf's gradient is summed over
(`train.trainer`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.core import collectives as C
from repro_torch.models.parallel import ParallelContext

Spec = Tuple[Optional[str], ...]

_EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def _axis_ok(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def param_spec(name: str, shape: Sequence[int], cfg: ModelConfig,
               pctx: ParallelContext) -> Spec:
    """The spec of the leaf `name` ("stack.3.moe.w_gate", a `ParamTree`'s
    dotted name) of `shape`, whole or a rank's block: the expert dim over
    ``pctx.tp_axis`` where it divides ``cfg.moe.num_experts`` (the whole
    leaf's dim, sharding.py:92), else every dim replicated."""
    parts = name.split(".")
    spec: list = [None] * len(shape)
    if ("moe" in parts[:-1] and parts[-1] in _EXPERT_LEAVES
            and len(shape) >= 3
            and _axis_ok(cfg.moe.num_experts, pctx.tp_size)):
        spec[-3] = pctx.tp_axis
    return tuple(spec)


def replicated_axes(name: str, shape: Sequence[int], cfg: ModelConfig,
                    pctx: ParallelContext) -> Tuple[str, ...]:
    """The mesh axes the leaf is replicated on: its gradient's sum runs
    over them."""
    spec = param_spec(name, shape, cfg, pctx)
    return tuple(a for a in pctx.all_axes if a not in spec)


def local_slice(name: str, shape: Sequence[int], cfg: ModelConfig,
                pctx: ParallelContext) -> Tuple[slice, ...]:
    """This rank's block of the whole leaf `name` of `shape`."""
    out = []
    for dim, axis in zip(shape, param_spec(name, shape, cfg, pctx)):
        if axis is None:
            out.append(slice(None))
        else:
            n = dim // pctx.mesh.shape[axis]
            i = pctx.mesh.coords[axis]
            out.append(slice(i * n, (i + 1) * n))
    return tuple(out)


def _leaf_owners(params: nn.Module):
    """(dotted name, owning module, attribute) of every parameter."""
    for mod_name, mod in params.named_modules():
        for attr, p in mod.named_parameters(recurse=False):
            yield (f"{mod_name}.{attr}" if mod_name else attr), mod, attr


def shard_params(params: nn.Module, cfg: ModelConfig,
                 pctx: ParallelContext) -> nn.Module:
    """Cut every sharded leaf of the whole tree `params` to this rank's
    block, in place (a copy of the block, so that the whole tensor is
    freed); requires_grad as it was.  Returns `params`."""
    for name, mod, attr in list(_leaf_owners(params)):
        p = getattr(mod, attr)
        cut = local_slice(name, p.shape, cfg, pctx)
        if any(s != slice(None) for s in cut):
            setattr(mod, attr, nn.Parameter(p.detach()[cut].clone(),
                                            requires_grad=p.requires_grad))
    return params


def gather_leaf(name: str, t: torch.Tensor, cfg: ModelConfig,
                pctx: ParallelContext) -> torch.Tensor:
    """The whole tensor of this rank's block `t` of leaf `name`, from
    every rank's (`rotor_all_gather` over each sharded axis); `t` itself
    where the leaf is replicated.  Every rank of the mesh calls it."""
    with torch.no_grad():
        for dim, axis in enumerate(param_spec(name, t.shape, cfg, pctx)):
            if axis is not None:
                parts = C.rotor_all_gather(t.detach(), pctx.mesh, axis)
                t = torch.cat(list(parts.unbind(0)), dim=dim)
    return t


def gather_params(params: nn.Module, cfg: ModelConfig,
                  pctx: ParallelContext) -> nn.Module:
    """`shard_params`' inverse: every sharded leaf back to its whole
    tensor, in place, from every rank's block.  Returns `params`."""
    for name, mod, attr in list(_leaf_owners(params)):
        p = getattr(mod, attr)
        whole = gather_leaf(name, p, cfg, pctx)
        if whole is not p:
            setattr(mod, attr, nn.Parameter(whole,
                                            requires_grad=p.requires_grad))
    return params

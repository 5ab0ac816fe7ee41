"""The JAX package's parameters as the port's.

`params_from_numpy(cfg, tree)` takes the parameter pytree of
`repro.models.model.init_params` with every leaf turned into a numpy
array (``jax.tree.map(np.asarray, params)``) and returns the port's
`ParamTree`: the unrolled ``stack/prefix`` layers, then the scanned
``stack/blocks/<j>`` leaves (stacked over a leading ``n_scan`` axis)
unstacked, then the unrolled ``stack/tail`` layers, into one entry per
layer in `StackPlan.kinds` order (the JAX package's scan order; a vlm
superblock's ``blocks/0`` .. ``blocks/4`` interleave); an encdec model's
``encoder`` stack likewise in `encoder_plan` order; every
leaf keeps its ``(d_in, d_out)`` layout,
and each is cast to its storage dtype (`layers.storage_dtype`) — the
dtype the JAX forward casts it to at use, so the forwards agree bit for
bit in the casts.  With ``masters=True`` every leaf stays float32
(``param_dtype``) and requires grad: the training state, or a JAX
gradient tree carried across for comparison.  `jax_leaf_groups` names
the port's leaves that form one JAX leaf, for code that must treat them
as the JAX package does (the rotor gradient sync's chunks and scales).
Given a mesh `ParallelContext` with model ranks, `params_from_numpy`
gives each rank its block of every sharded leaf (`models.sharding.
local_slice`: its experts), cut from the whole numpy array before it
reaches the device.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import (ParamTree, storage_config,
                                      storage_dtype)
from repro_torch.models.parallel import ParallelContext
from repro_torch.models.sharding import local_slice
from repro_torch.models.plan import (StackPlan, encoder_plan, jax_leaf,
                                     stack_plan)


def _leaves(cfg: ModelConfig, tree: Mapping, dev: torch.device,
            cut: Optional[Callable] = None, prefix: str = "") -> dict:
    out = {}
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, Mapping):
            out[name] = _leaves(cfg, value, dev, cut, f"{path}.")
        else:
            if cut is not None:
                value = np.asarray(value)[cut(path, np.shape(value))]
            # a float32 copy: bf16 leaves arrive as ml_dtypes arrays, and
            # arrays from JAX are read-only
            arr = np.array(value, dtype=np.float32, order="C")
            out[name] = torch.from_numpy(arr).to(
                device=dev, dtype=storage_dtype(cfg, name))
    return out


def _index(tree: Mapping, i: int) -> dict:
    return {name: (_index(v, i) if isinstance(v, Mapping) else v[i])
            for name, v in tree.items()}


def _unrolled(stack: Mapping, name: str) -> list:
    """The JAX stack's list of unrolled layers `name` ("prefix" or
    "tail"); from `tree_from_flat` it arrives keyed "0", "1", ..."""
    layers = stack.get(name, [])
    if isinstance(layers, Mapping):
        layers = [layers[str(i)] for i in range(len(layers))]
    return list(layers)


def tree_from_flat(flat: Mapping[str, np.ndarray]) -> dict:
    """Nested dicts from ``"a/b/c"`` keys (a pytree saved with `np.savez`
    under its key paths; a list's entries under ``"0"``, ``"1"``, ...)."""
    tree: dict = {}
    for key, value in flat.items():
        *path, leaf = key.split("/")
        node = tree
        for name in path:
            node = node.setdefault(name, {})
        node[leaf] = value
    return tree


def _layers(stack: Mapping, plan: StackPlan) -> list:
    """A JAX stack's layers, one tree each, in `plan.kinds` order."""
    layers = _unrolled(stack, "prefix")
    layers += [_index(stack["blocks"][str(j)], i)
               for i in range(plan.n_scan) for j in range(len(plan.pattern))]
    layers += _unrolled(stack, "tail")
    if len(layers) != len(plan.kinds):
        raise ValueError(f"{len(layers)} layers for a plan of "
                         f"{len(plan.kinds)}")
    return layers


def params_from_numpy(cfg: ModelConfig, tree: Mapping,
                      device: DeviceLike = None,
                      masters: bool = False,
                      pctx: Optional[ParallelContext] = None) -> ParamTree:
    dev = resolve_device(device)
    cfg = storage_config(cfg, masters)
    cut = None
    if pctx is not None and pctx.mesh is not None:
        def cut(name, shape):
            return local_slice(name, shape, cfg, pctx)
    stacks = {"stack": stack_plan(cfg)}
    if "encoder" in tree:
        stacks["encoder"] = encoder_plan(cfg)
    out = _leaves(cfg, {name: v for name, v in tree.items()
                        if name not in stacks}, dev, cut)
    for name, plan in stacks.items():
        out[name] = [_leaves(cfg, layer, dev, cut, f"{name}.{i}.")
                     for i, layer in enumerate(_layers(tree[name], plan))]
    return ParamTree(out).requires_grad_(masters)


def jax_leaf_groups(cfg: ModelConfig, names: Sequence[str]) -> List[List[str]]:
    """The port's parameter `names` ("stack.3.attn.wq", ...) grouped as
    the JAX package's leaves (`models.plan.jax_leaf`), in the order of
    `names`' first members; a scanned leaf's group is in scan order."""
    groups: Dict[Tuple, List[str]] = {}
    for name in names:
        groups.setdefault(jax_leaf(name, cfg)[0], []).append(name)
    return list(groups.values())

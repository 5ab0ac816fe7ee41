"""The JAX package's split of a stack into layers, and which of the
port's leaves its scanned leaves stack.

Port of `repro.models.transformer.stack_plan` / `encoder_plan`
(transformer.py:52-73).  The JAX package scans stacked superblocks with
`lax.scan`; the port keeps one `ParamTree` a layer in `StackPlan.kinds`
order, and `jax_leaf` maps a port leaf back to the JAX leaf it is a
slice of (`models.convert` carries parameters across by it,
`models.sharding` places a leaf by the JAX leaf's shape, and
`train.opera_dp` compresses by JAX leaf).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """The JAX package's split: the unrolled `prefix`, the scanned
    superblock `pattern` repeated `n_scan` times, then the unrolled
    `tail`."""
    prefix: Tuple[str, ...]
    pattern: Tuple[str, ...]
    n_scan: int
    tail: Tuple[str, ...] = ()

    @property
    def kinds(self) -> Tuple[str, ...]:
        return self.prefix + self.pattern * self.n_scan + self.tail


def stack_plan(cfg: ModelConfig) -> StackPlan:
    """The JAX package's split of the stack (transformer.py:52-70), kept
    so that parameters convert layer by layer."""
    kinds = cfg.layer_kinds()
    if cfg.family == "encdec":
        return StackPlan((), ("decoder",), cfg.num_layers)
    if cfg.family == "moe" and cfg.moe.first_dense_layers:
        r = cfg.moe.first_dense_layers
        return StackPlan(tuple(kinds[:r]), ("moe",), cfg.num_layers - r)
    if cfg.family == "hybrid":
        p = cfg.hybrid.pattern
        n = cfg.num_layers // len(p)
        return StackPlan((), tuple(p), n, tuple(kinds[len(p) * n:]))
    if cfg.family == "vlm" and cfg.cross_attn_every:
        pe = cfg.cross_attn_every
        if cfg.num_layers % pe:
            raise ValueError(f"{cfg.num_layers} layers are no whole number "
                             f"of {pe}-layer blocks")
        return StackPlan((), kinds[:pe], cfg.num_layers // pe)
    return StackPlan((), (kinds[0],), cfg.num_layers)


def encoder_plan(cfg: ModelConfig) -> StackPlan:
    """The encoder's stack (transformer.py:73): `encoder_layers` of kind
    ``encoder``; none outside the encdec family."""
    return StackPlan((), ("encoder",), cfg.encoder_layers)


def jax_leaf(name: str, cfg: ModelConfig) -> Tuple[Tuple, int]:
    """(key, n): the JAX leaf that the port's leaf `name`
    ("stack.3.attn.wq") belongs to, and the number of layers it stacks
    over its leading axis.  A scanned leaf ``stack/blocks/<j>/...``
    stacks the leaves of the layers ``prefix + i * len(pattern) + j``
    over the scan steps i, and its key is ``(stack, j, *rest)``; an
    unrolled layer's leaf, or any other, is its own (``(name,)``, n 0)."""
    plans = {"stack": stack_plan(cfg)}
    if cfg.family == "encdec":
        plans["encoder"] = encoder_plan(cfg)
    parts = name.split(".")
    if parts[0] in plans and len(parts) > 2:
        plan, layer = plans[parts[0]], int(parts[1])
        k = layer - len(plan.prefix)
        if 0 <= k < plan.n_scan * len(plan.pattern):
            return (parts[0], k % len(plan.pattern), *parts[2:]), plan.n_scan
    return (name,), 0

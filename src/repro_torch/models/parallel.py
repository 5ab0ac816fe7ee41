"""Parallel context: the mesh, its axis names, the dense weights' layout
and the MoE dispatch.

Port of `repro.models.parallel`.  Carries the `core.comm.Mesh`, the
names of its data, tensor and pod axes, ``layout``, which places the
weights over the mesh (`models.sharding.param_spec`):

* ``fsdp_tp`` (the default): each matrix over `model` on its "parallel"
  dim and over the data axes on the other (ZeRO-3 with tensor
  parallelism), the optimizer moments alike;
* ``dp_only``: the model axis is one more data axis (`launch.mesh.
  pctx_for_mesh` appends it to ``dp_axes``), ``tp_size`` is 1, and the
  matrices are cut over every axis on their FSDP dim;
* ``tp_only``: over `model` alone (``fsdp_params`` is false), the
  serving layout;

and ``moe_dispatch``, the collective that carries tokens to their
experts when the experts are sharded over the model axis
(`models.moe.apply_moe`): ``rotor`` (`rotor_all_to_all`, the JAX
context's default), ``rotor_vlb`` (its two-hop Valiant form), ``xla``
(`core.comm.all_to_all`, one `dist.all_to_all_single`) or ``local``.
When `mesh` is None the models run on one process (`single_device_ctx`).
`train.trainer` and `train.opera_dp` read the axes.

The compute is GSPMD's partition of the JAX package's under these
rules (`models.sharding.computes_tp`): attention split by heads, the
FFNs and DeepSeek's shared experts by width, the mamba and RG-LRU
mixers by channels, the embedding and the head by vocab, each block
entered through `tp_enter` and left through `tp_exit` (Megatron's pair,
`core.comm`), so that its leaves are gathered over the data axes only
under ``fsdp_tp`` and not at all under ``tp_only``; every other leaf is
gathered whole on use.  Inside a mixer, a partial sum that every
rank's channels read whole is `tp_sum` (mamba's dt, B and C), and one
each rank reads its channels of is `tp_scatter` (the RG-LRU's gates).
Activations stay replicated over `model` at layer boundaries (the JAX
package's ``act_sharding="dp"``).  ROADMAP Queue 1 item 7c keeps what is
left: slots over `data`, the JAX context's ``grad_sync`` (the GSPMD
trainer's rotor pod branch) and ``act_sharding="sp"``.  Two of the JAX
context's fields have no counterpart: ``use_pallas`` (the port picks a
kernel or its plain version by the device of the tensors it is given,
kernels/__init__.py) and ``act_sharding``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.comm import (Mesh, copy_to_parallel,
                                   reduce_from_parallel, reduce_scatter,
                                   sum_to_parallel)

LAYOUTS = ("fsdp_tp", "dp_only", "tp_only")


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    mesh: Optional[Mesh] = None
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    pod_axis: Optional[str] = None          # set on multi-pod meshes
    moe_dispatch: str = "rotor"             # rotor | rotor_vlb | xla | local
    layout: str = "fsdp_tp"                 # fsdp_tp | dp_only | tp_only

    def __post_init__(self):
        if self.layout not in LAYOUTS:
            raise ValueError(f"layout {self.layout!r}: one of {LAYOUTS}")

    @property
    def tp_size(self) -> int:
        if self.mesh is None or self.layout == "dp_only":
            return 1
        return int(self.mesh.shape[self.tp_axis])

    @property
    def fsdp_params(self) -> bool:
        return self.layout != "tp_only"

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        return math.prod(self.mesh.shape[a] for a in self.dp_axes)

    @property
    def all_axes(self) -> Tuple[str, ...]:
        """``dp_axes + (tp_axis,)``, as the JAX property: under
        ``dp_only`` the model axis appears twice."""
        return tuple(self.dp_axes) + (self.tp_axis,)


def single_device_ctx(**kw) -> ParallelContext:
    return ParallelContext(mesh=None, **kw)


def tp_enter(x: torch.Tensor, tp: Optional[ParallelContext],
             mean: bool = False) -> torch.Tensor:
    """`x` entering a block split over ``tp``'s model axis (`core.comm.
    copy_to_parallel`); `x` itself when `tp` is None (a whole block)."""
    if tp is None:
        return x
    return copy_to_parallel(x, tp.mesh, tp.tp_axis, mean=mean)


def tp_exit(x: torch.Tensor, tp: Optional[ParallelContext]) -> torch.Tensor:
    """A split block's partial output summed over ``tp``'s model axis
    (`core.comm.reduce_from_parallel`); `x` itself when `tp` is None."""
    if tp is None:
        return x
    return reduce_from_parallel(x, tp.mesh, tp.tp_axis)


def tp_sum(x: torch.Tensor, tp: Optional[ParallelContext]) -> torch.Tensor:
    """A split block's partial `x` summed over ``tp``'s model axis for
    the block's own use, each rank reading the sum for its part alone,
    so that its cotangent is summed too (`core.comm.sum_to_parallel`);
    `x` itself when `tp` is None."""
    if tp is None:
        return x
    return sum_to_parallel(x, tp.mesh, tp.tp_axis)


def tp_scatter(x: torch.Tensor, tp: Optional[ParallelContext],
               dim: int) -> torch.Tensor:
    """A split block's partial `x` summed over ``tp``'s model axis, this
    rank's block of it along `dim` (`core.comm.reduce_scatter`); `x`
    itself when `tp` is None."""
    if tp is None:
        return x
    return reduce_scatter(x, tp.mesh, tp.tp_axis, dim)


def split_product(x: torch.Tensor, w: torch.Tensor,
                  tp: Optional[ParallelContext], combine) -> torch.Tensor:
    """``x @ w`` in x's dtype; with `tp`, x and w this rank's part of the
    summed dimension: the rank's partial product in float32, combined
    over ``tp``'s model axis by `combine` (`tp_exit`, `tp_sum`) in
    float32 and rounded once to x's dtype, as the whole product is."""
    if tp is None:
        return x @ w.to(x.dtype)
    return combine(x.float() @ w.float(), tp).to(x.dtype)

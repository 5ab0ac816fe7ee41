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

Every layout computes the same way: a layer gathers its weights whole
on use and its activations stay replicated over `model`
(`models.sharding.on_use`); the tensor-parallel compute that gives
``tp_only`` a plan without gathers is ROADMAP Queue 1 item 7c.  The JAX
context's ``grad_sync`` waits for the GSPMD trainer's rotor pod branch
(item 7c too).  Two of its fields have no counterpart: ``use_pallas``
(the port picks a kernel or its plain version by the device of the
tensors it is given, kernels/__init__.py) and ``act_sharding``
(sequence sharding over the model axis, item 7c).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.core.comm import Mesh

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

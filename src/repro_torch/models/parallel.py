"""Parallel context: the mesh, its axis names and the MoE dispatch.

Port of `repro.models.parallel`.  Carries the `core.comm.Mesh`, the
names of its data, tensor and pod axes, and ``moe_dispatch``, the
collective that carries tokens to their experts when the experts are
sharded over the model axis (`models.moe.apply_moe`): ``rotor``
(`rotor_all_to_all`, the JAX context's default), ``rotor_vlb`` (its
two-hop Valiant form), ``xla`` (`core.comm.all_to_all`, one
`dist.all_to_all_single`) or ``local``.  When `mesh` is None the models
run on one process (`single_device_ctx`).  `train.trainer` and
`train.opera_dp` read the axes.

The JAX context's ``grad_sync`` and ``layout`` (the dense weights'
FSDP / TP layouts) come with the paths that read them (ROADMAP Queue 1
item 7c).  Two of its fields have no counterpart: ``use_pallas`` (the
port picks a kernel or its plain version by the device of the tensors
it is given, kernels/__init__.py) and ``act_sharding`` (sequence
sharding over the model axis is a GSPMD layout, which the port does not
have).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

from repro_torch.core.comm import Mesh


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    mesh: Optional[Mesh] = None
    dp_axes: Tuple[str, ...] = ("data",)
    tp_axis: str = "model"
    pod_axis: Optional[str] = None          # set on multi-pod meshes
    moe_dispatch: str = "rotor"             # rotor | rotor_vlb | xla | local

    @property
    def tp_size(self) -> int:
        return 1 if self.mesh is None else int(self.mesh.shape[self.tp_axis])

    @property
    def dp_size(self) -> int:
        if self.mesh is None:
            return 1
        return math.prod(self.mesh.shape[a] for a in self.dp_axes)

    @property
    def all_axes(self) -> Tuple[str, ...]:
        return tuple(self.dp_axes) + (self.tp_axis,)


def single_device_ctx(**kw) -> ParallelContext:
    return ParallelContext(mesh=None, **kw)

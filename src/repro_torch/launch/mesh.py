"""Mesh construction over the `torch.distributed` world.

Port of `repro.launch.mesh`.  Single pod: 16x16 = 256 ranks, axes (data,
model).  Multi-pod: 2 pods x 256 = 512 ranks, axes (pod, data, model);
the `pod` axis is the rotor-scheduled inter-pod dimension.  Functions,
not module constants, so importing this module touches no process group.
"""
from __future__ import annotations

import math

import torch.distributed as dist

from repro_torch.core.comm import Mesh
from repro_torch.models.parallel import ParallelContext


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) over (data, model), or (2, 16, 16) over (pod, data, model);
    a ValueError naming the shape on a world of another size, as the JAX
    version fails without the devices."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if _world_size() != math.prod(shape):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{math.prod(shape)} ranks; the world has "
                         f"{_world_size()}")
    return Mesh(shape, axes)


def make_host_mesh(model: int = 1) -> Mesh:
    """(world // model, model) over (data, model): every rank of the world
    (one process without a process group)."""
    n = _world_size()
    return Mesh((n // model, model), ("data", "model"))


def pctx_for_mesh(mesh: Mesh, **kw) -> ParallelContext:
    """The context of `mesh`: data axes ``pod`` and ``data`` (``data``
    alone without a pod axis), and ``model`` after them under
    ``layout="dp_only"``; tensor axis ``model``; `kw` sets the other
    fields (``moe_dispatch``, ``layout``), as the JAX version takes
    them."""
    dp = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    if kw.get("layout") == "dp_only":
        dp = dp + ("model",)
    if "pod" in mesh.axis_names:
        return ParallelContext(mesh=mesh, dp_axes=dp, tp_axis="model",
                               pod_axis="pod", **kw)
    return ParallelContext(mesh=mesh, dp_axes=dp, tp_axis="model", **kw)

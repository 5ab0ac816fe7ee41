"""A device mesh with named axes over a `torch.distributed` world.

The port's counterpart of what the rotor collectives take from JAX: a
`jax.sharding.Mesh` with named axes, and `lax.axis_index`,
`lax.axis_size` and `lax.ppermute` inside a `shard_map`.  One process is
one rank (one shard); `Mesh(shape, axis_names)` lays the world's ranks
out row-major over `shape`, as JAX lays out a mesh's devices, and gives
each line of each axis a process group of its own.

`ppermute` moves a tensor along one axis by ``(src, dst)`` pairs of axis
indices, in one `dist.batch_isend_irecv`; a rank no pair sends to gets
zeros, as from `lax.ppermute`.  Under autograd it is differentiable as
`lax.ppermute` is: its backward sends the cotangent along the inverse
pairs, so a rank that sent nothing gets a zero gradient and what a rank
received from no one passes none.  `all_to_all` is `lax.all_to_all`
(split and concatenate on the leading axis, tiled) in one
`dist.all_to_all_single`, its own transpose; `all_reduce` sums a tensor
in place over the ranks that differ on some axes only (the data-parallel
gradient sum); `all_gather` makes a sharded weight whole over one or more
axes a dim, GSPMD's all-gather of an FSDP operand, and its backward is
`dist.reduce_scatter` (which gloo has too).  `copy_to_parallel` and
`reduce_from_parallel` are Megatron's pair around a tensor-parallel
block: the identity with the sum over an axis as its backward, before a
column-parallel product, and the sum with the identity as its backward,
after a row-parallel one; `all_reduce_max` is the maximum of a
logsumexp split over an axis, outside autograd.  A group whose backend
cannot take CUDA tensors (gloo) gets the payload staged through
page-locked host buffers that the mesh keeps, and what arrives is copied
back to the tensor's device; NCCL takes device tensors as they are.
Each mesh counts the bytes its rank sends and the host seconds its
exchanges take (`Mesh.sent_bytes`, `Mesh.wire_s`; through host memory
the wire's and the staging copies', with NCCL the enqueue's alone; an
all-reduce counts the 2 (n - 1) / n of its payload that a ring sends, an
all-gather or a reduce-scatter the (n - 1) blocks it sends).

`init_world` starts the world: from torchrun's environment, or from a
``file://`` store (`spawn_world`, which runs a function on N fresh
processes of one host).  NCCL where every rank has a card of its own;
gloo otherwise: on the CPU, or when ranks share a card (NCCL refuses
two ranks on one card).
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import DeviceLike, resolve_device

TIMEOUT_S = 600.0


@dataclasses.dataclass(frozen=True)
class World:
    """This process's place in the world, and the backend chosen."""
    rank: int
    size: int
    device: torch.device
    backend: str
    why: str


def _local(rank: int, size: int) -> Tuple[int, int]:
    """(local rank, local world size): torchrun's, else one host's."""
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", size)))


def init_world(device: DeviceLike = None, store: Optional[str] = None,
               rank: Optional[int] = None, size: Optional[int] = None,
               timeout_s: float = TIMEOUT_S) -> World:
    """Join the world: torchrun's (``env://``) when `store` is None, else
    the ``file://`` store at path `store` as rank `rank` of `size`, all on
    one host.  Picks this rank's device and the backend, prints the choice
    and its reason on rank 0, and returns it.  A world already joined is
    described as it is."""
    dev = resolve_device(device)
    method = f"file://{store}" if store is not None else "env://"
    if dist.is_initialized():
        rank, size = dist.get_rank(), dist.get_world_size()
    elif store is None:
        rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local, local_size = _local(rank, size)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if dev.type != "cuda":
        backend, why = "gloo", f"{dev.type} tensors"
    elif cards >= local_size:
        backend = "nccl"
        why = f"{local_size} ranks on {cards} cards: a card each"
        dev = torch.device("cuda", local)
    else:
        backend = "gloo"
        why = (f"{local_size} ranks share {cards} card(s) and NCCL refuses "
               "two ranks on one card: gloo, staged through host memory")
        dev = torch.device("cuda", local % cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=method, rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=timeout_s))
    backend = dist.get_backend()
    world = World(dist.get_rank(), dist.get_world_size(), dev, backend, why)
    if world.rank == 0:
        print(f"[world] {world.size} ranks, backend {backend} ({why})",
              flush=True)
    return world


class Mesh:
    """The world's ranks laid out row-major over `shape`, with named axes.

    ``shape`` maps each axis name to its size, as a JAX mesh's does.  Every
    rank creates every line's group, in one order (`dist.new_group` is
    collective); an axis of size 1 has no group and never exchanges."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str]):
        dims = tuple(int(s) for s in shape)
        if len(dims) != len(axis_names):
            raise ValueError(f"shape {dims} for axes {tuple(axis_names)}")
        size = dist.get_world_size() if dist.is_initialized() else 1
        if math.prod(dims) != size:
            raise ValueError(f"a mesh of shape {dims} needs "
                             f"{math.prod(dims)} ranks; the world has {size}")
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, dims))
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.coords = dict(zip(self.axis_names,
                               map(int, np.unravel_index(self.rank, dims))))
        self.groups: Dict[str, dist.ProcessGroup] = {}
        grid = np.arange(size).reshape(dims)
        for k, axis in enumerate(self.axis_names):
            if dims[k] == 1:
                continue
            for line in np.moveaxis(grid, k, -1).reshape(-1, dims[k]):
                group = dist.new_group(line.tolist())
                if self.rank in line:
                    self.groups[axis] = group
        # NCCL wants every rank of a group in its first call, and a
        # matching's fixed point sits out of the exchange: one all-reduce
        # a group first, axis by axis (the lines of an axis are disjoint)
        for group in self.groups.values():
            if dist.get_backend(group) == "nccl":
                dist.all_reduce(torch.zeros(1, device="cuda"), group=group)
        self.sent_bytes = 0
        self.wire_s = 0.0
        self._host = None

    def host_buffers(self, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(send, recv): page-locked host tensors of `x`'s shape and dtype
        that `ppermute` stages a CUDA tensor through, the same memory for
        every call (grown to the largest payload), so that no call
        allocates and faults in fresh pages and the copies run at the
        DMA engines' rate."""
        n = x.numel() * x.element_size()
        if self._host is None or self._host[0].numel() < n:
            self._host = [torch.empty(n, dtype=torch.uint8, pin_memory=True)
                          for _ in range(2)]
        return tuple(b[:n].view(x.dtype).view(x.shape) for b in self._host)


def axis_index(mesh: Mesh, axis: str) -> int:
    return mesh.coords[axis]


def axis_size(mesh: Mesh, axis: str) -> int:
    return mesh.shape[axis]


def _staged(group, t: torch.Tensor) -> bool:
    """Whether `t` goes through host memory: a CUDA tensor on a group
    whose backend takes none (gloo)."""
    return t.device.type == "cuda" and dist.get_backend(group) != "nccl"


def _exchange(x: torch.Tensor, mesh: Mesh, axis: str,
              pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """`ppermute`'s exchange, outside autograd."""
    me = axis_index(mesh, axis)
    to = [d for s, d in pairs if s == me]
    frm = [s for s, d in pairs if d == me]
    if not to and not frm:
        return torch.zeros_like(x)
    group = mesh.groups[axis]
    staged = _staged(group, x)
    if staged:   # the payload's producers, outside the wire's time
        torch.cuda.current_stream(x.device).synchronize()
    t0 = time.perf_counter()
    if staged:
        send, recv = mesh.host_buffers(x)
        send.copy_(x)
    else:
        send = x.contiguous()
        recv = torch.empty_like(send)
    ops = []
    if to:
        ops.append(dist.P2POp(dist.isend, send,
                              dist.get_global_rank(group, to[0]), group))
    if frm:
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, frm[0]), group))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if frm:
        out = recv.to(x.device) if staged else recv
    else:
        out = torch.zeros_like(x)
    mesh.wire_s += time.perf_counter() - t0
    if to:
        mesh.sent_bytes += send.numel() * send.element_size()
    return out


class _PPermute(torch.autograd.Function):
    """`lax.ppermute` and its transpose: the cotangent goes back along
    the inverse pairs."""

    @staticmethod
    def forward(ctx, x, mesh, axis, pairs):
        ctx.mesh, ctx.axis, ctx.pairs = mesh, axis, pairs
        return _exchange(x, mesh, axis, pairs)

    @staticmethod
    def backward(ctx, g):
        back = tuple((d, s) for s, d in ctx.pairs)
        return _exchange(g, ctx.mesh, ctx.axis, back), None, None, None


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             pairs: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """`lax.ppermute`: each ``(src, dst)`` pair of axis indices sends
    src's `x` to dst; what this rank receives, or zeros where no pair
    sends to it.  Each axis index is a source at most once and a
    destination at most once.  One `dist.batch_isend_irecv` a call, and
    one in the backward pass.  Every rank of the axis's line calls it,
    and its backward, in one order, as every collective."""
    pairs = tuple((int(s), int(d)) for s, d in pairs)
    return _PPermute.apply(x, mesh, axis, pairs)


def _all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    group = mesh.groups[axis]
    staged = _staged(group, x)
    if staged:
        torch.cuda.current_stream(x.device).synchronize()
    t0 = time.perf_counter()
    # the payload as bytes: each leading row is a whole chunk, whatever
    # the dtype (gloo's collectives take no bfloat16)
    flat = x.contiguous().view(torch.uint8).reshape(-1)
    if staged:
        send, recv = mesh.host_buffers(flat)
        send.copy_(flat)
    else:
        send, recv = flat, torch.empty_like(flat)
    dist.all_to_all_single(recv, send, group=group)
    out = recv.to(x.device) if staged else recv
    n = axis_size(mesh, axis)
    mesh.wire_s += time.perf_counter() - t0
    mesh.sent_bytes += send.numel() * (n - 1) // n
    return out.view(x.dtype).view(x.shape)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _all_to_all(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.mesh, ctx.axis), None, None


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """`lax.all_to_all(x, axis, 0, 0, tiled=True)` with leading dim n,
    the axis's size: row j of the result is row i (this rank's axis
    index) of rank j's `x`.  One `dist.all_to_all_single` over the axis's
    group, and one in the backward pass (the all-to-all is its own
    transpose)."""
    n = axis_size(mesh, axis)
    if x.shape[0] != n:
        raise ValueError(f"leading dim {x.shape[0]} != axis size {n}")
    if n == 1:
        return x
    return _AllToAll.apply(x, mesh, axis)


def all_reduce(x: torch.Tensor, mesh: Mesh, axes: Sequence[str],
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Sum `x` in place (or reduce it by `op`) over the ranks whose
    coordinates differ on `axes` only, as GSPMD sums a leaf's gradient
    over the axes it is replicated on: over the world's group when `axes`
    cover every axis of more than one rank, else axis by axis.  Returns
    `x`.  Not differentiable."""
    live = [a for a in dict.fromkeys(axes) if mesh.shape[a] > 1]
    if not live:
        return x
    whole = len(live) == sum(1 for s in mesh.shape.values() if s > 1)
    groups = [dist.group.WORLD] if whole else [mesh.groups[a] for a in live]
    for group in groups:
        n = dist.get_world_size(group)
        staged = _staged(group, x)
        if staged:
            torch.cuda.current_stream(x.device).synchronize()
        t0 = time.perf_counter()
        if staged:
            buf, _ = mesh.host_buffers(x)
            buf.copy_(x)
            dist.all_reduce(buf, op=op, group=group)
            x.copy_(buf)
        else:
            dist.all_reduce(x, op=op, group=group)
        mesh.wire_s += time.perf_counter() - t0
        mesh.sent_bytes += 2 * (n - 1) * x.numel() * x.element_size() // n
    return x


class _CopyToParallel(torch.autograd.Function):
    """Identity forward, the cotangents summed over the axis backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis, mean):
        ctx.mesh, ctx.axis, ctx.mean = mesh, axis, mean
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = all_reduce(g.contiguous().clone(), ctx.mesh, (ctx.axis,))
        if ctx.mean:
            g = g.div_(axis_size(ctx.mesh, ctx.axis))
        return g, None, None, None


class _ReduceFromParallel(torch.autograd.Function):
    """The sum over the axis forward, identity backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x.contiguous().clone(), mesh, (axis,))

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def copy_to_parallel(x: torch.Tensor, mesh: Mesh, axis: str,
                     mean: bool = False) -> torch.Tensor:
    """Megatron's entry into a tensor-parallel region, taken before a
    column-parallel product: `x` itself, every rank of the axis holding
    the same; under autograd its cotangent is the sum over the axis of
    every rank's (each rank's product reads its own columns), with
    `mean` divided by the axis's size.  One `dist.all_reduce` in the
    backward pass, none forward.  Every rank of the axis's line calls
    it, and its backward, in one order."""
    if axis_size(mesh, axis) == 1:
        return x
    return _CopyToParallel.apply(x, mesh, axis, mean)


def reduce_from_parallel(x: torch.Tensor, mesh: Mesh, axis: str
                         ) -> torch.Tensor:
    """Megatron's exit from a tensor-parallel region, taken after a
    row-parallel product: the sum over the axis of every rank's `x` (a
    new tensor); under autograd each rank's cotangent passes as it is.
    One `dist.all_reduce` forward, none backward."""
    if axis_size(mesh, axis) == 1:
        return x
    return _ReduceFromParallel.apply(x, mesh, axis)


class _SumToParallel(torch.autograd.Function):
    """The sum over the axis forward, the sum over the axis backward."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_reduce(x.contiguous().clone(), mesh, (axis,))

    @staticmethod
    def backward(ctx, g):
        return (all_reduce(g.contiguous().clone(), ctx.mesh, (ctx.axis,)),
                None, None)


def sum_to_parallel(x: torch.Tensor, mesh: Mesh, axis: str
                    ) -> torch.Tensor:
    """The sum over the axis of every rank's partial `x` (a new tensor),
    read inside a tensor-parallel region: each rank's use of the sum is
    its own part (mamba's dt, B and C feed the rank's channels alone), so
    under autograd its cotangent is the sum over the axis of every
    rank's too, where `reduce_from_parallel` passes it as it is.  One
    `dist.all_reduce` forward and one backward.  Every rank of the axis's
    line calls it, and its backward, in one order."""
    if axis_size(mesh, axis) == 1:
        return x
    return _SumToParallel.apply(x, mesh, axis)


def all_reduce_max(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The largest of every rank's `x` over the axis, elementwise, outside
    autograd (a new tensor): the running maximum of a logsumexp split
    over the axis, whose value the gradient does not depend on."""
    return all_reduce(x.detach().contiguous().clone(), mesh, (axis,),
                      op=dist.ReduceOp.MAX)


def _gather_axis(x: torch.Tensor, mesh: Mesh, axis: str, dim: int
                 ) -> torch.Tensor:
    """Every rank's `x` of the axis's line, concatenated along `dim` in
    axis order: one `dist.all_gather` of its bytes."""
    n = axis_size(mesh, axis)
    group = mesh.groups[axis]
    staged = _staged(group, x)
    if staged:
        torch.cuda.current_stream(x.device).synchronize()
    t0 = time.perf_counter()
    flat = x.contiguous().view(torch.uint8).reshape(-1)
    if staged:
        send, recv = mesh.host_buffers(flat.new_empty(n * flat.numel(),
                                                      device="meta"))
        send = send[:flat.numel()]
        send.copy_(flat)
    else:
        send, recv = flat, flat.new_empty(n * flat.numel())
    dist.all_gather(list(recv.view(n, -1).unbind(0)), send, group=group)
    out = recv.to(x.device) if staged else recv
    mesh.wire_s += time.perf_counter() - t0
    mesh.sent_bytes += (n - 1) * send.numel()
    out = out.view(x.dtype).view(n, *x.shape)
    return torch.cat(out.unbind(0), dim=dim) if dim else out.flatten(0, 1)


def _reduce_scatter_axis(g: torch.Tensor, mesh: Mesh, axis: str, dim: int
                         ) -> torch.Tensor:
    """`_gather_axis`' transpose: the sum over the axis's line of every
    rank's `g`, this rank's block of it along `dim`: one
    `dist.reduce_scatter`."""
    n = axis_size(mesh, axis)
    group = mesh.groups[axis]
    staged = _staged(group, g)
    if staged:
        torch.cuda.current_stream(g.device).synchronize()
    t0 = time.perf_counter()
    parts = torch.stack(g.chunk(n, dim=dim))   # the blocks, contiguous
    if staged:
        send, recv = mesh.host_buffers(parts)
        send.copy_(parts)
        recv = recv[0]
    else:
        send, recv = parts, torch.empty_like(parts[0])
    dist.reduce_scatter(recv, list(send.unbind(0)), group=group)
    out = recv.to(g.device) if staged else recv
    mesh.wire_s += time.perf_counter() - t0
    mesh.sent_bytes += (n - 1) * out.numel() * out.element_size()
    return out


class _AllGather(torch.autograd.Function):
    """`all_gather` and its transpose, the reduce-scatter, in float32."""

    @staticmethod
    def forward(ctx, x, mesh, cuts, dtype):
        ctx.mesh, ctx.cuts = mesh, cuts
        y = x.to(dtype)
        for dim, axes in cuts:
            for axis in reversed(axes):   # the minor axis first
                y = _gather_axis(y, mesh, axis, dim)
        return y

    @staticmethod
    def backward(ctx, g):
        dtype = g.dtype
        g = g.float()
        for dim, axes in reversed(ctx.cuts):
            for axis in axes:
                g = _reduce_scatter_axis(g, ctx.mesh, axis, dim)
        return g.to(dtype), None, None, None


def all_gather(x: torch.Tensor, mesh: Mesh,
               cuts: Sequence[Tuple[int, Sequence[str]]],
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The whole tensor of which `x` is this rank's block, as GSPMD
    gathers a sharded operand: for each ``(dim, axes)`` of `cuts`, `dim`
    is cut over `axes`, the first major (``P(("data", "model"))``'s
    order).  Cast to `dtype` (default `x`'s) before the wire.  Under
    autograd the backward is the reduce-scatter: each rank gets, in
    `x`'s dtype, the sum over the ranks of the gathered axes of their
    cotangents' blocks at its own coordinates, added in float32.  Every
    rank of each axis's lines calls it, and its backward, in one order."""
    cuts = tuple((int(d), tuple(a for a in axes if mesh.shape[a] > 1))
                 for d, axes in cuts)
    cuts = tuple((d, axes) for d, axes in cuts if axes)
    dtype = x.dtype if dtype is None else dtype
    if not cuts:
        return x.to(dtype)
    return _AllGather.apply(x, mesh, cuts, dtype)


class _ReduceScatter(torch.autograd.Function):
    """`_reduce_scatter_axis` and its transpose, the gather."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return _reduce_scatter_axis(x, mesh, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return (_gather_axis(g.contiguous(), ctx.mesh, ctx.axis, ctx.dim),
                None, None, None)


def reduce_scatter(x: torch.Tensor, mesh: Mesh, axis: str, dim: int
                   ) -> torch.Tensor:
    """The sum over the axis's line of every rank's `x`, this rank's
    block of it along `dim` (its axis index's, of ``x.shape[dim] / n``):
    GSPMD's reduce-scatter of a partial sum whose consumer is split over
    the axis.  Under autograd the backward is the all-gather of the
    blocks' cotangents along `dim`.  One `dist.reduce_scatter` forward
    and one `dist.all_gather` backward, staged through host memory as
    every collective here; every rank of the axis's line calls it, and
    its backward, in one order."""
    n = axis_size(mesh, axis)
    dim = dim % x.dim()
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide "
                         f"over {n} ranks")
    if n == 1:
        return x
    return _ReduceScatter.apply(x, mesh, axis, dim)


def _rank_main(fn: Callable, rank: int, size: int, store: str,
               device: DeviceLike, args: tuple, results) -> None:
    try:
        world = init_world(device, store=store, rank=rank, size=size)
        out = fn(world, *args)
        results.put((rank, True, out))
    except BaseException:   # reported to the parent, which fails the run
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_world(fn: Callable, size: int, *args, device: DeviceLike = None,
                timeout_s: float = TIMEOUT_S) -> List:
    """Run ``fn(world, *args)`` on `size` fresh processes (spawn) of this
    host, joined over a ``file://`` store in a temporary directory, and
    return each rank's result in rank order.  Each rank joins through
    `init_world(device)`: on the card unless `device` names another.
    `fn` and its arguments and results are pickled.  A rank that raises,
    dies or outlives `timeout_s` fails the run: every rank is stopped and
    RuntimeError raised with what the rank said."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    got: Dict[int, object] = {}
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, size, store, device, args, results))
                 for r in range(size)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failure = None
        try:
            while len(got) < size and failure is None:
                left = deadline - time.monotonic()
                if left <= 0:
                    failure = (f"ranks {sorted(set(range(size)) - set(got))} "
                               f"still running after {timeout_s:.0f} s")
                    break
                try:
                    rank, ok, out = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if r not in got and p.exitcode not in (None, 0)]
                    if dead:
                        failure = f"rank {dead[0][0]} exited with {dead[0][1]}"
                    continue
                if ok:
                    got[rank] = out
                else:
                    failure = f"rank {rank} failed:\n{out}"
        finally:
            for p in procs:
                if failure is not None and p.is_alive():
                    p.kill()
                p.join(timeout=30)
                if p.is_alive():
                    p.kill()
                    p.join()
    if failure is not None:
        raise RuntimeError(f"spawn_world({getattr(fn, '__name__', fn)}, "
                           f"{size}): {failure}")
    return [got[r] for r in range(size)]

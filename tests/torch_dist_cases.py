"""Shared cases of the port's multi-rank tests, and the code each rank runs.

tests/test_torch_collectives.py and tests/test_torch_opera_dp.py run
these cases through the port in `torch.distributed` worlds of gloo ranks
on the CPU, and through the JAX package on fake CPU devices in a
subprocess; tests/test_torch_gpu.py runs them on the card.  Imports no
JAX, and torch only inside the rank functions, so that the JAX
subprocess can read the cases.

Layouts: a world of 2 ranks on one `data` axis, of 3 (odd: every
matching has a fixed point), of 4, and of 4 as `pod` 2 x `data` 2,
ranks row-major.  Every rank draws every rank's input from the seed, so an
exact reference needs no communication.
"""
from __future__ import annotations

import hashlib
import zlib

import numpy as np

LAYOUTS = {"w2": ((2,), ("data",)),
           "w3": ((3,), ("data",)),
           "w4": ((4,), ("data",)),
           "p2d2": ((2, 2), ("pod", "data"))}
SHAPE = (5, 7)        # 35 elements: padded to a multiple of 2, 3 and 4
SMALL = (2, 3)        # a control-plane tensor for the expander cases
EVEN = (6, 20)        # 120 elements: no padding, for the wire bytes


def world_of(layout: str) -> int:
    return int(np.prod(LAYOUTS[layout][0]))


def cases(layout: str) -> list:
    """(name, function, axis or axes, keyword arguments, per-rank input
    shape); the compressed case takes two inputs (two steps)."""
    shape, axes = LAYOUTS[layout]
    sizes = dict(zip(axes, shape))
    out = []
    for axis in axes:
        n = sizes[axis]
        out += [
            (f"rs@{axis}", "rotor_reduce_scatter", axis, {}, SHAPE),
            (f"ag@{axis}", "rotor_all_gather", axis, {}, SHAPE),
            (f"ar@{axis}", "rotor_all_reduce", axis, {"mode": "rs_ag"},
             SHAPE),
            (f"ar_direct@{axis}", "rotor_all_reduce", axis,
             {"mode": "direct"}, SHAPE),
            (f"a2a@{axis}", "rotor_all_to_all", axis, {"vlb": False},
             (n, 3, 2)),
            (f"a2a_vlb@{axis}", "rotor_all_to_all", axis, {"vlb": True},
             (n, 3, 2)),
            (f"exp_ag@{axis}", "expander_all_gather", axis, {}, SMALL),
            (f"exp_psum@{axis}", "expander_psum_latency", axis, {}, SMALL),
        ]
    pod = "pod" if "pod" in axes else None
    out += [("hier", "hierarchical_rotor_all_reduce", ("data", pod), {},
             SHAPE),
            ("tree", "rotor_psum_tree", ("data", pod), {}, SHAPE),
            ("comp", "compressed_rotor_all_reduce", "data", {}, SHAPE)]
    return out


def case_names(layout: str) -> list:
    return [c[0] for c in cases(layout)]


def inputs(layout: str, name: str, shape) -> np.ndarray:
    """Every rank's input of case `name`, (world, *shape) float32; the
    compressed case's two steps, (2, world, *shape)."""
    rng = np.random.default_rng(zlib.crc32(f"{layout}/{name}".encode()))
    lead = (2,) if name == "comp" else ()
    return rng.normal(size=lead + (world_of(layout),) + tuple(shape)
                      ).astype(np.float32)


def tree_inputs(x: np.ndarray) -> dict:
    """The tree case's tree: the input and a (4,) leaf of its first row."""
    return {"a": x, "b": {"c": x.reshape(-1)[:4] * 2}}


def line(layout: str, rank: int, axis: str) -> list:
    """The ranks of `rank`'s line of `axis`, in axis order."""
    shape, axes = LAYOUTS[layout]
    grid = np.arange(int(np.prod(shape))).reshape(shape)
    coords = np.unravel_index(rank, shape)
    k = axes.index(axis)
    idx = list(coords)
    idx[k] = slice(None)
    return grid[tuple(idx)].tolist()


def exact(layout: str, name: str, rank: int) -> np.ndarray:
    """The float64 reference of case `name` at `rank` (psum, psum_scatter,
    all_gather or all_to_all over the case's ranks); None for the
    compressed case, which is held within a relative 0.05."""
    spec = {c[0]: c for c in cases(layout)}[name]
    _, fn, axis, kw, shape = spec
    x = inputs(layout, name, shape).astype(np.float64)
    if fn in ("hierarchical_rotor_all_reduce", "rotor_psum_tree"):
        total = x.sum(0)   # data, or pod x data: the whole world
        return tree_inputs(total) if fn == "rotor_psum_tree" else total
    if fn == "compressed_rotor_all_reduce":
        return None
    ranks = line(layout, rank, axis)
    i, n = ranks.index(rank), len(ranks)
    mine = x[ranks]
    if fn == "rotor_reduce_scatter":
        flat = mine.reshape(n, -1).sum(0)
        flat = np.concatenate([flat, np.zeros(-flat.size % n)])
        return flat.reshape(n, -1)[i]
    if fn in ("rotor_all_gather", "expander_all_gather"):
        return mine
    if fn in ("rotor_all_reduce", "expander_psum_latency"):
        return mine.sum(0)
    if fn == "rotor_all_to_all":
        return mine[:, i]
    raise KeyError(fn)


# ---------------- the port, on every rank ------------------------------------


def _digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def run_case(mesh, layout: str, spec, rank: int, device):
    """This rank's output of one case through the port (numpy), and the
    bytes it sent."""
    import torch

    from repro_torch.core import collectives as C

    name, fn, axis, kw, shape = spec
    x = inputs(layout, name, shape)
    sent = mesh.sent_bytes
    dev = torch.device(device)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    if fn == "compressed_rotor_all_reduce":
        t1, e1 = C.compressed_rotor_all_reduce(t(x[0, rank]), mesh, axis)
        q, scale = C.quantize(t(x[1, rank]) + e1)
        t2, e2 = C.compressed_rotor_all_reduce(t(x[1, rank]), mesh, axis,
                                               e1)
        out = {"total1": _np(t1), "err1": _np(e1), "total2": _np(t2),
               "err2": _np(e2), "q2": _np(q), "scale2": _np(scale)}
    elif fn == "rotor_psum_tree":
        tree = {"a": t(x[rank]), "b": {"c": t(tree_inputs(x[rank])["b"]["c"])}}
        got = C.rotor_psum_tree(tree, mesh, *axis)
        out = {"a": _np(got["a"]), "b": {"c": _np(got["b"]["c"])}}
    elif fn == "hierarchical_rotor_all_reduce":
        out = _np(C.hierarchical_rotor_all_reduce(t(x[rank]), mesh, *axis))
    else:
        out = _np(getattr(C, fn)(t(x[rank]), mesh, axis, **kw))
    return out, mesh.sent_bytes - sent


def collective_rank(world, layouts) -> dict:
    """Every case of each layout of this world through the port: {layout:
    {case: (output, bytes sent)}}, and the ppermute cases of a world of 3
    (``ppermute``: zeros where nothing is sent), and the wire bytes of
    rs_ag and direct on `EVEN` (``wire``)."""
    import torch

    from repro_torch.core import collectives as C
    from repro_torch.core.comm import Mesh, ppermute

    torch.set_num_threads(1)
    device = world.device
    meshes = {lay: Mesh(*LAYOUTS[lay]) for lay in layouts}
    out = {"backend": world.backend}
    for lay, mesh in meshes.items():
        out[lay] = {spec[0]: run_case(mesh, lay, spec, world.rank, device)
                    for spec in cases(lay)}
        x = torch.full(EVEN, float(world.rank + 1), device=device)
        wire = {}
        for mode in ("rs_ag", "direct"):
            before = mesh.sent_bytes
            C.rotor_all_reduce(x, mesh, "data", mode=mode)
            wire[mode] = (mesh.sent_bytes - before) / (x.numel() * 4)
        out[lay]["wire"] = wire
        if world.size == 3:
            x = torch.full((3,), float(world.rank + 1), device=device)
            out[lay]["ppermute"] = {
                "one_pair": _np(ppermute(x, mesh, "data", [(0, 1)])),
                "cycle": _np(ppermute(x, mesh, "data",
                                      [(0, 1), (1, 2), (2, 0)]))}
    return out


# ---------------- opera-dp --------------------------------------------------

# reduced smollm-360m as tests/distributed/check_sharded_train.py:37-39 (2
# layers, vocab 64), in its own head layout (hd 64, 3 query heads a KV
# head, tests/torch_arch_parity.py), float32
DP_CONFIG = dict(num_layers=2, vocab_size=64, num_heads=3, num_kv_heads=1,
                 head_dim=64, compute_dtype="float32")
DP_OPT = dict(lr=1e-4, warmup_steps=2, total_steps=10)
DP_DATA = dict(seq=32, batch=8, seed=0)
# (layout, compress, steps): the stored golden run is the first
DP_RUNS = [("p2d2", False, 3), ("p2d2", True, 2), ("w4", False, 2),
           ("w4", True, 2)]


def dp_config(kw: dict = DP_CONFIG):
    from repro_torch.configs.base import get_config, reduced_config

    return reduced_config(get_config("smollm-360m")).replace(**kw)


def dp_rank(world, flat, runs=DP_RUNS, config: dict = DP_CONFIG,
            opt: dict = DP_OPT, data: dict = DP_DATA) -> list:
    """Each run of `runs` through the port's opera-dp step from the JAX
    package's parameters `flat` ("a/b/c" keys), or with `flat` None the
    port's from seed 0 (drawn on the CPU): per step the metrics, a digest of this rank's
    parameters, rank 0's parameters and each rank's carried error (by the
    port's names), and the kernels' launches (on the card)."""
    import torch

    from repro_torch.core.comm import Mesh
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.kernels import launch_counts
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.convert import params_from_numpy, tree_from_flat
    from repro_torch.models.model import init_params
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.opera_dp import (init_opera_dp_state,
                                            make_opera_dp_train_step)

    torch.set_num_threads(1)
    device = world.device
    cfg = dp_config(config)
    meshes = {lay: Mesh(*LAYOUTS[lay]) for lay in dict.fromkeys(
        r[0] for r in runs)}
    src = SyntheticLM(cfg.vocab_size, data["seq"], data["batch"],
                      seed=data["seed"])
    out = []
    for layout, compress, steps in runs:
        pctx = pctx_for_mesh(meshes[layout])
        if flat is None:   # drawn on the CPU: the card draws other bits
            params = init_params(cfg, 0, device="cpu",
                                 masters=True).to(device)
        else:
            params = params_from_numpy(cfg, tree_from_flat(flat),
                                       device=device, masters=True)
        state = init_opera_dp_state(params, compress)
        step = make_opera_dp_train_step(cfg, pctx, AdamWConfig(**opt),
                                        compress)
        rows = []
        launch_counts.clear()
        for _, batch in zip(range(steps), device_batches(src, 0, device)):
            state, m = step(state, batch)
            p = {k: _np(v) for k, v in state["params"].named_parameters()}
            row = {"metrics": {k: float(v) for k, v in m.items()},
                   "digest": _digest(p)}
            if world.rank == 0:
                row["params"] = p
            if compress:
                row["err"] = {k: _np(v) for k, v in state["err"].items()}
            rows.append(row)
        out.append(dict(layout=layout, compress=compress, rows=rows,
                        launches=dict(launch_counts)))
    return out

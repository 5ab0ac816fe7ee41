"""Shared cases of the expert-parallel tests, and the code each rank runs.

tests/test_torch_expert_parallel.py runs these cases through the port on
a `torch.distributed` world of 4 gloo ranks on the CPU, and through the
JAX package on 4 fake CPU devices in a subprocess.  Imports no JAX, and
torch only inside the rank functions, so that the JAX subprocess can
read the cases.

Meshes: `data` 2 x `model` 2 (the expert-parallel layout) and `model` 4
(a lone axis of 4, whose matchings have fixed points), ranks row-major.
"""
from __future__ import annotations

import hashlib
import json
import zlib

import numpy as np

LAYOUTS = {"d2m2": ((2, 2), ("data", "model")),
           "m4": ((1, 4), ("data", "model"))}
WORLD = 4
SHAPE = (5, 7)        # padded where the schedule splits it
SMALL = (2, 3)        # a control-plane tensor, the expander's class
# (name, function of core.collectives, or "all_to_all" of core.comm,
# keyword arguments, per-rank shape with a leading axis-size dim as None)
COLLECTIVES = [
    ("a2a", "rotor_all_to_all", {"vlb": False}, (None, 3, 2)),
    ("a2a_vlb", "rotor_all_to_all", {"vlb": True}, (None, 3, 2)),
    ("xla_a2a", "all_to_all", {}, (None, 3, 2)),
    ("ar_direct", "rotor_all_reduce", {"mode": "direct"}, SHAPE),
    ("ag", "rotor_all_gather", {}, SHAPE),
    ("exp_psum", "expander_psum_latency", {}, SMALL),
]

# reduced MoE archs in float32, their reduced layout; S 16 takes the
# all-to-all branch on two model ranks, S 15 the local one
ARCHS = ("qwen3-moe-30b-a3b", "deepseek-moe-16b")
SEQS = (16, 15)
DISPATCHES = ("rotor", "rotor_vlb", "xla")
LOSS_BATCH = 4        # two rows a data rank
LOSS_SEED = 4

# the stored training run: reduced qwen3-moe, `make_train_step` at
# (data 2, model 2), rotor dispatch (lr as tests/test_torch_train.py's
# OPT keeps AdamW's normalised step below the 1e-5 it is held to)
EP_ARCH = "qwen3-moe-30b-a3b"
EP_OPT = dict(lr=1e-4, warmup_steps=2, total_steps=10)
EP_DATA = dict(seq=16, batch=8, seed=0)
EP_STEPS = 3
EP_MESH = "d2m2"


def axes_of(layout: str) -> list:
    shape, axes = LAYOUTS[layout]
    return [a for a, n in zip(axes, shape) if n > 1]


def coll_shape(layout: str, axis: str, shape) -> tuple:
    sizes = dict(zip(LAYOUTS[layout][1], LAYOUTS[layout][0]))
    return tuple(sizes[axis] if d is None else d for d in shape)


def coll_inputs(layout: str, name: str, fn: str, axis: str, shape):
    """Every rank's input and output cotangent, (WORLD, *shape) and
    (WORLD, *output shape) float32."""
    rng = np.random.default_rng(zlib.crc32(f"{layout}/{name}/{axis}".encode()))
    x = rng.normal(size=(WORLD,) + shape).astype(np.float32)
    if fn == "rotor_all_gather":   # (axis size, *shape)
        shape = coll_shape(layout, axis, (None,)) + shape
    return x, rng.normal(size=(WORLD,) + shape).astype(np.float32)


def loss_tokens(vocab: int, seq: int) -> tuple:
    """The global batch of a loss case: (tokens, targets), int32."""
    rng = np.random.default_rng(LOSS_SEED + seq)
    shape = (LOSS_BATCH, seq)
    return (rng.integers(0, vocab, shape).astype(np.int32),
            rng.integers(0, vocab, shape).astype(np.int32))


def port_config(arch: str):
    from repro_torch.configs.base import get_config, reduced_config

    return reduced_config(get_config(arch)).replace(compute_dtype="float32")


# ---------------- the port, on every rank ------------------------------------


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def _collectives(world, meshes) -> dict:
    """{layout: {case@axis: (output, input gradient)}} through the port,
    the gradient of <output, cotangent> by autograd."""
    import torch

    from repro_torch.core import collectives as C
    from repro_torch.core import comm

    out = {}
    for lay, mesh in meshes.items():
        out[lay] = {}
        for axis in axes_of(lay):
            for name, fn, kw, shape in COLLECTIVES:
                shape = coll_shape(lay, axis, shape)
                x, ct = coll_inputs(lay, name, fn, axis, shape)
                xt = torch.from_numpy(x[world.rank]).requires_grad_()
                f = comm.all_to_all if fn == "all_to_all" else getattr(C, fn)
                y = f(xt, mesh, axis, **kw)
                (g,) = torch.autograd.grad(y, xt,
                                           torch.from_numpy(ct[world.rank]))
                out[lay][f"{name}@{axis}"] = (_np(y), _np(g))
    return out


def _whole(grads: dict, cfg, pctx) -> dict:
    """Every rank's blocks made whole (a collective); numpy."""
    from repro_torch.models.sharding import gather_leaf

    return {k: _np(gather_leaf(k, g, cfg, pctx)) for k, g in grads.items()}


def _losses(world, meshes, jax_path: str) -> dict:
    """Each (arch, S, dispatch) case: this rank's loss_fn metrics, the
    summed gradient made whole (rank 0 only) and a digest of this rank's
    replicated leaves' gradients."""
    import torch

    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.convert import params_from_numpy, tree_from_flat
    from repro_torch.models.model import loss_fn
    from repro_torch.models.sharding import param_spec
    from repro_torch.train.trainer import shard_batch, sum_grads

    stored = dict(np.load(jax_path))
    out = {}
    for arch in ARCHS:
        cfg = port_config(arch)
        prefix = f"{arch}/param/"
        tree = tree_from_flat({k[len(prefix):]: v for k, v in stored.items()
                               if k.startswith(prefix)})
        for seq in SEQS:
            toks, tgts = loss_tokens(cfg.vocab_size, seq)
            for dispatch in DISPATCHES:
                pctx = pctx_for_mesh(meshes["d2m2"], moe_dispatch=dispatch)
                params = params_from_numpy(cfg, tree, device="cpu",
                                           masters=True, pctx=pctx)
                batch = shard_batch(
                    {"tokens": torch.from_numpy(toks).long(),
                     "targets": torch.from_numpy(tgts).long()}, pctx)
                total, metrics = loss_fn(params, batch, cfg, pctx)
                names, leaves = zip(*params.named_parameters())
                grads = dict(zip(names, torch.autograd.grad(
                    total, leaves, allow_unused=True,
                    materialize_grads=True)))
                grads, gnorm = sum_grads(grads, cfg, pctx)
                repl = {k: _np(g) for k, g in grads.items()
                        if not any(param_spec(k, g.shape, cfg, pctx))}
                whole = _whole(grads, cfg, pctx)
                row = {"metrics": {k: float(v.detach())
                                   for k, v in metrics.items()},
                       "gnorm": float(gnorm), "digest": _digest(repl),
                       "shapes": {k: tuple(g.shape) for k, g in
                                  grads.items()}}
                if world.rank == 0:
                    row["grads"] = whole
                out[(arch, seq, dispatch)] = row
    return out


def golden_steps(world, path: str, dispatch: str, mesh=None) -> dict:
    """The stored run's steps through the port's `make_train_step` on
    this rank, with `dispatch`: per step the metrics, the parameters made
    whole (rank 0 only) and `held` of this rank's own."""
    from torch_fsdp_cases import held

    from repro_torch.core.comm import Mesh
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.convert import params_from_numpy, tree_from_flat
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    stored = dict(np.load(path))
    cfg = port_config(EP_ARCH)
    spec = json.loads(str(stored["mesh"]))
    mesh = mesh or Mesh(spec["shape"], spec["axes"])
    pctx = pctx_for_mesh(mesh, moe_dispatch=dispatch)
    params = params_from_numpy(cfg, tree_from_flat(
        {k[len("param/"):]: v for k, v in stored.items()
         if k.startswith("param/")}), device=world.device, masters=True,
        pctx=pctx)
    state = init_train_state(cfg, params)
    step = make_train_step(cfg, pctx, AdamWConfig(**json.loads(str(
        stored["opt"]))))
    data = json.loads(str(stored["data"]))
    src = SyntheticLM(cfg.vocab_size, data["seq"], data["batch"],
                      seed=data["seed"])
    rows = []
    for _, batch in zip(range(len(stored["loss"])),
                        device_batches(src, 0, world.device)):
        state, m = step(state, batch)
        whole = _whole(dict(state["params"].named_parameters()), cfg, pctx)
        row = {"metrics": {k: float(v) for k, v in m.items()},
               "held": held(state["params"], cfg, pctx)}
        if world.rank == 0:
            row["params"] = whole
        rows.append(row)
    return {"rows": rows}


def _resume(world, ckpt_dir: str) -> dict:
    """The launcher at --tp 2 (gspmd): 4 steps straight, and 2 steps
    saved then resumed for 2 more; each run's parameters' digest on this
    rank, and the stored expert leaf's shape."""
    from repro_torch.launch.train import main

    base = ["--device", "cpu", "--reduced", "--arch", EP_ARCH, "--trainer",
            "gspmd", "--tp", "2", "--batch", "4", "--seq", "16",
            "--log-every", "100"]
    digests = {}

    def keep(tag):
        def on_step(step, state, metrics):
            digests[tag] = _digest({k: _np(p) for k, p in
                                    state["params"].named_parameters()})
        return on_step

    straight = main(base + ["--steps", "4"], on_step=keep("straight"))
    main(base + ["--steps", "2", "--ckpt-dir", ckpt_dir])
    resumed = main(base + ["--steps", "4", "--ckpt-dir", ckpt_dir,
                           "--resume"], on_step=keep("resumed"))
    out = {"digests": digests, "straight": straight["losses"],
           "resumed": resumed["losses"], "start": resumed["start_step"]}
    if world.rank == 0:
        with np.load(f"{ckpt_dir}/step_00000004/arrays.npz") as d:
            out["stored_shape"] = d["params/stack/0/moe/w_gate"].shape
            out["stored_m_shape"] = d["opt/m/stack/0/moe/w_up"].shape
    return out


def _round_trip(mesh) -> dict:
    """`shard_params` then `gather_params` of reduced qwen3-moe's whole
    tree (seed 0) at this rank's coordinates: the leaves cut, and whether
    every leaf came back with its bits."""
    import torch

    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.model import init_params
    from repro_torch.models.sharding import gather_params, shard_params

    cfg, pctx = port_config(EP_ARCH), pctx_for_mesh(mesh)
    params = init_params(cfg, 0, device="cpu", masters=True)
    before = {k: p.detach().clone() for k, p in params.named_parameters()}
    shard_params(params, cfg, pctx)
    cut = sorted(k for k, p in params.named_parameters()
                 if p.shape != before[k].shape)
    gather_params(params, cfg, pctx)
    after = dict(params.named_parameters())
    equal = sorted(after) == sorted(before) and all(
        torch.equal(after[k].detach(), v) and after[k].requires_grad
        for k, v in before.items())
    return {"cut": cut, "equal": equal}


def ep_rank(world, jax_path: str, golden_path: str, ckpt_dir: str) -> dict:
    """Everything the expert-parallel tests hold on this rank."""
    import torch

    from repro_torch.core.comm import Mesh

    torch.set_num_threads(1)
    meshes = {lay: Mesh(*LAYOUTS[lay]) for lay in LAYOUTS}
    return {"collectives": _collectives(world, meshes),
            "losses": _losses(world, meshes, jax_path),
            "golden": {d: golden_steps(world, golden_path, d,
                                       meshes[EP_MESH])
                       for d in DISPATCHES},
            "round_trip": _round_trip(meshes[EP_MESH]),
            "resume": _resume(world, ckpt_dir)}

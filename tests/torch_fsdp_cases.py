"""Shared cases of the FSDP / TP layout tests, and the code each rank runs.

tests/test_torch_fsdp.py runs these cases through the port on a
`torch.distributed` world of 4 gloo ranks on the CPU, and through the
JAX package on 4 fake CPU devices in a subprocess, on the mesh (data 2,
model 2), ranks row-major.  Imports no JAX, and torch only inside the
rank functions, so that the JAX subprocess can read the cases.
"""
from __future__ import annotations

import hashlib

import numpy as np

WORLD = 4
MESH = ((2, 2), ("data", "model"))
LAYOUTS = ("fsdp_tp", "dp_only", "tp_only")

# (arch, layout) of each loss case: reduced, float32, one of each family
LOSS_CASES = (("smollm-360m", "fsdp_tp"), ("qwen3-moe-30b-a3b", "fsdp_tp"),
              ("falcon-mamba-7b", "fsdp_tp"),
              ("recurrentgemma-2b", "fsdp_tp"), ("smollm-360m", "dp_only"),
              ("smollm-360m", "tp_only"))
LOSS_BATCH, LOSS_SEQ, LOSS_SEED = 4, 16, 5

# the stored training run: reduced smollm-360m in float32 from the port's
# seed-0 draws, at the launcher's settings for `LAUNCH` (its AdamW: lr
# 1e-4, which keeps the normalised step's f32 noise below the 1e-5 the
# parameters are held to; warmup max(3 // 20, 5); SyntheticLM from the
# seed), `make_train_step` at (data 2, model 2) under fsdp_tp
GOLDEN_ARCH = "smollm-360m"
GOLDEN_SEED = 0
GOLDEN_OPT = dict(lr=1e-4, warmup_steps=5, total_steps=3)
GOLDEN_DATA = dict(seq=16, batch=8, seed=0)
GOLDEN_STEPS = 3
KINDS = ("param", "m", "v")
LAUNCH = ["--device", "cpu", "--reduced", "--arch", GOLDEN_ARCH,
          "--trainer", "gspmd", "--tp", "2", "--steps", str(GOLDEN_STEPS),
          "--lr", str(GOLDEN_OPT["lr"]), "--batch", str(GOLDEN_DATA["batch"]),
          "--seq", str(GOLDEN_DATA["seq"]), "--seed", str(GOLDEN_SEED),
          "--log-every", "1"]


def port_config(arch: str):
    from repro_torch.configs.base import get_config, reduced_config

    return reduced_config(get_config(arch)).replace(compute_dtype="float32")


def loss_tokens(vocab: int) -> tuple:
    """The global batch of a loss case: (tokens, targets), int32."""
    rng = np.random.default_rng(LOSS_SEED)
    shape = (LOSS_BATCH, LOSS_SEQ)
    return (rng.integers(0, vocab, shape).astype(np.int32),
            rng.integers(0, vocab, shape).astype(np.int32))


def jax_key(name: str, cfg) -> tuple:
    """(the JAX package's flat key of the leaf the port's leaf `name`
    belongs to, as tests/torch_arch_parity.py's `_flat` writes it; the
    port leaf's index along its scan axis, or None)."""
    from repro_torch.models.plan import encoder_plan, jax_leaf, stack_plan

    key, n_scan = jax_leaf(name, cfg)
    if n_scan:
        stack, j, *rest = key
        plan = stack_plan(cfg) if stack == "stack" else encoder_plan(cfg)
        i = (int(name.split(".")[1]) - len(plan.prefix)) // len(plan.pattern)
        return "/".join([stack, "blocks", str(j), *rest]), i
    parts = name.split(".")
    if parts[0] in ("stack", "encoder") and len(parts) > 2:
        plan = stack_plan(cfg) if parts[0] == "stack" else encoder_plan(cfg)
        layer = int(parts[1])
        if layer < len(plan.prefix):
            where = ["prefix", str(layer)]
        else:
            where = ["tail", str(layer - len(plan.prefix)
                                 - plan.n_scan * len(plan.pattern))]
        return "/".join([parts[0], *where, *parts[2:]]), None
    return name.replace(".", "/"), None


def to_jax_flat(named: dict, cfg) -> dict:
    """The port's leaves by dotted name -> the JAX package's leaves by
    flat key, the scanned layers stacked."""
    out, stacked = {}, {}
    for name, arr in named.items():
        key, i = jax_key(name, cfg)
        if i is None:
            out[key] = arr
        else:
            stacked.setdefault(key, {})[i] = arr
    for key, parts in stacked.items():
        out[key] = np.stack([parts[i] for i in range(len(parts))])
    return out


def golden_params() -> dict:
    """The stored run's initial parameters: the port's seed-0 draws of
    reduced smollm-360m's float32 masters on the CPU (the launcher's
    first state), by the JAX package's flat keys."""
    from repro_torch.models.model import init_params

    cfg = port_config(GOLDEN_ARCH)
    params = init_params(cfg, GOLDEN_SEED, device="cpu", masters=True)
    return to_jax_flat({k: _np(p) for k, p in params.named_parameters()},
                       cfg)


# ---------------- the port, on every rank ------------------------------------


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _digest(arrays: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def held(params, cfg, pctx) -> dict:
    """{leaf: (this rank's coordinates on the axes the leaf is cut over,
    a digest of its block)}: two ranks of one key must hold one block."""
    from repro_torch.models.sharding import sharded_axes

    return {k: (tuple(pctx.mesh.coords[a]
                      for a in sharded_axes(k, p.shape, cfg, pctx)),
                _digest({k: _np(p)}))
            for k, p in params.named_parameters()}


def _tree(flat: dict, prefix: str) -> dict:
    from repro_torch.models.convert import tree_from_flat

    return tree_from_flat({k[len(prefix):]: v for k, v in flat.items()
                           if k.startswith(prefix)})


def _losses(world, mesh, jax_path: str) -> dict:
    """Each loss case: this rank's loss_fn metrics, the summed gradient
    made whole (rank 0 only), its global norm, and the shapes of this
    rank's blocks."""
    import torch

    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model import loss_fn
    from repro_torch.models.sharding import gather_leaf
    from repro_torch.train.trainer import _grads, shard_batch, sum_grads

    stored = dict(np.load(jax_path))
    out = {}
    for arch, layout in LOSS_CASES:
        cfg = port_config(arch)
        pctx = pctx_for_mesh(mesh, layout=layout)
        params = params_from_numpy(cfg, _tree(stored, f"{arch}/param/"),
                                   device="cpu", masters=True, pctx=pctx)
        toks, tgts = loss_tokens(cfg.vocab_size)
        batch = shard_batch({"tokens": torch.from_numpy(toks).long(),
                             "targets": torch.from_numpy(tgts).long()}, pctx)
        total, metrics = loss_fn(params, batch, cfg, pctx)
        grads, gnorm = sum_grads(_grads(params, total), cfg, pctx)
        whole = {k: _np(gather_leaf(k, g, cfg, pctx))
                 for k, g in grads.items()}
        row = {"metrics": {k: float(v.detach()) for k, v in metrics.items()},
               "gnorm": float(gnorm),
               "shapes": {k: tuple(p.shape)
                          for k, p in params.named_parameters()}}
        if world.rank == 0:
            row["grads"] = whole
        out[(arch, layout)] = row
    return out


def golden_steps(world, path: str, mesh) -> dict:
    """The stored run's steps through the port's `make_train_step` at
    fsdp_tp on this rank: per step the metrics, this rank's blocks of
    the parameters and both moments, and `held` of the parameters."""
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    stored = dict(np.load(path))
    cfg = port_config(GOLDEN_ARCH)
    pctx = pctx_for_mesh(mesh)
    params = params_from_numpy(cfg, _tree(stored, "param/"),
                               device=world.device, masters=True, pctx=pctx)
    state = init_train_state(cfg, params)
    step = make_train_step(cfg, pctx, AdamWConfig(**GOLDEN_OPT))
    src = SyntheticLM(cfg.vocab_size, GOLDEN_DATA["seq"],
                      GOLDEN_DATA["batch"], seed=GOLDEN_DATA["seed"])
    rows = []
    for _, batch in zip(range(GOLDEN_STEPS),
                        device_batches(src, 0, world.device)):
        state, m = step(state, batch)
        p = state["params"]
        rows.append({
            "metrics": {k: float(v) for k, v in m.items()},
            "blocks": {"param": {k: _np(v) for k, v in p.named_parameters()},
                       "m": {k: _np(v) for k, v in state["opt"]["m"].items()},
                       "v": {k: _np(v) for k, v in state["opt"]["v"].items()}},
            "held": held(p, cfg, pctx)})
    return {"rows": rows}


def _round_trip(mesh) -> dict:
    """`shard_params` then `gather_params` of reduced smollm-360m's and
    qwen3-moe's whole trees (seed 0) at this rank's coordinates, under
    each layout: the leaves cut, and whether every leaf came back with
    its bits."""
    import torch

    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.model import init_params
    from repro_torch.models.sharding import gather_params, shard_params

    out = {}
    for arch in (GOLDEN_ARCH, "qwen3-moe-30b-a3b"):
        cfg = port_config(arch)
        for layout in LAYOUTS:
            pctx = pctx_for_mesh(mesh, layout=layout)
            params = init_params(cfg, 0, device="cpu", masters=True)
            before = {k: p.detach().clone()
                      for k, p in params.named_parameters()}
            shard_params(params, cfg, pctx)
            cut = sorted(k for k, p in params.named_parameters()
                         if p.shape != before[k].shape)
            gather_params(params, cfg, pctx)
            after = dict(params.named_parameters())
            out[(arch, layout)] = {"cut": cut, "equal": sorted(after) == sorted(
                before) and all(torch.equal(after[k].detach(), v)
                                and after[k].requires_grad
                                for k, v in before.items())}
    return out


def _resume(world, ckpt_dir: str) -> dict:
    """The launcher as `LAUNCH` at 4 steps straight, and 2 steps saved
    then resumed for 2 more: each run's `held` on this rank after its
    last step, the losses, and the stored whole shapes."""
    import types

    from repro_torch.launch.train import main
    from repro_torch.models.parallel import ParallelContext

    shape, axes = MESH
    coords = dict(zip(axes, map(int, np.unravel_index(world.rank, shape))))
    pctx = ParallelContext(mesh=types.SimpleNamespace(
        shape=dict(zip(axes, shape)), coords=coords))
    cfg = port_config(GOLDEN_ARCH)
    base = LAUNCH[:LAUNCH.index("--steps")] + LAUNCH[
        LAUNCH.index("--steps") + 2:]
    got = {}

    def keep(tag):
        def on_step(step, state, metrics):
            got[tag] = held(state["params"], cfg, pctx)
        return on_step

    straight = main(base + ["--steps", "4"], on_step=keep("straight"))
    main(base + ["--steps", "2", "--ckpt-dir", ckpt_dir])
    resumed = main(base + ["--steps", "4", "--ckpt-dir", ckpt_dir,
                           "--resume"], on_step=keep("resumed"))
    out = {"held": got, "straight": straight["losses"],
           "resumed": resumed["losses"], "start": resumed["start_step"]}
    if world.rank == 0:
        with np.load(f"{ckpt_dir}/step_00000004/arrays.npz") as d:
            out["stored"] = {k: d[k].shape for k in d.files}
    return out


def fsdp_rank(world, jax_path: str, golden_path: str, ckpt_dir: str) -> dict:
    """Everything the FSDP tests hold on this rank."""
    import torch

    from repro_torch.core.comm import Mesh

    torch.set_num_threads(1)
    mesh = Mesh(*MESH)
    return {"coords": dict(mesh.coords),
            "losses": _losses(world, mesh, jax_path),
            "golden": golden_steps(world, golden_path, mesh),
            "round_trip": _round_trip(mesh),
            "resume": _resume(world, ckpt_dir)}

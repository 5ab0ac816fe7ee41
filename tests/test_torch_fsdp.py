"""The port's FSDP / TP layout and GSPMD trainer against the JAX package's.

The JAX package runs in a subprocess on 4 fake CPU devices (``XLA_FLAGS=
--xla_force_host_platform_device_count=4`` must be set before JAX is
imported), its cases compiled in parallel threads; the port on a
`torch.distributed` world of 4 gloo ranks on the CPU (`core.comm.
spawn_world`), over the cases of tests/torch_fsdp_cases.py, on the mesh
(data 2, model 2):

* placement, with no compute: for all ten configs at full width, under
  ``fsdp_tp``, ``dp_only`` and ``tp_only``, on (2, 2) and (16, 16)
  stand-in meshes (only ``.shape``), the port's spec of every leaf is the
  JAX package's `param_spec` of the JAX leaf it belongs to (a scanned
  leaf's without its scan axis), which puts ``final_norm``'s scale over
  `model` at widths of 4,096 and leaves the per-layer scales replicated;
* reduced smollm-360m, qwen3-moe-30b-a3b, falcon-mamba-7b and
  recurrentgemma-2b under ``fsdp_tp``, and smollm under ``dp_only`` and
  ``tp_only``, in float32: each rank's `loss_fn` on its rows against the
  JAX package's `loss_fn` with its parameters placed by
  `param_shardings` (the global cross-entropy the mean over the ranks, a
  MoE aux term each device's, rtol 1e-5), and every leaf's gradient (the
  ranks' blocks, reduce-scattered on use and summed by `train.trainer.
  sum_grads`, made whole) against `jax.grad` within 1e-4 of the leaf's
  largest value (tests/test_torch_train.py's GRAD_TOL);
* 3 steps of `make_train_step` under ``fsdp_tp`` against the JAX
  package's GSPMD `make_train_step` with parameters and moments placed
  as its launcher places them, stored in
  ``src/repro_torch/data/smollm_360m_reduced_fsdp_golden.npz`` for
  chip_smoke.py's ``fsdp_golden``: losses, gradient norms and lrs within
  rtol 1e-5; after each step each rank's blocks of the parameters and
  both moments against the JAX arrays' shards on the device of its
  coordinates, and against the stored whole arrays cut by
  `models.sharding.local_slice`, at atol/rtol 1e-5; no leaf that the
  rules shard held whole; the ranks that hold one block the same bits.
  The run starts from the port's seed-0 draws at the launcher's settings
  (`torch_fsdp_cases.LAUNCH`).  Regenerate it with ``JAX_PLATFORMS=cpu
  PYTHONPATH=src python tests/test_torch_fsdp.py`` (~20 s;
  `test_stored_fsdp_golden_is_current` fails when it is stale);
* `shard_params` / `gather_params` round-trip bit for bit under every
  layout, cutting the leaves `param_spec` shards; the launcher at
  ``--trainer gspmd --tp 2`` resumed from a checkpoint, which holds the
  whole tensors, ends in the bits of an uninterrupted run;
* the launcher under torchrun as `torch_fsdp_cases.LAUNCH` trains, in its
  config's bfloat16 compute, within bfloat16's tolerance of the stored
  float32 run (tests/torch_arch_parity.py's TOL);
* no fallback: on a mesh of one rank nothing is cut and the step is the
  single-process step bit for bit.
"""
import functools
import json
import os
import subprocess
import sys
import types
from pathlib import Path

if __name__ == "__main__":   # the JAX side, on fake CPU devices
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=4")

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_arch_parity as P
import torch_fsdp_cases as K
from repro.configs import get_config as j_get_config
from repro.models.model import init_params as j_init_params
from repro.models.model import loss_fn as j_loss_fn
from repro.models.model import param_shapes as j_param_shapes
from repro.models.parallel import ParallelContext as JParallelContext
from repro.models.sharding import param_spec as j_param_spec
from repro_torch.configs.base import get_config, list_archs
from repro_torch.core.comm import spawn_world
from repro_torch.models.convert import params_from_numpy, tree_from_flat
from repro_torch.models.model import param_shapes
from repro_torch.models.parallel import ParallelContext
from repro_torch.models.sharding import local_slice, param_spec

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = P.DATA / "smollm_360m_reduced_fsdp_golden.npz"
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-4     # of each leaf's largest gradient
METRICS = ("loss", "aux", "total")


def _key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


def _norm(spec) -> tuple:
    """A spec with a one-axis tuple entry written as the axis."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


# ---------------- the JAX package, in a subprocess ----------------------------


def _by_rank(arr, mesh) -> list:
    """An array's shards in rank order (the mesh's devices row-major)."""
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return [by_dev[d] for d in mesh.devices.reshape(-1)]


def loss_params(arch: str):
    """The JAX package's reduced f32 parameters of a loss case (seeded,
    constants perturbed, tests/torch_arch_parity.py)."""
    jcfg, _ = P.cfgs(arch, "float32", layout=False)
    return P.perturb(j_init_params(jcfg, jax.random.key(K.LOSS_SEED)),
                     K.LOSS_SEED)


def _placed(tree, shardings):
    return jax.device_put(tree, shardings)


def jax_outputs() -> dict:
    """Each loss case's parameters, per-device metrics and gradients
    through the JAX package's sharded `loss_fn` (the cases compiled in
    parallel threads)."""
    from concurrent.futures import ThreadPoolExecutor

    from jax.sharding import NamedSharding

    from repro import compat
    from repro.launch.mesh import make_host_mesh, pctx_for_mesh as j_pctx
    from repro.models.sharding import batch_spec, param_shardings

    mesh = make_host_mesh(model=K.MESH[0][1])
    out, cases = {}, []
    for arch, layout in K.LOSS_CASES:
        jcfg, _ = P.cfgs(arch, "float32", layout=False)
        pctx = j_pctx(mesh, layout=layout)
        params = loss_params(arch)
        out.update({f"{arch}/param/{k}": v
                    for k, v in P._flat(params).items()})
        toks, tgts = K.loss_tokens(jcfg.vocab_size)
        batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(
            mesh, batch_spec(k, v.shape, pctx)))
            for k, v in (("tokens", toks), ("targets", tgts))}
        placed = _placed(params, param_shardings(j_param_shapes(jcfg), jcfg,
                                                 pctx))
        cases.append((f"{arch}/{layout}", jcfg, pctx, placed, batch))

    def compiled(case):
        _, jcfg, pctx, params, batch = case
        with compat.set_mesh(mesh):
            return jax.jit(jax.value_and_grad(
                lambda p, b: j_loss_fn(p, b, jcfg, pctx),
                has_aux=True)).lower(params, batch).compile()

    with ThreadPoolExecutor(len(cases)) as pool:
        fns = list(pool.map(compiled, cases))
    for fn, (at, _, _, params, batch) in zip(fns, cases):
        (_, m), g = fn(params, batch)
        for k in METRICS:
            out[f"{at}/metric/{k}"] = np.stack(_by_rank(m[k], mesh))
        out.update({f"{at}/grad/{k}": v for k, v in P._flat(g).items()})
    return out


def jax_golden() -> tuple:
    """The JAX package's GSPMD `make_train_step` at (data 2, model 2) on
    reduced smollm-360m in f32, as its launcher runs it (parameters and
    moments placed by `param_shardings`, batches by `batch_spec`), from
    the port's seed-0 draws: (the stored run: each step's loss, gradient
    norm and lr, the parameters and both moments after it; each step's
    shards of them on every device, in rank order)."""
    from jax.sharding import NamedSharding

    from repro import compat
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.launch.mesh import make_host_mesh, pctx_for_mesh as j_pctx
    from repro.models.sharding import batch_spec, param_shardings
    from repro.optim.adamw import AdamWConfig as JAdamWConfig
    from repro.train.trainer import init_train_state as j_init_state
    from repro.train.trainer import make_train_step as j_make_train_step

    jcfg, _ = P.cfgs(K.GOLDEN_ARCH, "float32", layout=False)
    flat = K.golden_params()
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(flat[_key(path)]),
        j_param_shapes(jcfg))
    assert sorted(P._flat(params)) == sorted(flat)
    shape, axes = K.MESH
    mesh = make_host_mesh(model=shape[1])
    assert tuple(mesh.axis_names) == axes
    pctx = j_pctx(mesh)
    sh = param_shardings(j_param_shapes(jcfg), jcfg, pctx)
    step = jax.jit(j_make_train_step(jcfg, pctx,
                                     JAdamWConfig(**K.GOLDEN_OPT)))
    src = JSyntheticLM(jcfg.vocab_size, K.GOLDEN_DATA["seq"],
                       K.GOLDEN_DATA["batch"], seed=K.GOLDEN_DATA["seed"])
    stored = {"opt": np.array(json.dumps(K.GOLDEN_OPT, sort_keys=True)),
              "data": np.array(json.dumps(K.GOLDEN_DATA, sort_keys=True)),
              "mesh": np.array(json.dumps({"shape": list(shape),
                                           "axes": list(axes)}))}
    stored.update({f"param/{k}": v for k, v in flat.items()})
    shards, rows = {}, {"loss": [], "grad_norm": [], "lr": []}
    with compat.set_mesh(mesh):
        st = j_init_state(jcfg, params)
        state = {"params": _placed(st["params"], sh),
                 "opt": {"m": _placed(st["opt"]["m"], sh),
                         "v": _placed(st["opt"]["v"], sh),
                         "step": st["opt"]["step"]}}
        for i in range(K.GOLDEN_STEPS):
            batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(
                mesh, batch_spec(k, v.shape, pctx)))
                for k, v in src.batch_at(i).items()}
            state, m = step(state, batch)
            for k in rows:
                rows[k].append(float(m[k]))
            trees = dict(zip(K.KINDS, (state["params"], state["opt"]["m"],
                                       state["opt"]["v"])))
            for kind, tree in trees.items():
                for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
                    stored[f"after{i + 1}/{kind}/{_key(path)}"] = np.asarray(
                        a, np.float32)
                    for r, s in enumerate(_by_rank(a, mesh)):
                        shards[f"after{i + 1}/{r}/{kind}/{_key(path)}"] = s
    stored.update({k: np.asarray(v, np.float32) for k, v in rows.items()})
    return stored, shards


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX package's outputs, its training run now, its shards, each
    rank's port outputs): the JAX subprocess and the port's world run side
    by side, the port from the same parameters drawn here."""
    tmp = tmp_path_factory.mktemp("fsdp")
    jax_path, golden_path = tmp / "jax.npz", tmp / "golden.npz"
    shards_path, params_path = tmp / "shards.npz", tmp / "params.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen(
        [sys.executable, __file__, "--out", str(jax_path), str(golden_path),
         str(shards_path)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT)
    try:
        np.savez(params_path, **{
            f"{a}/param/{k}": v for a in dict(K.LOSS_CASES)
            for k, v in P._flat(loss_params(a)).items()})
        port = spawn_world(K.fsdp_rank, K.WORLD, str(params_path),
                           str(GOLDEN), str(tmp / "ckpt"), device="cpu",
                           timeout_s=400)
        _, err = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    jax_out = dict(np.load(jax_path))
    for k, v in np.load(params_path).items():   # the same draws
        np.testing.assert_array_equal(jax_out[k], v, err_msg=k)
    return jax_out, dict(np.load(golden_path)), dict(np.load(shards_path)), \
        port


@pytest.fixture(scope="module")
def jax_arrays(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port_out(runs):
    return runs[3]


# ---------------- placement, every config ------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_leaves(arch: str) -> list:
    """(path, shape) of every leaf of the JAX package's full `arch`."""
    return [(path, leaf.shape) for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                j_param_shapes(j_get_config(arch)))[0]]


def _contexts(layout: str, shape: tuple) -> tuple:
    """(the port's, the JAX package's) context of a stand-in mesh of
    `shape` over (data, model) with only ``.shape``, as `pctx_for_mesh`
    makes it under `layout`."""
    mesh = types.SimpleNamespace(shape=dict(zip(("data", "model"), shape)))
    dp = ("data", "model") if layout == "dp_only" else ("data",)
    return (ParallelContext(mesh=mesh, dp_axes=dp, layout=layout),
            JParallelContext(mesh=mesh, dp_axes=dp, layout=layout))


PLACEMENTS = [pytest.param(a, lay, m, id=f"{a}-{lay}-{m[0]}x{m[1]}")
              for a in list_archs() for lay in K.LAYOUTS
              for m in ((2, 2), (16, 16))]


@pytest.mark.parametrize("arch,layout,mesh", PLACEMENTS)
def test_every_leaf_is_placed_as_jax_param_spec(arch, layout, mesh):
    cfg, jcfg = get_config(arch), j_get_config(arch)
    pctx, jpctx = _contexts(layout, mesh)
    jshapes = {_key(path): shape for path, shape in _jax_leaves(arch)}
    jspecs = {_key(path): _norm(j_param_spec(path, shape, jcfg, jpctx))
              for path, shape in _jax_leaves(arch)}
    seen = set()
    for name, shape in param_shapes(cfg).items():
        key, i = K.jax_key(name, cfg)
        seen.add(key)
        want = jspecs[key][0 if i is None else 1:]
        assert tuple(jshapes[key][0 if i is None else 1:]) == shape, name
        assert param_spec(name, shape, cfg, pctx) == want, name
    assert seen == set(jspecs)


@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if get_config(a).d_model >= 4096])
def test_the_1d_rule_reads_the_jax_leaf(arch):
    """At d >= 4,096 `final_norm`'s scale is over `model` under fsdp_tp,
    and the per-layer norm scales, 1-D in the port and stacked in the JAX
    package, stay replicated."""
    cfg = get_config(arch)
    pctx, _ = _contexts("fsdp_tp", (2, 2))
    shapes = param_shapes(cfg)
    assert param_spec("final_norm.scale", shapes["final_norm.scale"], cfg,
                      pctx) == ("model",)
    scales = [n for n in shapes if n.startswith("stack.")
              and n.endswith(".scale") and len(shapes[n]) == 1
              and shapes[n][0] == cfg.d_model]
    assert scales and all(param_spec(n, shapes[n], cfg, pctx) == (None,)
                          for n in scales)


# ---------------- loss_fn and its gradients ----------------------------------


def _want(jax_arrays, prefix: str, arch: str) -> dict:
    tree = tree_from_flat({k[len(prefix):]: v for k, v in jax_arrays.items()
                           if k.startswith(prefix)})
    return {k: v.detach().numpy() for k, v in params_from_numpy(
        K.port_config(arch), tree, device="cpu",
        masters=True).named_parameters()}


@pytest.mark.parametrize("arch,layout", K.LOSS_CASES,
                         ids=[f"{a}-{lay}" for a, lay in K.LOSS_CASES])
def test_loss_and_every_grad_equal_jax(jax_arrays, port_out, arch, layout):
    rows = [r["losses"][(arch, layout)] for r in port_out]
    at = f"{arch}/{layout}/metric/"
    # the JAX package's cross-entropy is the global mean: every rank's
    # rows weigh the same
    np.testing.assert_allclose(np.mean([r["metrics"]["loss"] for r in rows]),
                               jax_arrays[at + "loss"], rtol=1e-5)
    cfg = K.port_config(arch)
    if cfg.moe is not None:   # each device's aux term, and its total
        aux = np.array([r["metrics"]["aux"] for r in rows])
        np.testing.assert_allclose(aux, jax_arrays[at + "aux"], rtol=1e-5)
        w = cfg.moe.router_aux_weight
        base = np.mean([r["metrics"]["total"] - w * r["metrics"]["aux"]
                        for r in rows])
        np.testing.assert_allclose(base + w * aux, jax_arrays[at + "total"],
                                   rtol=1e-5)
    want = _want(jax_arrays, f"{arch}/{layout}/grad/", arch)
    got = rows[0]["grads"]
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        scale = max(float(np.abs(want[name]).max()), 1e-30)
        np.testing.assert_allclose(g, want[name], rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale, err_msg=name)
    gnorm = np.sqrt(sum(np.sum(np.square(v, dtype=np.float64))
                        for v in want.values()))
    assert all(r["gnorm"] == rows[0]["gnorm"] for r in rows)
    np.testing.assert_allclose(rows[0]["gnorm"], gnorm, rtol=1e-5)
    # each rank holds its blocks, as `param_spec` cuts them
    whole = param_shapes(cfg)
    for r in port_out:
        pctx = _rank_ctx(r["coords"], layout)
        for name, shape in r["losses"][(arch, layout)]["shapes"].items():
            cut = local_slice(name, whole[name], cfg, pctx)
            assert shape == np.empty(whole[name], np.bool_)[cut].shape, name


def _rank_ctx(coords: dict, layout: str = "fsdp_tp") -> ParallelContext:
    """A rank's context at `coords` of a stand-in (data 2, model 2)."""
    shape, axes = K.MESH
    mesh = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                 coords=coords)
    dp = ("data", "model") if layout == "dp_only" else ("data",)
    return ParallelContext(mesh=mesh, dp_axes=dp, layout=layout)


# ---------------- the stored training run ------------------------------------


def test_stored_fsdp_golden_is_current(runs):
    stored, golden = dict(np.load(GOLDEN)), runs[1]
    assert sorted(stored) == sorted(golden)
    for key, want in golden.items():
        if want.dtype.kind == "f":
            np.testing.assert_allclose(stored[key], want, rtol=1e-6,
                                       atol=1e-7, err_msg=key)
        else:
            np.testing.assert_array_equal(stored[key], want, err_msg=key)
    assert GOLDEN.stat().st_size < 4 * 2**20


def _port_leaves(flat: dict, prefix: str, pctx=None) -> dict:
    tree = tree_from_flat({k[len(prefix):]: v for k, v in flat.items()
                           if k.startswith(prefix)})
    return {k: v.detach().numpy() for k, v in params_from_numpy(
        K.port_config(K.GOLDEN_ARCH), tree, device="cpu", masters=True,
        pctx=pctx).named_parameters()}


@pytest.mark.parametrize("i", range(K.GOLDEN_STEPS))
def test_train_steps_equal_the_stored_jax_run(runs, port_out, i):
    """Each rank's metrics and its blocks of the parameters and both
    moments after step i + 1 against the JAX arrays' shards on the device
    of its coordinates and the stored whole arrays' blocks."""
    stored, shards = dict(np.load(GOLDEN)), runs[2]
    cfg = K.port_config(K.GOLDEN_ARCH)
    whole = param_shapes(cfg)
    for rank, r in enumerate(port_out):
        row = r["golden"]["rows"][i]
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(row["metrics"][k], stored[k][i],
                                       rtol=1e-5, err_msg=k)
        pctx = _rank_ctx(r["coords"])
        for kind in K.KINDS:
            got = row["blocks"][kind]
            device = _port_leaves(shards, f"after{i + 1}/{rank}/{kind}/")
            cut = _port_leaves(stored, f"after{i + 1}/{kind}/", pctx)
            assert sorted(got) == sorted(device) == sorted(cut)
            for name, g in got.items():
                np.testing.assert_allclose(g, device[name], err_msg=name,
                                           **STEP_TOL)
                np.testing.assert_allclose(g, cut[name], err_msg=name,
                                           **STEP_TOL)
                if any(param_spec(name, whole[name], cfg, pctx)):
                    assert g.size < np.prod(whole[name]), (kind, name)


def test_the_ranks_of_a_block_hold_the_same_bits(port_out):
    """After every step the ranks with the same coordinates on the axes a
    leaf is cut over hold the same bits of it (of smollm at (2, 2) under
    fsdp_tp only the norm scales are replicated: every rank the same
    bits), and every rank reports the same metrics."""
    cfg = K.port_config(K.GOLDEN_ARCH)
    replicated = {n for n, s in param_shapes(cfg).items()
                  if not any(param_spec(n, s, cfg, _rank_ctx(
                      port_out[0]["coords"])))}
    assert replicated == {n for n in param_shapes(cfg)
                          if n.endswith(".scale")}
    for i in range(K.GOLDEN_STEPS):
        rows = [r["golden"]["rows"][i] for r in port_out]
        assert all(r["metrics"] == rows[0]["metrics"] for r in rows), i
        for name in rows[0]["held"]:
            blocks = {}
            for r in rows:
                coords, digest = r["held"][name]
                blocks.setdefault(coords, set()).add(digest)
            assert all(len(d) == 1 for d in blocks.values()), (i, name)
            assert len(blocks) == (1 if name in replicated else 4), name


# ---------------- sharding, checkpoints, the launcher -------------------------


@pytest.mark.parametrize("layout", K.LAYOUTS)
def test_shard_and_gather_round_trip(port_out, layout):
    for arch in (K.GOLDEN_ARCH, "qwen3-moe-30b-a3b"):
        cfg = K.port_config(arch)
        shapes = param_shapes(cfg)
        for r in port_out:
            rt = r["round_trip"][(arch, layout)]
            assert rt["equal"], (arch, r["coords"])
            pctx = _rank_ctx(r["coords"], layout)
            assert rt["cut"] == sorted(
                n for n, s in shapes.items()
                if any(param_spec(n, s, cfg, pctx))), (arch, layout)
            assert rt["cut"], (arch, layout)


def test_a_checkpoint_at_2x2_resumes_in_the_same_bits(port_out):
    cfg = K.port_config(K.GOLDEN_ARCH)
    r0 = port_out[0]["resume"]
    assert r0["start"] == 2
    shapes = param_shapes(cfg)
    for name, shape in shapes.items():   # whole tensors, as JAX's arrays
        key = name.replace(".", "/")
        assert r0["stored"][f"params/{key}"] == shape
        assert r0["stored"][f"opt/m/{key}"] == shape
    for r in port_out:
        res = r["resume"]
        assert res["resumed"] == res["straight"][2:]
        assert res["held"]["straight"] == res["held"]["resumed"]


def test_a_world_of_one_is_the_single_process_step():
    """On a mesh of one rank nothing is cut, and the layout's step is the
    single-process step bit for bit."""
    import torch

    from repro_torch.core.comm import Mesh
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.model import init_params
    from repro_torch.models.parallel import single_device_ctx
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    cfg = K.port_config(K.GOLDEN_ARCH)
    runs = []
    for pctx in (single_device_ctx(),
                 pctx_for_mesh(Mesh((1, 1), ("data", "model")))):
        params = init_params(cfg, 0, device="cpu", masters=True, pctx=pctx)
        assert all(p.shape == s for (_, p), s in zip(
            params.named_parameters(), param_shapes(cfg).values()))
        state = init_train_state(cfg, params)
        step = make_train_step(cfg, pctx, AdamWConfig(**K.GOLDEN_OPT))
        src = SyntheticLM(cfg.vocab_size, 16, 4, seed=0)
        rows = []
        for _, batch in zip(range(2), device_batches(src, 0, "cpu")):
            state, m = step(state, batch)
            rows.append({k: float(v) for k, v in m.items()})
        runs.append((rows, state))
    (a_rows, a), (b_rows, b) = runs
    assert a_rows == b_rows
    assert all(torch.equal(p, q) for p, q in zip(
        a["params"].parameters(), b["params"].parameters()))


@pytest.fixture(scope="module")
def torchrun_run(tmp_path_factory):
    """The launcher as `LAUNCH` under torchrun on 4 ranks, saving its
    last state: (returncode, stdout, stderr, checkpoint directory)."""
    ckpt = tmp_path_factory.mktemp("torchrun_ckpt")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train", *K.LAUNCH,
         "--ckpt-dir", str(ckpt)], capture_output=True, text=True, cwd=ROOT,
        env=env, timeout=300)
    return proc.returncode, proc.stdout, proc.stderr, ckpt


def test_launcher_trains_at_tp_2_under_torchrun(torchrun_run):
    rc, stdout, stderr, ckpt = torchrun_run
    assert rc == 0, stderr[-4000:]
    assert "[world] 4 ranks, backend gloo" in stdout
    assert "mesh {'data': 2, 'model': 2}, trainer=gspmd" in stdout
    assert stdout.count("[train] done: loss") == 1   # rank 0 alone
    stored = dict(np.load(GOLDEN))
    losses = [float(line.split(" loss ")[1].split()[0])
              for line in stdout.splitlines()
              if line.startswith("[train] step")]
    # bfloat16 compute (the config's) against the float32 run
    np.testing.assert_allclose(losses, stored["loss"], **P.TOL["bfloat16"])
    with np.load(ckpt / f"step_{K.GOLDEN_STEPS:08d}" / "arrays.npz") as d:
        saved = {k[len("params/"):]: d[k] for k in d.files
                 if k.startswith("params/")}
    cfg = K.port_config(K.GOLDEN_ARCH)
    want = K.to_jax_flat({n.replace("/", "."): v for n, v in saved.items()},
                         cfg)
    for key, w in want.items():
        np.testing.assert_allclose(
            w, stored[f"after{K.GOLDEN_STEPS}/param/{key}"], err_msg=key,
            **P.TOL["bfloat16"])


if __name__ == "__main__":
    if sys.argv[1:2] == ["--out"]:
        np.savez(sys.argv[2], **jax_outputs())
        golden, shards = jax_golden()
        np.savez(sys.argv[3], **golden)
        np.savez(sys.argv[4], **shards)
    else:
        np.savez(GOLDEN, **jax_golden()[0])
        print(f"wrote {GOLDEN.name}: {GOLDEN.stat().st_size} bytes",
              file=sys.stderr)

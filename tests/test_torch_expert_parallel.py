"""The port's expert-parallel MoE training against the JAX package's.

The JAX package runs in a subprocess on 4 fake CPU devices (``XLA_FLAGS=
--xla_force_host_platform_device_count=4`` must be set before JAX is
imported), the port on a `torch.distributed` world of 4 gloo ranks on
the CPU (`core.comm.spawn_world`), over the cases of
tests/torch_ep_cases.py:

* every differentiable collective (`rotor_all_to_all` with and without
  VLB, `comm.all_to_all` against `lax.all_to_all`, `rotor_all_reduce`
  direct, `rotor_all_gather`, `expander_psum_latency`) on each axis of a
  (data 2, model 2) mesh and of a lone model axis of 4: its output and
  its input gradient against the JAX collective's and `jax.vjp`'s,
  atol/rtol 1e-5;
* reduced qwen3-moe and deepseek-moe (shared experts, a dense first
  layer) in float32, the experts sharded over `model` at (data 2, model
  2), S 16 (the all-to-all branch) and S 15 (the local one): each rank's
  `loss_fn` against the JAX package's sharded `loss_fn` on the device of
  its coordinates (the aux term is each device's, rtol 1e-5; the global
  cross-entropy the mean over the data rows), and every leaf's gradient
  (the ranks' autograd summed by `train.trainer.sum_grads`, made whole)
  against `jax.grad` within 1e-4 of the leaf's largest value
  (tests/test_torch_train.py's GRAD_TOL); rotor, rotor_vlb and xla the
  same bits, and every rank the same bits of every replicated gradient;
* 3 steps of `train.trainer.make_train_step` at (data 2, model 2) with
  each dispatch against the JAX package's `make_train_step` (the GSPMD
  trainer with its launcher's parameter shardings), stored in
  ``src/repro_torch/data/qwen3_moe_30b_a3b_reduced_ep_golden.npz`` for
  chip_smoke.py's ``ep_golden``: losses, gradient norms and lrs within
  rtol 1e-5, the parameters after each step at atol/rtol 1e-5, every
  rank the same bits of the replicated leaves and the ranks that hold
  one block of a leaf the same bits of it.  Regenerate it with
  ``JAX_PLATFORMS=cpu
  PYTHONPATH=src python tests/test_torch_expert_parallel.py``
  (`test_stored_ep_golden_is_current` fails when it is stale);
* `models.sharding`: every leaf is placed as the JAX package's
  `param_spec` places its JAX leaf (the experts over `model` on E, the
  dense leaves by the FSDP / TP rules), and `shard_params` /
  `gather_params` round-trip bit for bit;
* the launcher at ``--trainer gspmd --tp 2``: a checkpoint holds the
  whole tensors, and a run resumed from it ends in the bits of an
  uninterrupted one; under torchrun, ``--trainer gspmd --tp 2`` and
  ``--trainer opera-dp --tp 2`` train;
* no fallback: a world of one rank is the single-process step bit for
  bit, and a mesh whose model axis does not divide the experts, or
  experts not cut to the rank's block, raise.
"""
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
import torch

import torch_arch_parity as P
import torch_ep_cases as K
import torch_fsdp_cases as FK
from repro.models.model import init_params as j_init_params
from repro.models.model import loss_fn as j_loss_fn
from repro.models.model import param_shapes as j_param_shapes
from repro.models.parallel import ParallelContext as JParallelContext
from repro.models.sharding import param_spec as j_param_spec
from repro_torch.core.comm import Mesh, spawn_world
from repro_torch.data.pipeline import SyntheticLM, device_batches
from repro_torch.launch.mesh import pctx_for_mesh
from repro_torch.models import moe as M
from repro_torch.models.convert import params_from_numpy, tree_from_flat
from repro_torch.models.model import init_params
from repro_torch.models.parallel import ParallelContext, single_device_ctx
from repro_torch.models.sharding import param_spec
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.trainer import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = P.DATA / "qwen3_moe_30b_a3b_reduced_ep_golden.npz"
TOL = dict(atol=1e-5, rtol=1e-5)
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-4     # of each leaf's largest gradient
METRICS = ("loss", "aux", "total")


# ---------------- the JAX package, in a subprocess ----------------------------


def _by_rank(arr, mesh) -> np.ndarray:
    """A sharded-map output's per-device values in rank order (the mesh's
    devices row-major)."""
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return np.stack([by_dev[d] for d in mesh.devices.reshape(-1)])


def loss_params(arch: str):
    """The JAX package's reduced f32 parameters of a loss case (seeded,
    constants perturbed, tests/torch_arch_parity.py)."""
    jcfg, _ = P.cfgs(arch, "float32", layout=False)
    return P.perturb(j_init_params(jcfg, jax.random.key(K.LOSS_SEED)),
                     K.LOSS_SEED)


def jax_outputs() -> dict:
    """The collectives' outputs and vjps, and each loss case's parameters,
    per-device metrics and gradients, through the JAX package (the loss
    cases compiled in parallel threads)."""
    from concurrent.futures import ThreadPoolExecutor

    from jax import lax
    from jax.sharding import PartitionSpec as PS

    from repro import compat
    from repro.core import collectives as JC
    from repro.launch.mesh import make_host_mesh, pctx_for_mesh as j_pctx

    out = {}
    for lay, (shape, axes) in K.LAYOUTS.items():
        mesh = compat.make_mesh(shape, axes, devices=jax.devices()[:K.WORLD])
        spec = PS(axes)
        for axis in K.axes_of(lay):
            for name, fn, kw, sh in K.COLLECTIVES:
                sh = K.coll_shape(lay, axis, sh)
                x, ct = K.coll_inputs(lay, name, fn, axis, sh)
                if fn == "all_to_all":
                    def body(a, axis=axis):
                        return lax.all_to_all(a[0], axis, 0, 0,
                                              tiled=True)[None]
                else:
                    def body(a, fn=fn, axis=axis, kw=kw):
                        return getattr(JC, fn)(a[0], axis, **kw)[None]
                f = compat.shard_map(body, mesh=mesh, in_specs=(spec,),
                                     out_specs=spec, check_vma=False)
                y, vjp = jax.vjp(jax.jit(f), jnp.asarray(x))
                (g,) = vjp(jnp.asarray(ct))
                out[f"coll/{lay}/{name}@{axis}/y"] = np.asarray(y)
                out[f"coll/{lay}/{name}@{axis}/g"] = np.asarray(g)

    mesh = make_host_mesh(model=2)
    pctx = j_pctx(mesh)
    cases = []
    for arch in K.ARCHS:
        jcfg, _ = P.cfgs(arch, "float32", layout=False)
        params = loss_params(arch)
        out.update({f"{arch}/param/{k}": v
                    for k, v in P._flat(params).items()})
        for seq in K.SEQS:
            toks, tgts = K.loss_tokens(jcfg.vocab_size, seq)
            batch = {"tokens": jnp.asarray(toks), "targets": jnp.asarray(tgts)}
            cases.append((f"{arch}/{seq}", jcfg, params, batch))

    def compiled(case):
        _, jcfg, params, batch = case
        with compat.set_mesh(mesh):
            return jax.jit(jax.value_and_grad(
                lambda p, b: j_loss_fn(p, b, jcfg, pctx),
                has_aux=True)).lower(params, batch).compile()

    with ThreadPoolExecutor(len(cases)) as pool:
        fns = list(pool.map(compiled, cases))
    for fn, (at, _, params, batch) in zip(fns, cases):
        (_, m), g = fn(params, batch)
        for k in METRICS:
            out[f"{at}/metric/{k}"] = _by_rank(m[k], mesh)
        out.update({f"{at}/grad/{k}": v for k, v in P._flat(g).items()})
    return out


def jax_golden() -> dict:
    """The JAX package's GSPMD `make_train_step` at (data 2, model 2) on
    reduced qwen3-moe in f32, as its launcher runs it (parameters and
    moments placed by `param_shardings`, batches by `batch_spec`): each
    step's loss, gradient norm and lr and the parameters after it."""
    from jax.sharding import NamedSharding

    from repro import compat
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.launch.mesh import make_host_mesh, pctx_for_mesh as j_pctx
    from repro.models.sharding import batch_spec, param_shardings
    from repro.optim.adamw import AdamWConfig as JAdamWConfig
    from repro.train.trainer import init_train_state as j_init_state
    from repro.train.trainer import make_train_step as j_make_train_step

    jcfg, _ = P.cfgs(K.EP_ARCH, "float32", layout=False)
    params = P.perturb(j_init_params(jcfg, jax.random.key(0)), 0)
    shape, axes = K.LAYOUTS[K.EP_MESH]
    mesh = make_host_mesh(model=shape[1])
    assert tuple(mesh.axis_names) == axes
    pctx = j_pctx(mesh)
    sh = param_shardings(j_param_shapes(jcfg), jcfg, pctx)
    step = jax.jit(j_make_train_step(jcfg, pctx, JAdamWConfig(**K.EP_OPT)))
    src = JSyntheticLM(jcfg.vocab_size, K.EP_DATA["seq"], K.EP_DATA["batch"],
                       seed=K.EP_DATA["seed"])
    out = {"opt": np.array(json.dumps(K.EP_OPT, sort_keys=True)),
           "data": np.array(json.dumps(K.EP_DATA, sort_keys=True)),
           "mesh": np.array(json.dumps({"shape": list(shape),
                                        "axes": list(axes)}))}
    out.update({f"param/{k}": v for k, v in P._flat(params).items()})
    rows = {"loss": [], "grad_norm": [], "lr": []}
    with compat.set_mesh(mesh):
        st = j_init_state(jcfg, params)
        state = {"params": jax.device_put(st["params"], sh),
                 "opt": {"m": jax.device_put(st["opt"]["m"], sh),
                         "v": jax.device_put(st["opt"]["v"], sh),
                         "step": st["opt"]["step"]}}
        for i in range(K.EP_STEPS):
            batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(
                mesh, batch_spec(k, v.shape, pctx)))
                for k, v in src.batch_at(i).items()}
            state, m = step(state, batch)
            for k in rows:
                rows[k].append(float(m[k]))
            out.update({f"after{i + 1}/{k}": v for k, v in
                        P._flat(state["params"]).items()})
    out.update({k: np.asarray(v, np.float32) for k, v in rows.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX package's outputs, its training run now, each rank's
    port outputs): the JAX subprocess and the port's world run side by
    side, the port from the same parameters drawn here."""
    tmp = tmp_path_factory.mktemp("ep")
    jax_path, golden_path = tmp / "jax.npz", tmp / "golden.npz"
    params_path = tmp / "params.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen(
        [sys.executable, __file__, "--out", str(jax_path), str(golden_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT)
    try:
        np.savez(params_path, **{f"{a}/param/{k}": v for a in K.ARCHS
                                 for k, v in P._flat(loss_params(a)).items()})
        port = spawn_world(K.ep_rank, K.WORLD, str(params_path), str(GOLDEN),
                           str(tmp / "ckpt"), device="cpu", timeout_s=400)
        _, err = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    jax_out = dict(np.load(jax_path))
    for k, v in np.load(params_path).items():   # the same draws
        np.testing.assert_array_equal(jax_out[k], v, err_msg=k)
    return jax_out, dict(np.load(golden_path)), port


@pytest.fixture(scope="module")
def jax_arrays(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port_out(runs):
    return runs[2]


# ---------------- the collectives' gradients ----------------------------------

COLL_CASES = [pytest.param(lay, f"{name}@{axis}", id=f"{lay}-{name}@{axis}")
              for lay in K.LAYOUTS for axis in K.axes_of(lay)
              for name, *_ in K.COLLECTIVES]


@pytest.mark.parametrize("lay,case", COLL_CASES)
def test_collective_and_its_gradient_equal_jax_vjp(jax_arrays, port_out, lay,
                                                   case):
    for rank, r in enumerate(port_out):
        y, g = r["collectives"][lay][case]
        np.testing.assert_allclose(
            y, jax_arrays[f"coll/{lay}/{case}/y"][rank], err_msg=case, **TOL)
        np.testing.assert_allclose(
            g, jax_arrays[f"coll/{lay}/{case}/g"][rank], err_msg=case, **TOL)


# ---------------- loss_fn and its gradients ----------------------------------

LOSS_CASES = [pytest.param(a, s, id=f"{a}-S{s}") for a in K.ARCHS
              for s in K.SEQS]


def _want_grads(jax_arrays, arch: str, seq: int) -> dict:
    prefix = f"{arch}/{seq}/grad/"
    tree = tree_from_flat({k[len(prefix):]: v for k, v in jax_arrays.items()
                           if k.startswith(prefix)})
    return {k: v.detach().numpy() for k, v in params_from_numpy(
        K.port_config(arch), tree, device="cpu",
        masters=True).named_parameters()}


@pytest.mark.parametrize("arch,seq", LOSS_CASES)
def test_loss_and_every_grad_equal_jax(jax_arrays, port_out, arch, seq):
    """Each rank's loss_fn against the JAX device of its coordinates, and
    the summed gradient against `jax.grad` of the sharded loss."""
    rows = [r["losses"][(arch, seq, "rotor")] for r in port_out]
    w = K.port_config(arch).moe.router_aux_weight
    at = f"{arch}/{seq}/metric/"
    aux = np.array([r["metrics"]["aux"] for r in rows])
    np.testing.assert_allclose(aux, jax_arrays[at + "aux"], rtol=1e-5)
    assert aux.min() > 0
    # the JAX package's cross-entropy is the global mean: the data rows'
    rows_ce = [rows[d * 2]["metrics"]["loss"] for d in range(2)]
    np.testing.assert_allclose(np.mean(rows_ce), jax_arrays[at + "loss"],
                               rtol=1e-5)
    # and its total that with each device's aux term
    base = np.mean([rows[d * 2]["metrics"]["total"] - w * aux[d * 2]
                    for d in range(2)])
    np.testing.assert_allclose(base + w * aux, jax_arrays[at + "total"],
                               rtol=1e-5)
    want = _want_grads(jax_arrays, arch, seq)
    got = rows[0]["grads"]
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        scale = max(float(np.abs(want[name]).max()), 1e-30)
        np.testing.assert_allclose(g, want[name], rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale, err_msg=name)
    routers = [k for k in got if k.endswith(".moe.router")]
    assert routers and all(np.abs(got[k]).max() > 0 for k in routers)
    gnorm = np.sqrt(sum(np.sum(np.square(v, dtype=np.float64))
                        for v in want.values()))
    np.testing.assert_allclose(rows[0]["gnorm"], gnorm, rtol=1e-5)


@pytest.mark.parametrize("arch,seq", LOSS_CASES)
def test_dispatches_and_replicas_give_the_same_bits(port_out, arch, seq):
    """rotor, rotor_vlb and xla move the same numbers; every rank holds
    the same gradient of every replicated leaf, and its own experts'."""
    for rank, r in enumerate(port_out):
        rows = [r["losses"][(arch, seq, d)] for d in K.DISPATCHES]
        assert all(x["metrics"] == rows[0]["metrics"] for x in rows), rank
        assert all(x["gnorm"] == rows[0]["gnorm"] for x in rows), rank
        assert len({x["digest"] for x in rows}) == 1, rank
    for d in K.DISPATCHES:
        assert len({r["losses"][(arch, seq, d)]["digest"]
                    for r in port_out}) == 1, d
    whole = [port_out[0]["losses"][(arch, seq, d)]["grads"]
             for d in K.DISPATCHES]
    for name, g in whole[0].items():
        assert all(np.array_equal(g, w[name]) for w in whole[1:]), name
    # each rank holds E / 2 experts
    E = K.port_config(arch).moe.num_experts
    shapes = port_out[0]["losses"][(arch, seq, "rotor")]["shapes"]
    experts = [v for k, v in shapes.items() if k.endswith(".moe.w_gate")]
    assert experts and all(v[0] == E // 2 for v in experts)


# ---------------- the stored training run ------------------------------------


def test_stored_ep_golden_is_current(runs):
    stored, golden = dict(np.load(GOLDEN)), runs[1]
    assert sorted(stored) == sorted(golden)
    for key, want in golden.items():
        if want.dtype.kind == "f":
            np.testing.assert_allclose(stored[key], want, rtol=1e-6,
                                       atol=1e-7, err_msg=key)
        else:
            np.testing.assert_array_equal(stored[key], want, err_msg=key)
    assert GOLDEN.stat().st_size < 4 * 2**20


STEP_CASES = [pytest.param(d, i, id=f"{d}-{i + 1}") for d in K.DISPATCHES
              for i in range(K.EP_STEPS)]


@pytest.mark.parametrize("dispatch,i", STEP_CASES)
def test_train_steps_equal_the_stored_jax_run(port_out, dispatch, i):
    stored = dict(np.load(GOLDEN))
    row = port_out[0]["golden"][dispatch]["rows"][i]
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(row["metrics"][k], stored[k][i],
                                   rtol=1e-5, err_msg=k)
    prefix = f"after{i + 1}/"
    want = params_from_numpy(K.port_config(K.EP_ARCH), tree_from_flat(
        {k[len(prefix):]: v for k, v in stored.items()
         if k.startswith(prefix)}), device="cpu", masters=True)
    got = row["params"]
    for name, w in want.named_parameters():
        np.testing.assert_allclose(got[name], w.detach().numpy(),
                                   err_msg=name, **STEP_TOL)


@pytest.mark.parametrize("dispatch", K.DISPATCHES)
def test_train_step_replicas_hold_the_same_bits(port_out, dispatch):
    """After every step the ranks that hold one block of a leaf (the same
    coordinates on the axes it is cut over: its experts' model coordinate
    and, where their D dim is cut over `data`, its data coordinate) hold
    the same bits of it, every rank the same replicated leaves, and every
    rank reports the same metrics."""
    cfg = K.port_config(K.EP_ARCH)
    n_moe = sum(1 for k in cfg.layer_kinds() if k == "moe")
    for i in range(K.EP_STEPS):
        rows = [r["golden"][dispatch]["rows"][i] for r in port_out]
        experts = 0
        for name in rows[0]["held"]:
            blocks = {}
            for r in rows:
                coords, digest = r["held"][name]
                blocks.setdefault(coords, set()).add(digest)
            assert all(len(d) == 1 for d in blocks.values()), (i, name)
            experts += name.split(".")[-1] in ("w_gate", "w_up", "w_down")
            assert len(blocks) > 1 or name.split(".")[-1] not in (
                "w_gate", "w_up", "w_down"), name
        assert experts == 3 * n_moe
        assert all(r["metrics"] == rows[0]["metrics"] for r in rows), i
    for i in range(K.EP_STEPS):
        got = [port_out[0]["golden"][d]["rows"][i]["params"]
               for d in K.DISPATCHES]
        mine = got[K.DISPATCHES.index(dispatch)]
        for name, v in got[0].items():
            assert np.array_equal(v, mine[name]), (i, name)


# ---------------- sharding, checkpoints, the launcher -------------------------


def test_the_leaves_cut_are_jax_param_spec_experts():
    """Every leaf the port places at (data 2, model 2) is placed as the
    JAX package's `param_spec` places the JAX leaf it belongs to (a
    scanned leaf's without its scan axis): the experts over `model` on
    their E dim and over `data` on their D dim, the dense leaves by the
    FSDP / TP rules, each layer's."""
    for arch in K.ARCHS:
        jcfg, _ = P.cfgs(arch, "float32", layout=False)
        cfg = K.port_config(arch)
        fake = types.SimpleNamespace(shape={"data": 2, "model": 2})
        jpctx = JParallelContext(mesh=fake)
        want = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                j_param_shapes(jcfg))[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            want[key] = tuple(e[0] if isinstance(e, tuple) and len(e) == 1
                              else e for e in j_param_spec(
                                  path, leaf.shape, jcfg, jpctx))
        pctx = ParallelContext(mesh=types.SimpleNamespace(
            shape={"data": 2, "model": 2}))
        params = init_params(cfg, 0, device="cpu")
        experts = 0
        for n, p in params.named_parameters():
            key, i = FK.jax_key(n, cfg)
            spec = param_spec(n, p.shape, cfg, pctx)
            assert spec == want[key][0 if i is None else 1:], (arch, n)
            if n.split(".")[-1] in ("w_gate", "w_up", "w_down") and \
                    ".moe." in n:
                assert spec[0] == "model", (arch, n)
                experts += 1
        n_moe = sum(1 for k in cfg.layer_kinds() if k == "moe")
        assert experts == 3 * n_moe, arch


def test_shard_and_gather_round_trip_and_the_checkpoint_resumes(port_out):
    r0 = port_out[0]
    assert r0["resume"]["start"] == 2
    E = K.port_config(K.EP_ARCH).moe.num_experts
    assert r0["resume"]["stored_shape"][0] == E
    assert r0["resume"]["stored_m_shape"][0] == E
    for r in port_out:
        assert r["resume"]["resumed"] == r["resume"]["straight"][2:]
        d = r["resume"]["digests"]
        assert d["straight"] == d["resumed"]
        assert r["round_trip"]["equal"], r["round_trip"]
        assert r["round_trip"]["cut"] == r0["round_trip"]["cut"]
    cfg = K.port_config(K.EP_ARCH)
    pctx = ParallelContext(mesh=types.SimpleNamespace(
        shape={"data": 2, "model": 2}))
    assert r0["round_trip"]["cut"] == sorted(
        n for n, p in init_params(cfg, 0, device="cpu").named_parameters()
        if any(param_spec(n, p.shape, cfg, pctx)))
    assert {"w_gate", "w_up", "w_down"} <= {
        n.split(".")[-1] for n in r0["round_trip"]["cut"]}


TRAINERS = ("gspmd", "opera-dp")


@pytest.fixture(scope="module")
def torchrun_runs():
    """The launcher at ``--tp 2`` under torchrun on 4 ranks, each trainer,
    the two worlds side by side: {trainer: (returncode, stdout, stderr)}."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = {t: subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--reduced", "--arch", K.EP_ARCH, "--steps",
         "2", "--trainer", t, "--tp", "2"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, cwd=ROOT, env=env)
        for t in TRAINERS}
    out = {}
    try:
        for t, proc in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            out[t] = (proc.returncode, stdout, stderr)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return out


@pytest.mark.parametrize("trainer", TRAINERS)
def test_launcher_trains_at_tp_2_under_torchrun(torchrun_runs, trainer):
    rc, stdout, stderr = torchrun_runs[trainer]
    assert rc == 0, stderr[-4000:]
    assert "[world] 4 ranks, backend gloo" in stdout
    assert f"mesh {{'data': 2, 'model': 2}}, trainer={trainer}" in stdout
    assert stdout.count("[train] done: loss") == 1   # rank 0 alone


# ---------------- no fallback ------------------------------------------------


def test_a_world_of_one_is_the_single_process_step():
    cfg = K.port_config(K.EP_ARCH)
    opt = AdamWConfig(**K.EP_OPT)
    runs = []
    for pctx in (single_device_ctx(),
                 pctx_for_mesh(Mesh((1, 1), ("data", "model")))):
        state = init_train_state(cfg, init_params(cfg, 0, device="cpu",
                                                  masters=True, pctx=pctx))
        step = make_train_step(cfg, pctx, opt)
        rows = []
        src = SyntheticLM(cfg.vocab_size, 16, 4, seed=0)
        for _, batch in zip(range(2), device_batches(src, 0, "cpu")):
            state, m = step(state, batch)
            rows.append({k: float(v) for k, v in m.items()})
        runs.append((rows, state))
    (a_rows, a), (b_rows, b) = runs
    assert a_rows == b_rows
    assert all(torch.equal(p, q) for p, q in zip(
        a["params"].parameters(), b["params"].parameters()))


def test_a_model_axis_never_falls_back_quietly():
    """tp 3 does not divide 8 experts, and whole experts on a rank of tp
    2 are not its block: both raise before any collective."""
    cfg = K.port_config(K.EP_ARCH)
    p = init_params(cfg, 0, device="cpu")["stack"][0]["moe"]
    x = torch.zeros(2, 4, cfg.d_model)
    for tp, match in ((3, "8 experts do not divide over tp 3"),
                      (2, "expected 4")):
        mesh = types.SimpleNamespace(shape={"data": 1, "model": tp},
                                     coords={"data": 0, "model": 0})
        with pytest.raises(ValueError, match=match):
            M.apply_moe(p, x, cfg, ParallelContext(mesh=mesh))
    with pytest.raises(ValueError, match="leading dim 3 != axis size 2"):
        from repro_torch.core.comm import all_to_all
        all_to_all(torch.zeros(3, 2), types.SimpleNamespace(
            shape={"model": 2}), "model")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--out"]:
        np.savez(sys.argv[2], **jax_outputs())
        np.savez(sys.argv[3], **jax_golden())
    else:
        np.savez(GOLDEN, **jax_golden())
        print(f"wrote {GOLDEN.name}: {GOLDEN.stat().st_size} bytes",
              file=sys.stderr)

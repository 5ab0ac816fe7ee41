"""The port's tensor-parallel compute over `model` against the JAX
package's GSPMD partition of its compute.

The JAX package runs in a subprocess on 4 fake CPU devices (``XLA_FLAGS=
--xla_force_host_platform_device_count=4`` must be set before JAX is
imported), its cases compiled in parallel threads; the port on a
`torch.distributed` world of 4 gloo ranks on the CPU (`core.comm.
spawn_world`), over the cases of tests/torch_tp_cases.py:

* the predicate, with no compute: for all ten configs at full width on
  `model` 2, 4 and 16, every leaf that `models.sharding.computes_tp`
  splits is cut over `model` on its split dim by the JAX package's
  `param_spec` (or is a bias the rules leave replicated, a q/k norm
  scale every head shares, or a mixer's conv, `D`, `dt_bias` or
  `lambda`, cut to the rank's channels on use), and every leaf of a
  splittable block that the rules cut over `model` splits (the mamba and
  RG-LRU mixers among them), but attention whose heads do not divide;
* reduced qwen1.5-110b (QKV bias, untied head), deepseek-moe-16b (shared
  experts, a dense first layer, experts over `model`) and
  seamless-m4t-large-v2 (encoder, cross-attention, the plain FFN's
  biases, perturbed) under ``fsdp_tp`` on (data 2, model 2),
  llama-3.2-vision-90b under ``tp_only`` on (data 2, model 2) and yi-9b
  under ``fsdp_tp`` on (data 1, model 4), where its 2 KV heads keep its
  attention whole, in float32: the global cross-entropy (the mean over
  the data ranks) and each device's aux term within rtol 1e-5 of the JAX
  package's sharded `loss_fn`, every leaf's gradient (the ranks' blocks
  summed by `train.trainer.sum_grads`, made whole) within 1e-4 of the
  leaf's largest value of `jax.grad`'s, the global norm within rtol
  1e-5, and no leaf that computes tensor-parallel gathered over `model`;
* 3 steps of `make_train_step` on reduced qwen1.5-110b under ``fsdp_tp``
  (stored in ``src/repro_torch/data/qwen15_110b_reduced_tp_golden.npz``
  for chip_smoke.py's ``tp_golden``) and under ``tp_only`` against the
  JAX package's GSPMD `make_train_step`: metrics within rtol 1e-5, each
  rank's blocks of the parameters and both moments at atol/rtol 1e-5 of
  the JAX arrays' shards on the device of its coordinates (and of the
  stored whole arrays' blocks), the ranks that hold one block the same
  bits.  Regenerate the stored run with ``JAX_PLATFORMS=cpu
  PYTHONPATH=src python tests/test_torch_tp.py``;
* the structure of one ``tp_only`` step of reduced smollm-360m on (data
  2, model 2): no gather at all, the sums over `model` the design's
  count, and `Mesh.sent_bytes` the design's bytes.
"""
import functools
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
import torch_fsdp_cases as FC
import torch_tp_cases as K
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
from repro_torch.models.sharding import computes_tp, local_slice, param_spec
from test_torch_fsdp import _by_rank, _key, _norm, _placed

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = P.DATA / "qwen15_110b_reduced_tp_golden.npz"
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-4     # of each leaf's largest gradient
METRICS = ("loss", "aux", "total")
CASE_IDS = [f"{a}-{lay}-{m}" for a, lay, m in K.LOSS_CASES]


# ---------------- the JAX package, in a subprocess ----------------------------


def _perturb_biases(params, seed: int):
    """`K.PERTURBED` leaves to 0.1 N(0, 1) from a numpy seed."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if str(getattr(path[-1], "key", "")) not in K.PERTURBED:
            return a
        return jnp.asarray(0.1 * rng.normal(size=a.shape), a.dtype)
    return jax.tree_util.tree_map_with_path(leaf, params)


def loss_params(arch: str):
    """The JAX package's reduced f32 parameters of a loss case (seeded,
    constants perturbed, the plain FFN's biases too)."""
    jcfg, _ = P.cfgs(arch, "float32", layout=False)
    params = P.perturb(j_init_params(jcfg, jax.random.key(K.LOSS_SEED)),
                       K.LOSS_SEED)
    return _perturb_biases(params, K.LOSS_SEED + 1)


def _mesh(name: str):
    from repro.launch.mesh import make_host_mesh

    shape, axes = K.MESHES[name]
    mesh = make_host_mesh(model=shape[1])
    assert tuple(mesh.axis_names) == axes and mesh.devices.shape == shape
    return mesh


def jax_outputs() -> dict:
    """Each loss case's parameters, per-device metrics and gradients
    through the JAX package's sharded `loss_fn` (the cases compiled in
    parallel threads)."""
    from concurrent.futures import ThreadPoolExecutor

    from jax.sharding import NamedSharding

    from repro import compat
    from repro.launch.mesh import pctx_for_mesh as j_pctx
    from repro.models.sharding import batch_spec, param_shardings

    out, cases = {}, []
    for arch, layout, mesh_name in K.LOSS_CASES:
        mesh = _mesh(mesh_name)
        jcfg, _ = P.cfgs(arch, "float32", layout=False)
        pctx = j_pctx(mesh, layout=layout)
        params = loss_params(arch)
        out.update({f"{arch}/param/{k}": v
                    for k, v in P._flat(params).items()})
        batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(
            mesh, batch_spec(k, v.shape, pctx)))
            for k, v in K.loss_batch(jcfg).items()}
        placed = _placed(params, param_shardings(j_param_shapes(jcfg), jcfg,
                                                 pctx))
        cases.append((f"{arch}/{layout}/{mesh_name}", mesh, jcfg, pctx,
                      placed, batch))

    def compiled(case):
        _, mesh, jcfg, pctx, params, batch = case
        with compat.set_mesh(mesh):
            return jax.jit(jax.value_and_grad(
                lambda p, b: j_loss_fn(p, b, jcfg, pctx),
                has_aux=True)).lower(params, batch).compile()

    with ThreadPoolExecutor(len(cases)) as pool:
        fns = list(pool.map(compiled, cases))
    for fn, (at, mesh, _, _, params, batch) in zip(fns, cases):
        (_, m), g = fn(params, batch)
        for k in METRICS:
            out[f"{at}/metric/{k}"] = np.stack(_by_rank(m[k], mesh))
        out.update({f"{at}/grad/{k}": v for k, v in P._flat(g).items()})
    return out


def jax_steps(layout: str) -> tuple:
    """The JAX package's GSPMD `make_train_step` on (data 2, model 2)
    under `layout` on reduced qwen1.5-110b in f32, as its launcher runs
    it (parameters and moments placed by `param_shardings`, batches by
    `batch_spec`), from the port's seed-0 draws: (the run: each step's
    loss, gradient norm and lr, the parameters and both moments after
    it; each step's shards of them on every device, in rank order)."""
    import json

    from jax.sharding import NamedSharding

    from repro import compat
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.launch.mesh import pctx_for_mesh as j_pctx
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
    mesh = _mesh(K.GOLDEN_MESH)
    shape, axes = K.MESHES[K.GOLDEN_MESH]
    pctx = j_pctx(mesh, layout=layout)
    sh = param_shardings(j_param_shapes(jcfg), jcfg, pctx)
    step = jax.jit(j_make_train_step(jcfg, pctx,
                                     JAdamWConfig(**K.GOLDEN_OPT)))
    src = JSyntheticLM(jcfg.vocab_size, K.GOLDEN_DATA["seq"],
                       K.GOLDEN_DATA["batch"], seed=K.GOLDEN_DATA["seed"])
    stored = {"opt": np.array(json.dumps(K.GOLDEN_OPT, sort_keys=True)),
              "data": np.array(json.dumps(K.GOLDEN_DATA, sort_keys=True)),
              "mesh": np.array(json.dumps({"shape": list(shape),
                                           "axes": list(axes)})),
              "layout": np.array(layout)}
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
                # placed as the port holds them: XLA may leave a step's
                # output sharded otherwise (a QKV bias by heads)
                tree = _placed(tree, sh)
                for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
                    stored[f"after{i + 1}/{kind}/{_key(path)}"] = np.asarray(
                        a, np.float32)
                    for r, s in enumerate(_by_rank(a, mesh)):
                        shards[f"after{i + 1}/{r}/{kind}/{_key(path)}"] = s
    stored.update({k: np.asarray(v, np.float32) for k, v in rows.items()})
    return stored, shards


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX package's loss outputs, its runs by layout, their shards
    by layout, each rank's port outputs): the JAX subprocess and the
    port's world run side by side, the port from the same parameters
    drawn here."""
    tmp = tmp_path_factory.mktemp("tp")
    jax_path, params_path = tmp / "jax.npz", tmp / "params.npz"
    paths = {lay: (tmp / f"{lay}.npz", tmp / f"{lay}_shards.npz")
             for lay in K.STEP_LAYOUTS}
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen(
        [sys.executable, __file__, "--out", str(jax_path),
         *(str(p) for lay in K.STEP_LAYOUTS for p in paths[lay])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=ROOT)
    try:
        np.savez(params_path, **{
            f"{a}/param/{k}": v for a in {c[0] for c in K.LOSS_CASES}
            for k, v in P._flat(loss_params(a)).items()})
        port = spawn_world(K.tp_rank, K.WORLD, str(params_path), str(GOLDEN),
                           device="cpu", timeout_s=400)
        _, err = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    jax_out = dict(np.load(jax_path))
    for k, v in np.load(params_path).items():   # the same draws
        np.testing.assert_array_equal(jax_out[k], v, err_msg=k)
    steps = {lay: dict(np.load(paths[lay][0])) for lay in K.STEP_LAYOUTS}
    shards = {lay: dict(np.load(paths[lay][1])) for lay in K.STEP_LAYOUTS}
    return jax_out, steps, shards, port


@pytest.fixture(scope="module")
def jax_arrays(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port_out(runs):
    return runs[3]


# ---------------- the predicate, every config ---------------------------------


@functools.lru_cache(maxsize=None)
def _jax_specs(arch: str, tp: int) -> dict:
    """{JAX flat key: its `param_spec` under fsdp_tp on a (2, tp)
    stand-in mesh}."""
    jcfg = j_get_config(arch)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": tp})
    jpctx = JParallelContext(mesh=mesh, dp_axes=("data",))
    return {_key(path): _norm(j_param_spec(path, leaf.shape, jcfg, jpctx))
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                j_param_shapes(jcfg))[0]}


PREDICATES = [pytest.param(a, tp, id=f"{a}-tp{tp}")
              for a in list_archs() for tp in (2, 4, 16)]
SPLIT_DIMS = {"wq": 1, "wk": 1, "wv": 1, "wo": 0, "w_gate": 1, "w_up": 1,
              "w_down": 0, "w_in": 1, "w_out": 0, "shared_gate": 1,
              "shared_up": 1, "shared_down": 0, "embed": 0, "lm_head": 1,
              # the mamba mixer by d_inner, the RG-LRU block by lru_width
              "in_proj": 1, "x_proj": 0, "dt_proj": 1, "out_proj": 0,
              "A_log": 0, "w_y": 1, "w_x": 1, "w_a": 0, "w_i": 0}


@pytest.mark.parametrize("arch,tp", PREDICATES)
def test_the_leaves_that_compute_tp_are_the_jax_rules_model_cuts(arch, tp):
    cfg = get_config(arch)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": tp},
                                 coords={"data": 0, "model": 0})
    pctx = ParallelContext(mesh=mesh)
    jspecs = _jax_specs(arch, tp)
    heads = cfg.num_heads % tp == 0 and cfg.num_kv_heads % tp == 0
    split = 0
    for name, shape in param_shapes(cfg).items():
        key, i = FC.jax_key(name, cfg)
        spec = jspecs[key][0 if i is None else 1:]
        assert param_spec(name, shape, cfg, pctx) == spec, name
        parts = name.split(".")
        block, leaf = (parts[-2] if len(parts) > 1 else ""), parts[-1]
        if block == "conv":   # a mixer's conv, named by its mixer
            block = parts[-3]
        dim = SPLIT_DIMS.get(leaf)
        in_block = (block in ("attn", "xattn", "ffn", "mixer", "rec")
                    or name == leaf
                    or (block == "moe" and leaf.startswith("shared_")))
        attn = block in ("attn", "xattn")
        if computes_tp(name, cfg, pctx):
            split += 1
            if dim is not None:
                assert spec[dim] == "model", name
            else:   # a bias under 4,096 wide, a q / k norm scale, or a
                # mixer's leaf cut to the rank's channels on use
                assert leaf in ("bq", "bk", "bv", "b_in", "q_norm",
                                "k_norm") or (
                    block in ("mixer", "rec")
                    and leaf in ("w", "b", "D", "dt_bias", "lambda")), name
            assert heads or not attn, name
        elif dim is not None and in_block and spec[dim] == "model":
            assert attn and not heads, name
    assert split


@pytest.mark.parametrize("arch,tp", [("smollm-360m", 2), ("yi-9b", 4),
                                     ("recurrentgemma-2b", 2)])
def test_no_mesh_or_dp_only_computes_nothing_split(arch, tp):
    cfg = get_config(arch)
    mesh = types.SimpleNamespace(shape={"data": 2, "model": tp},
                                 coords={"data": 0, "model": 0})
    for pctx in (ParallelContext(), ParallelContext(
            mesh=mesh, dp_axes=("data", "model"), layout="dp_only")):
        assert not any(computes_tp(n, cfg, pctx) for n in param_shapes(cfg))


@pytest.mark.parametrize("arch", ["yi-9b", "seamless-m4t-large-v2"])
def test_init_params_holds_every_leaf_as_its_block(arch):
    """At a width of 4,096 the 1-D rule cuts the final (and encoder) norm
    scale over `model`: a rank's draw keeps its block of it too, as of
    every other leaf, so that its gather on use makes it whole."""
    from repro_torch.configs.base import reduced_config
    from repro_torch.models.model import init_params

    cfg = reduced_config(get_config(arch)).replace(
        d_model=4096, num_layers=1, encoder_layers=1)
    whole = param_shapes(cfg)
    for rank in range(4):
        pctx = _rank_ctx(_coords(rank, "2x2"), "fsdp_tp", "2x2")
        params = init_params(cfg, 0, device="cpu", pctx=pctx)
        for name, p in params.named_parameters():
            want = np.empty(whole[name], np.bool_)[
                local_slice(name, whole[name], cfg, pctx)].shape
            assert tuple(p.shape) == want, name
        assert params.final_norm.scale.shape == (cfg.d_model // 2,)


# ---------------- loss_fn and its gradients ----------------------------------


def _want(jax_arrays, prefix: str, arch: str) -> dict:
    tree = tree_from_flat({k[len(prefix):]: v for k, v in jax_arrays.items()
                           if k.startswith(prefix)})
    return {k: v.detach().numpy() for k, v in params_from_numpy(
        K.port_config(arch), tree, device="cpu",
        masters=True).named_parameters()}


@pytest.mark.parametrize("arch,layout,mesh", K.LOSS_CASES, ids=CASE_IDS)
def test_loss_and_every_grad_equal_jax(jax_arrays, port_out, arch, layout,
                                       mesh):
    rows = [r["losses"][(arch, layout, mesh)] for r in port_out]
    at = f"{arch}/{layout}/{mesh}/metric/"
    dp = K.MESHES[mesh][0][0]
    # the global cross-entropy: the mean over the data ranks (every model
    # rank of a row reports the same)
    np.testing.assert_allclose(np.mean([r["metrics"]["loss"] for r in rows]),
                               jax_arrays[at + "loss"], rtol=1e-5)
    assert all(rows[k]["metrics"]["loss"] == rows[k - k % (4 // dp)][
        "metrics"]["loss"] for k in range(4))
    cfg = K.port_config(arch)
    if cfg.moe is not None:   # each device's aux term, and its total
        aux = np.array([r["metrics"]["aux"] for r in rows])
        np.testing.assert_allclose(aux, jax_arrays[at + "aux"], rtol=1e-5)
        w = cfg.moe.router_aux_weight
        base = np.mean([r["metrics"]["total"] - w * r["metrics"]["aux"]
                        for r in rows])
        np.testing.assert_allclose(base + w * aux, jax_arrays[at + "total"],
                                   rtol=1e-5)
    want = _want(jax_arrays, f"{arch}/{layout}/{mesh}/grad/", arch)
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


@pytest.mark.parametrize("arch,layout,mesh", K.LOSS_CASES, ids=CASE_IDS)
def test_no_tp_leaf_is_gathered_over_model(port_out, arch, layout, mesh):
    """The leaves that compute tensor-parallel are gathered over the data
    axes only (under tp_only not at all), and every other leaf the rules
    cut over `model` is gathered over it; yi-9b's attention on four model
    ranks is among the latter."""
    cfg = K.port_config(arch)
    whole = param_shapes(cfg)
    row0 = port_out[0]["losses"][(arch, layout, mesh)]
    tp = set(row0["tp"])
    assert tp
    attn = {n for n in whole if n.split(".")[-2:-1] in (["attn"],
                                                        ["xattn"])}
    if arch == "yi-9b":
        assert not attn & tp and {"embed", "lm_head"} <= tp
        assert any(".ffn." in n for n in tp)
    else:
        assert attn <= tp
    for r in port_out:
        row = r["losses"][(arch, layout, mesh)]
        assert row["tp"] == row0["tp"]
        over_model = {leaf for leaf, axis in row["gathered"]
                      if axis == "model"}
        assert not over_model & tp, sorted(over_model & tp)
        pctx = _rank_ctx(r["coords"], layout, mesh)
        cut = {n for n, s in whole.items()
               if "model" in param_spec(n, s, cfg, pctx)}
        expert = {n for n in cut if ".moe." in n
                  and n.split(".")[-1] in ("w_gate", "w_up", "w_down")}
        assert over_model == cut - tp - expert, sorted(
            over_model ^ (cut - tp - expert))
        if layout == "tp_only":
            assert not row["gathered"]


def _rank_ctx(coords: dict, layout: str, mesh: str) -> ParallelContext:
    """A rank's context at `coords` of a stand-in mesh."""
    shape, axes = K.MESHES[mesh]
    stand_in = types.SimpleNamespace(shape=dict(zip(axes, shape)),
                                     coords=coords)
    return ParallelContext(mesh=stand_in, layout=layout)


def _coords(rank: int, mesh: str) -> dict:
    shape, axes = K.MESHES[mesh]
    return dict(zip(axes, map(int, np.unravel_index(rank, shape))))


# ---------------- three steps, stored and not ---------------------------------


def test_stored_tp_golden_is_current(runs):
    stored, golden = dict(np.load(GOLDEN)), runs[1]["fsdp_tp"]
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


STEPS = [pytest.param(lay, i, id=f"{lay}-step{i + 1}")
         for lay in K.STEP_LAYOUTS for i in range(K.GOLDEN_STEPS)]


@pytest.mark.parametrize("layout,i", STEPS)
def test_train_steps_equal_jax(runs, port_out, layout, i):
    """Each rank's metrics and its blocks of the parameters and both
    moments after step i + 1 against the JAX arrays' shards on the device
    of its coordinates and the JAX run's whole arrays' blocks (under
    fsdp_tp the stored run's)."""
    run, shards = runs[1][layout], runs[2][layout]
    if layout == "fsdp_tp":
        run = dict(np.load(GOLDEN))
    cfg = K.port_config(K.GOLDEN_ARCH)
    whole = param_shapes(cfg)
    for rank, r in enumerate(port_out):
        row = r["steps"][layout]["rows"][i]
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(row["metrics"][k], run[k][i],
                                       rtol=1e-5, err_msg=k)
        pctx = _rank_ctx(r["coords"], layout, K.GOLDEN_MESH)
        for kind in K.KINDS:
            got = row["blocks"][kind]
            device = _port_leaves(shards, f"after{i + 1}/{rank}/{kind}/")
            cut = _port_leaves(run, f"after{i + 1}/{kind}/", pctx)
            assert sorted(got) == sorted(device) == sorted(cut)
            for name, g in got.items():
                np.testing.assert_allclose(g, device[name], err_msg=name,
                                           **STEP_TOL)
                np.testing.assert_allclose(g, cut[name], err_msg=name,
                                           **STEP_TOL)
                if any(param_spec(name, whole[name], cfg, pctx)):
                    assert g.size < np.prod(whole[name]), (kind, name)


@pytest.mark.parametrize("layout", K.STEP_LAYOUTS)
def test_the_ranks_of_a_block_hold_the_same_bits(port_out, layout):
    for i in range(K.GOLDEN_STEPS):
        rows = [r["steps"][layout]["rows"][i] for r in port_out]
        assert all(r["metrics"] == rows[0]["metrics"] for r in rows), i
        for name in rows[0]["held"]:
            blocks = {}
            for r in rows:
                coords, digest = r["held"][name]
                blocks.setdefault(coords, set()).add(digest)
            assert all(len(d) == 1 for d in blocks.values()), (i, name)


# ---------------- the structure of a tp_only step -----------------------------


def _design(cfg, rows: int, seq: int, tp: int, dp: int) -> tuple:
    """(the all-reduces over `model` that sum, their payload bytes, the
    bytes a rank sends) of one tp_only step of reduced smollm-360m, whose
    every leaf is `model`-split or replicated, so that nothing is
    gathered.  Forward: the embedding's sum, the attention's and the
    FFN's a layer, the logsumexp's sum of exponentials and gold logit
    (and its max, not counted here); the rematerialised layers again,
    each up to its last saved tensor (`RECOMPUTED_SUMS`); backward: the
    cotangents entering the attention and the FFN a layer and the head.
    Then `sum_grads`: each split leaf over `data`, each replicated norm
    scale over both axes at once, the squares of the split leaves over
    `model`; the three metrics over `data`.  A ring all-reduce of n ranks
    sends 2 (n - 1) / n of its payload."""
    act = rows * seq * cfg.d_model * 4
    tok = rows * seq * 4
    L = cfg.num_layers
    n_act = 1 + 2 * L + RECOMPUTED_SUMS * L + 2 * L + 1
    calls = n_act + 2 + 1
    model_bytes = n_act * act + 2 * tok + 4

    def ring(n, nbytes):
        return 2 * (n - 1) * nbytes // n

    shapes = param_shapes(cfg)
    sent = ring(tp, model_bytes) + ring(tp, tok)
    sent += sum(ring(dp, int(np.prod(s)) // tp * 4)
                for n, s in shapes.items() if not n.endswith(".scale"))
    sent += sum(ring(tp * dp, int(np.prod(s)) * 4)
                for n, s in shapes.items() if n.endswith(".scale"))
    sent += ring(dp, 3 * 4)
    return calls, model_bytes, sent


# a rematerialised layer's sums over `model` issued again in its
# recompute: the attention's, whose output the next norm saves; the
# FFN's output feeds no saved tensor, and the recompute stops before its
# sum (`torch.utils.checkpoint`'s early stop)
RECOMPUTED_SUMS = 1


def test_tp_only_step_structure(port_out):
    """No gather, no reduce-scatter; the sums over `model` the design's
    count and bytes; `Mesh.sent_bytes` the design's bytes; every rank
    the same census."""
    cfg = K.port_config(K.STRUCT_ARCH)
    shape, _ = K.MESHES[K.GOLDEN_MESH]
    dp, tp = shape
    rows = K.GOLDEN_DATA["batch"] // dp
    calls, model_bytes, sent = _design(cfg, rows, K.GOLDEN_DATA["seq"], tp,
                                       dp)
    s0 = port_out[0]["structure"]
    assert set(s0["tp"]) == {n for n in s0["shapes"]
                             if not n.endswith(".scale")}
    for r in port_out:
        s = r["structure"]
        assert s["calls"] == s0["calls"] and s["sent_bytes"] == s0["sent_bytes"]
        assert not s["gathered"]
        kinds = {k[0] for k in s["calls"]}
        assert kinds == {"all_reduce"}, kinds
        assert s["calls"][("all_reduce", "model", "SUM")] == calls
        assert s["calls"][("all_reduce", "model", "MAX")] == 1
        assert s["payload"][("all_reduce", "model", "SUM")] == model_bytes
        assert s["sent_bytes"] == sent
        # the kernel on this rank's heads, each layer and its recompute
        assert s["heads"] == {(cfg.num_heads // tp, cfg.num_kv_heads // tp):
                              2 * cfg.num_layers}


if __name__ == "__main__":
    if sys.argv[1:2] == ["--out"]:
        np.savez(sys.argv[2], **jax_outputs())
        for k, layout in enumerate(K.STEP_LAYOUTS):
            run, shards = jax_steps(layout)
            np.savez(sys.argv[3 + 2 * k], **run)
            np.savez(sys.argv[4 + 2 * k], **shards)
    else:
        np.savez_compressed(GOLDEN, **jax_steps("fsdp_tp")[0])
        print(f"wrote {GOLDEN.name}: {GOLDEN.stat().st_size} bytes",
              file=sys.stderr)

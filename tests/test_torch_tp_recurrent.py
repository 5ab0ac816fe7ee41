"""The port's mamba and RG-LRU mixers split by channels over `model`
against the JAX package's GSPMD partition of them.

The JAX package runs in 3 subprocesses on 4 fake CPU devices each
(``XLA_FLAGS=--xla_force_host_platform_device_count=4`` must be set
before JAX is imported), its cases handed out by their compile seconds
(`JOBS`); the port on a
`torch.distributed` world of 4 gloo ranks on the CPU (`core.comm.
spawn_world`), over the cases of tests/torch_tp_recurrent_cases.py:

* the blocks, with no compute: for falcon-mamba-7b and recurrentgemma-2b
  at full size on (data, model) stand-in meshes (1, 2), (1, 4) and (2,
  2), every mixer leaf computes tensor-parallel, and each rank's block
  of it is the JAX package's `param_spec` block, but mamba's ``in_proj``,
  whose block is the rank's x columns beside its z columns
  (`models.sharding.held_columns`); `init_params` and
  `params_from_numpy` given a mesh hold those blocks, `shard_params` /
  `gather_params` and a checkpoint's `shard_cut` round-trip them;
* reduced falcon-mamba and recurrentgemma in f32 under ``fsdp_tp`` on
  (2, 2) (on (1, 4) the first step below holds the gradients through
  its first moment), a recurrentgemma whose lru_width (66) and a
  falcon-mamba whose d_inner (134) do not divide tp 4 (their mixers
  computed whole), and qwen3-moe's expert-parallel branch with gelu and
  relu (ROADMAP Queue 3, F7): the global cross-entropy within rtol 1e-5
  of the JAX package's sharded `loss_fn`, every leaf's gradient (the
  ranks' blocks summed by `train.trainer.sum_grads`, made whole) within
  1e-4 of the leaf's largest value of `jax.grad`'s, the global norm
  within rtol 1e-5, and no mixer leaf gathered over `model` where the
  mixer splits;
* 3 steps of `make_train_step` under ``fsdp_tp`` on (1, 4) against the
  JAX package's GSPMD `make_train_step`: metrics within rtol 1e-5, each
  rank's blocks of the parameters and both moments at atol/rtol 1e-5 of
  the JAX arrays' shards on the device of its coordinates (stored for
  chip_smoke.py's ``tp_ssm_golden``), the ranks that hold one block the
  same bits;
* `forward_prefill` and three `forward_decode` steps on (1, 4) against
  the JAX functions under the same mesh context: logits within 1e-4,
  each conv / SSM / LRU state block within 1e-5 of the rank's
  `cache_spec` block of the JAX cache; a tick gathers no mixer leaf;
* `ServeEngine` on (1, 4), 4 slots, prompts of odd and even lengths:
  greedy tokens, every prefill's and tick's logits against the JAX
  engine on the same mesh (stored beside the steps).

Regenerate the stored runs
(``src/repro_torch/data/falcon_mamba_7b_reduced_tp_golden.npz``,
``recurrentgemma_2b_reduced_tp_golden.npz``) with ``JAX_PLATFORMS=cpu
PYTHONPATH=src python tests/test_torch_tp_recurrent.py``.
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

import torch_arch_parity as P
import torch_fsdp_cases as FC
import torch_tp_recurrent_cases as K
from repro.configs import get_config as j_get_config
from repro.models.model import forward_decode as j_forward_decode
from repro.models.model import forward_prefill as j_forward_prefill
from repro.models.model import init_params as j_init_params
from repro.models.model import loss_fn as j_loss_fn
from repro.models.model import param_shapes as j_param_shapes
from repro.models.parallel import ParallelContext as JParallelContext
from repro.models.sharding import param_spec as j_param_spec
from repro_torch.configs.base import get_config
from repro_torch.core.comm import spawn_world
from repro_torch.models.convert import params_from_numpy, tree_from_flat
from repro_torch.models.model import init_params, param_shapes
from repro_torch.models.parallel import ParallelContext
from repro_torch.models.sharding import (_block, cache_slice, computes_tp,
                                        held_columns, local_slice,
                                        param_spec)
from test_torch_fsdp import _by_rank, _key, _norm, _placed

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = {arch: P.DATA / K.golden_file(arch) for arch in K.ARCHS}
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = 1e-4     # of each leaf's largest gradient
LOSS_IDS = [c[0] for c in K.LOSS_CASES]


# ---------------- the JAX package, in a subprocess ----------------------------


def jax_config(arch: str, replace: tuple = ()):
    jcfg, _ = P.cfgs(arch, "float32", layout=False)
    return K.replaced(jcfg, replace)


def loss_params(arch: str, replace: tuple):
    """A loss case's JAX parameters: seeded, the constant-initialised
    leaves perturbed, the mixers' conv biases and `D` too, so that a
    bias added on every model rank, or a rank's channels of it read
    wrong, shows."""
    params = P.perturb(j_init_params(jax_config(arch, replace),
                                     jax.random.key(K.LOSS_SEED)),
                       K.LOSS_SEED)
    rng = np.random.default_rng(K.LOSS_SEED + 1)

    def leaf(path, a):
        name = str(getattr(path[-1], "key", ""))
        if name not in ("b", "D"):
            return a
        noise = 0.1 * rng.normal(size=a.shape).astype(np.float32)
        return jnp.asarray(noise + (1.0 if name == "D" else 0.0), a.dtype)
    return jax.tree_util.tree_map_with_path(leaf, params)


def _mesh(name: str):
    from repro.launch.mesh import make_host_mesh

    shape, axes = K.MESHES[name]
    mesh = make_host_mesh(model=shape[1])
    assert tuple(mesh.axis_names) == axes and mesh.devices.shape == shape
    return mesh


def golden_tree(arch: str):
    """The stored runs' weights as the JAX package's tree."""
    jcfg = jax_config(arch)
    flat = K.golden_params(arch)
    params = jax.tree_util.tree_map_with_path(
        lambda path, leaf: jnp.asarray(flat[_key(path)]),
        j_param_shapes(jcfg))
    assert sorted(P._flat(params)) == sorted(flat)
    return params


def jax_loss(cid: str) -> dict:
    """A loss case's parameters, per-device metrics and gradients through
    the JAX package's sharded `loss_fn`."""
    from jax.sharding import NamedSharding

    from repro import compat
    from repro.launch.mesh import pctx_for_mesh as j_pctx
    from repro.models.sharding import batch_spec, param_shardings

    _, arch, mesh_name, replace = K.LOSS[cid]
    mesh = _mesh(mesh_name)
    jcfg = jax_config(arch, replace)
    pctx = j_pctx(mesh)
    params = loss_params(arch, replace)
    out = {f"{cid}/param/{k}": v for k, v in P._flat(params).items()}
    toks, tgts = K.loss_tokens(jcfg.vocab_size)
    batch = {k: jax.device_put(jnp.asarray(v), NamedSharding(
        mesh, batch_spec(k, v.shape, pctx)))
        for k, v in (("tokens", toks), ("targets", tgts))}
    placed = _placed(params, param_shardings(j_param_shapes(jcfg), jcfg,
                                             pctx))
    with compat.set_mesh(mesh):
        (_, m), g = jax.jit(jax.value_and_grad(
            lambda p, b: j_loss_fn(p, b, jcfg, pctx),
            has_aux=True))(placed, batch)
    out.update({f"{cid}/metric/{k}": np.stack(_by_rank(m[k], mesh))
                for k in ("loss", "aux", "total")})
    out.update({f"{cid}/grad/{k}": v for k, v in P._flat(g).items()})
    return out


def jax_steps(arch: str, mesh_name: str) -> tuple:
    """The JAX package's GSPMD `make_train_step` of reduced `arch` in f32
    under fsdp_tp on `mesh_name`, as its launcher runs it, from the
    stored weights: (the run: opt, data, mesh, the weights, each step's
    loss, gradient norm and lr, the parameters and both moments after
    it; each step's shards of them on every device, in rank order)."""
    from jax.sharding import NamedSharding

    from repro import compat
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.launch.mesh import pctx_for_mesh as j_pctx
    from repro.models.sharding import batch_spec, param_shardings
    from repro.optim.adamw import AdamWConfig as JAdamWConfig
    from repro.train.trainer import init_train_state as j_init_state
    from repro.train.trainer import make_train_step as j_make_train_step

    jcfg = jax_config(arch)
    params = golden_tree(arch)
    mesh = _mesh(mesh_name)
    shape, axes = K.MESHES[mesh_name]
    pctx = j_pctx(mesh)
    sh = param_shardings(j_param_shapes(jcfg), jcfg, pctx)
    opt = K.golden_opt(arch)
    step = jax.jit(j_make_train_step(jcfg, pctx, JAdamWConfig(**opt)))
    src = JSyntheticLM(jcfg.vocab_size, K.GOLDEN_DATA["seq"],
                       K.GOLDEN_DATA["batch"], seed=K.GOLDEN_DATA["seed"])
    stored = {"opt": np.array(json.dumps(opt, sort_keys=True)),
              "data": np.array(json.dumps(K.GOLDEN_DATA, sort_keys=True)),
              "mesh": np.array(json.dumps({"shape": list(shape),
                                           "axes": list(axes)})),
              "layout": np.array("fsdp_tp")}
    stored.update({f"param/{k}": v
                   for k, v in P._flat(params).items()})
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
                tree = _placed(tree, sh)
                for path, a in jax.tree_util.tree_flatten_with_path(tree)[0]:
                    stored[f"after{i + 1}/{kind}/{_key(path)}"] = np.asarray(
                        a, np.float32)
                    for r, s in enumerate(_by_rank(a, mesh)):
                        shards[f"after{i + 1}/{r}/{kind}/{_key(path)}"] = s
    stored.update({k: np.asarray(v, np.float32) for k, v in rows.items()})
    return stored, shards


def jax_forward(arch: str) -> dict:
    """`forward_prefill` and `DECODE_STEPS` `forward_decode` steps of the
    stored weights under the golden mesh's context: each step's logits,
    the caches after the prefill and after the last step."""
    from repro import compat
    from repro.launch.mesh import pctx_for_mesh as j_pctx

    mesh = _mesh(K.GOLDEN_MESH)
    pctx = j_pctx(mesh)
    jcfg = jax_config(arch)
    params = golden_tree(arch)
    data = K.forward_inputs(jcfg.vocab_size)
    out = {}

    def layers(caches):
        return [{n: np.asarray(t, np.float32) for n, t in layer.items()}
                for layer in P.j_layers(caches)]

    with compat.set_mesh(mesh):
        logits, caches = jax.jit(lambda p, t: j_forward_prefill(
            p, {"tokens": t}, jcfg, pctx, cache_len=K.FWD_L))(
                params, jnp.asarray(data["tokens"]))
        out["logits/0"] = np.asarray(logits)
        for i, layer in enumerate(layers(caches)):
            out.update({f"prefill_cache/{i}/{n}": t for n, t in layer.items()})
        decode = jax.jit(lambda p, t, q, c: j_forward_decode(
            p, t, q, c, jcfg, pctx))
        for s in range(K.DECODE_STEPS):
            pos = jnp.full((K.FWD_B,), K.FWD_S + s, jnp.int32)
            logits, caches = decode(params, jnp.asarray(
                data["steps"][s][:, None]), pos, caches)
            out[f"logits/{s + 1}"] = np.asarray(logits)
    for i, layer in enumerate(layers(caches)):
        out.update({f"cache/{i}/{n}": t for n, t in layer.items()})
    return {f"forward/{arch}/{k}": v for k, v in out.items()}


def jax_engine(arch: str) -> dict:
    """The JAX `ServeEngine` on the stored weights on the golden mesh,
    `SERVE`'s requests: the settings, prompts, greedy tokens and every
    prefill's and tick's logits."""
    from repro import compat
    from repro.launch.mesh import pctx_for_mesh as j_pctx
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JServeEngine

    mesh = _mesh(K.GOLDEN_MESH)
    jcfg = jax_config(arch)
    record = {"prefill": [], "tick": []}
    prompts = K.prompts(jcfg.vocab_size)
    with compat.set_mesh(mesh):
        eng = JServeEngine(jcfg, golden_tree(arch), j_pctx(mesh),
                           slots=K.SERVE["slots"],
                           max_seq=K.SERVE["max_seq"])
        for key, attr in (("prefill", "_prefill"), ("tick", "_decode")):
            def recorded(*args, fn=getattr(eng, attr), key=key):
                got = fn(*args)
                record[key].append(np.asarray(got[0], np.float32))
                return got
            setattr(eng, attr, recorded)
        for rid, prompt in enumerate(prompts):
            eng.submit(JRequest(rid=rid, prompt=prompt,
                                max_new_tokens=K.SERVE["new"]))
        done = eng.run_to_completion(max_ticks=200)
    out = {"serve/slots": np.array(K.SERVE["slots"]),
           "serve/max_seq": np.array(K.SERVE["max_seq"]),
           "serve/max_new": np.array(K.SERVE["new"]),
           "serve/prefill_logits": np.concatenate(record["prefill"]),
           "serve/tick_logits": np.stack(record["tick"])}
    out.update({f"serve/prompt/{i}": p for i, p in enumerate(prompts)})
    out.update({f"serve/tokens/{r.rid}": np.asarray(r.out_tokens, np.int32)
                for r in done})
    return out


def stored_part(run: dict) -> dict:
    """What a stored run keeps of the steps' run and the engine's: the
    parameters and moments after the last step alone (the file stays
    under 4 MiB), every step's metrics."""
    last = f"after{K.GOLDEN_STEPS}/"
    return {k: v for k, v in run.items()
            if not k.startswith("after") or k.startswith(last)}


def golden_run(arch: str) -> dict:
    """A stored run: the (1, 4) steps and the engine."""
    run, _ = jax_steps(arch, K.GOLDEN_MESH)
    run.update(jax_engine(arch))
    return stored_part(run)


def jax_job(job: tuple) -> dict:
    """One of `JOBS` through the JAX package: a loss case; an arch's
    steps on the golden mesh (the shards beside the run); or its forward
    and engine."""
    kind, key = job
    if kind == "loss":
        return jax_loss(key)
    if kind == "steps":
        run, shards = jax_steps(key, K.GOLDEN_MESH)
        out = {f"run/{key}/{k}": v for k, v in run.items()}
        out.update({f"shards/{key}/{k}": v for k, v in shards.items()})
        return out
    return {**jax_forward(key),
            **{f"engine/{key}/{k}": v for k, v in jax_engine(key).items()}}


# the JAX side's work, each job with its seconds alone on the CPU (their
# compiles, which threads do not overlap): handed out, the longest first,
# to `JAX_PROCS` subprocesses that run beside the port's world
JOBS = {("steps", "recurrentgemma-2b"): 18, ("loss", "rgemma-2x2"): 9,
        ("loss", "qwen3-gelu-1x4"): 8, ("steps", "falcon-mamba-7b"): 8,
        ("serve", "recurrentgemma-2b"): 8, ("loss", "rgemma-lru66-1x4"): 7,
        ("loss", "mamba-d67-1x4"): 6, ("loss", "qwen3-relu-1x4"): 5,
        ("serve", "falcon-mamba-7b"): 5, ("loss", "mamba-2x2"): 4}
JAX_PROCS = 3


def job_parts() -> list:
    """`JOBS` in `JAX_PROCS` parts of about equal seconds."""
    parts = [[] for _ in range(JAX_PROCS)]
    load = [0] * JAX_PROCS
    for job, secs in sorted(JOBS.items(), key=lambda kv: -kv[1]):
        i = load.index(min(load))
        parts[i].append(job)
        load[i] += secs
    return parts


def all_params() -> dict:
    """Every case's weights, by the keys the ranks read."""
    out = {f"{cid}/param/{k}": v for cid, arch, _, replace in K.LOSS_CASES
           for k, v in P._flat(loss_params(arch, replace)).items()}
    out.update({f"golden/{arch}/{k}": v for arch in K.ARCHS
                for k, v in K.golden_params(arch).items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX package's outputs, each rank's port outputs): the JAX
    subprocess and the port's world run side by side, the port from the
    parameters drawn here."""
    tmp = tmp_path_factory.mktemp("tp_recurrent")
    params_path = tmp / "params.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    procs = []
    for i, part in enumerate(job_parts()):
        path = tmp / f"jax{i}.npz"
        procs.append((path, subprocess.Popen(
            [sys.executable, __file__, "--out", str(path),
             json.dumps(part)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, cwd=ROOT)))
    errs = []
    try:
        np.savez(params_path, **all_params())
        port = spawn_world(K.tp_recurrent_rank, K.WORLD, str(params_path),
                           device="cpu", timeout_s=400)
        for _, proc in procs:
            errs.append(proc.communicate(timeout=400)[1])
    finally:
        for _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    jax_out = {}
    for (path, proc), err in zip(procs, errs):
        assert proc.returncode == 0, err[-4000:]
        jax_out.update(np.load(path))
    for k, v in np.load(params_path).items():   # the same draws
        if not k.startswith("golden/"):
            np.testing.assert_array_equal(jax_out[k], v, err_msg=k)
    return jax_out, port


@pytest.fixture(scope="module")
def jax_arrays(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port_out(runs):
    return runs[1]


def _stand_in(shape: tuple, rank: int) -> ParallelContext:
    sizes = {"data": shape[0], "model": shape[1]}
    coords = dict(zip(sizes, map(int, np.unravel_index(rank, shape))))
    return ParallelContext(mesh=types.SimpleNamespace(shape=sizes,
                                                      coords=coords))


def _rank_ctx(coords: dict, mesh: str) -> ParallelContext:
    shape, axes = K.MESHES[mesh]
    return ParallelContext(mesh=types.SimpleNamespace(
        shape=dict(zip(axes, shape)), coords=coords))


# ---------------- the blocks, no compute -------------------------------------

BLOCK_CASES = [pytest.param(a, m, id=f"{a}-{m[0]}x{m[1]}") for a in K.ARCHS
               for m in ((1, 2), (1, 4), (2, 2))]


def _mixer(name: str) -> bool:
    return ".mixer." in name or ".rec." in name


@pytest.mark.parametrize("arch,mesh", BLOCK_CASES)
def test_every_mixer_leaf_splits_and_holds_the_jax_block(arch, mesh):
    """Full size: every mixer leaf computes tensor-parallel; each rank's
    block is the JAX `param_spec` block of the JAX leaf, the channels of a
    leaf the rules leave replicated cut on use, and mamba's in_proj holds
    the rank's x columns beside its z columns, the JAX block's shape."""
    cfg, jcfg = get_config(arch), j_get_config(arch)
    tp = mesh[1]
    width = cfg.d_inner_ if arch == "falcon-mamba-7b" else cfg.lru_width_
    jpctx = JParallelContext(mesh=types.SimpleNamespace(
        shape={"data": mesh[0], "model": tp}), dp_axes=("data",))
    jspecs = {_key(path): _norm(j_param_spec(path, leaf.shape, jcfg, jpctx))
              for path, leaf in jax.tree_util.tree_flatten_with_path(
                  j_param_shapes(jcfg))[0]}
    shapes = {n: s for n, s in param_shapes(cfg).items() if _mixer(n)}
    assert shapes
    for rank in range(mesh[0] * tp):
        pctx = _stand_in(mesh, rank)
        r = pctx.mesh.coords["model"]
        for name, shape in shapes.items():
            assert computes_tp(name, cfg, pctx), name
            key, i = FC.jax_key(name, cfg)
            spec = jspecs[key][0 if i is None else 1:]
            assert param_spec(name, shape, cfg, pctx) == spec, name
            rule = _block(shape, spec, pctx.mesh)
            cut = local_slice(name, shape, cfg, pctx)
            if name.endswith(".in_proj"):
                w = width // tp
                cols = (list(range(r * w, (r + 1) * w))
                        + list(range(width + r * w, width + (r + 1) * w)))
                assert cut[:-1] == rule[:-1] and cut[-1] == cols, name
                order = held_columns(name, cfg, pctx)
                assert sorted(order) == list(range(2 * width))
                assert order[rule[-1]] == cols
            else:
                assert cut == rule, name
                assert held_columns(name, cfg, pctx) is None


@pytest.mark.parametrize("arch", K.ARCHS)
def test_init_params_and_params_from_numpy_hold_the_rank_blocks(arch):
    """Reduced, at every rank of (1, 4) and (2, 2): `init_params` and
    `params_from_numpy` given a mesh hold the whole tree's blocks
    (`local_slice`), mamba's in_proj as [x_r | z_r]."""
    cfg = K.port_config(arch)
    whole = {k: p.detach().numpy()
             for k, p in init_params(cfg, 0, device="cpu").named_parameters()}
    tree = tree_from_flat(FC.to_jax_flat(whole, cfg))
    for mesh in ((1, 4), (2, 2)):
        for rank in range(4):
            pctx = _stand_in(mesh, rank)
            drawn = dict(init_params(cfg, 0, device="cpu",
                                     pctx=pctx).named_parameters())
            given = dict(params_from_numpy(cfg, tree, device="cpu",
                                           pctx=pctx).named_parameters())
            for name, w in whole.items():
                want = w[local_slice(name, w.shape, cfg, pctx)]
                np.testing.assert_array_equal(drawn[name].detach().numpy(),
                                              want, err_msg=name)
                np.testing.assert_array_equal(given[name].detach().numpy(),
                                              want, err_msg=name)
                if name.endswith("mixer.in_proj"):
                    di, r = cfg.d_inner_, pctx.mesh.coords["model"]
                    q = di // mesh[1]
                    x, z = np.split(drawn[name].detach().numpy(), 2, axis=1)
                    rows = want.shape[0]
                    row0 = pctx.mesh.coords["data"] * rows if rows < \
                        w.shape[0] else 0
                    np.testing.assert_array_equal(
                        x, w[row0:row0 + rows, r * q:(r + 1) * q])
                    np.testing.assert_array_equal(
                        z, w[row0:row0 + rows, di + r * q:di + (r + 1) * q])


@pytest.mark.parametrize("arch,mesh", [(a, m) for a in K.ARCHS
                                       for m in K.MESHES])
def test_shard_gather_and_checkpoint_cut_round_trip(port_out, arch, mesh):
    """`shard_params` then `gather_params` give every leaf back with its
    bits (mamba's in_proj put back in the JAX column order), and a
    checkpoint's whole arrays cut by `shard_cut` are the blocks the ranks
    hold."""
    for r in port_out:
        got = r["round_trip"][(arch, mesh)]
        assert got["equal"] and got["restored"], got


# ---------------- loss_fn and its gradients ----------------------------------


def _want(jax_arrays, prefix: str, cfg) -> dict:
    tree = tree_from_flat({k[len(prefix):]: v for k, v in jax_arrays.items()
                           if k.startswith(prefix)})
    return {k: v.detach().numpy() for k, v in params_from_numpy(
        cfg, tree, device="cpu", masters=True).named_parameters()}


@pytest.mark.parametrize("cid", LOSS_IDS)
def test_loss_and_every_grad_equal_jax(jax_arrays, port_out, cid):
    _, arch, mesh, replace = K.LOSS[cid]
    rows = [r["losses"][cid] for r in port_out]
    at = f"{cid}/metric/"
    np.testing.assert_allclose(np.mean([r["metrics"]["loss"] for r in rows]),
                               jax_arrays[at + "loss"], rtol=1e-5)
    cfg = K.port_config(arch, replace)
    if cfg.moe is not None:   # each device's aux term
        aux = np.array([r["metrics"]["aux"] for r in rows])
        np.testing.assert_allclose(aux, jax_arrays[at + "aux"], rtol=1e-5)
    want = _want(jax_arrays, f"{cid}/grad/", cfg)
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


@pytest.mark.parametrize("cid", LOSS_IDS[:4])
def test_a_split_mixer_gathers_no_leaf_over_model(port_out, cid):
    """Where the width divides tp every mixer leaf computes
    tensor-parallel and none is gathered over `model`; where it does not,
    none computes tensor-parallel, and the leaves the rules cut over
    `model` (falcon-mamba's in_proj at d_inner 134) are gathered whole."""
    _, arch, mesh, replace = K.LOSS[cid]
    cfg = K.port_config(arch, replace)
    shapes = param_shapes(cfg)
    mixer = {n for n in shapes if _mixer(n)}
    width = cfg.d_inner_ if arch == "falcon-mamba-7b" else cfg.lru_width_
    tp = K.MESHES[mesh][0][1]
    for r in port_out:
        row = r["losses"][cid]
        over_model = {leaf for leaf, axis in row["mixer_gathers"]
                      if axis == "model"}
        pctx = _rank_ctx(r["coords"][mesh], mesh)
        cut = {n for n in mixer
               if "model" in param_spec(n, shapes[n], cfg, pctx)}
        if width % tp == 0:
            assert mixer <= set(row["tp"])
            assert not over_model, sorted(over_model)
        else:
            assert not mixer & set(row["tp"])
            assert over_model == cut
            if arch == "falcon-mamba-7b":
                assert cut and all(n.endswith(".in_proj") for n in cut)
            else:
                assert not cut


# ---------------- three steps, stored and not ---------------------------------


STEPS = [pytest.param(a, i, id=f"{a}-step{i + 1}") for a in K.ARCHS
         for i in range(K.GOLDEN_STEPS)]


def _port_leaves(flat: dict, prefix: str, cfg, pctx=None) -> dict:
    tree = tree_from_flat({k[len(prefix):]: v for k, v in flat.items()
                           if k.startswith(prefix)})
    return {k: v.detach().numpy() for k, v in params_from_numpy(
        cfg, tree, device="cpu", masters=True, pctx=pctx).named_parameters()}


@pytest.mark.parametrize("arch,i", STEPS)
def test_train_steps_equal_jax(jax_arrays, port_out, arch, i):
    """Each rank's metrics and its blocks of the parameters and both
    moments after step i + 1 on (1, 4) against the JAX arrays' shards on
    the device of its coordinates and the JAX run's whole arrays'
    blocks, mamba's in_proj through `held_columns` (`local_slice`)."""
    cfg = K.port_config(arch)
    mesh = K.GOLDEN_MESH
    run = {k[len(f"run/{arch}/"):]: v for k, v in jax_arrays.items()
           if k.startswith(f"run/{arch}/")}
    shards = {k[len(f"shards/{arch}/"):]: v for k, v in jax_arrays.items()
              if k.startswith(f"shards/{arch}/")}
    whole = param_shapes(cfg)
    for rank, r in enumerate(port_out):
        row = r["steps"][arch]["rows"][i]
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(row["metrics"][k], run[k][i],
                                       rtol=1e-5, err_msg=k)
        pctx = _rank_ctx(r["coords"][mesh], mesh)
        for kind in K.KINDS:
            got = row["blocks"][kind]
            device = _port_leaves(shards, f"after{i + 1}/{rank}/{kind}/",
                                  cfg)
            cut = _port_leaves(run, f"after{i + 1}/{kind}/", cfg, pctx)
            assert sorted(got) == sorted(device) == sorted(cut)
            for name, g in got.items():
                if name.endswith("mixer.in_proj"):
                    # the JAX shard is the rule's columns; the rank holds
                    # its x and z columns (`held_columns`)
                    np.testing.assert_allclose(g, cut[name], err_msg=name,
                                               **STEP_TOL)
                    continue
                np.testing.assert_allclose(g, device[name], err_msg=name,
                                           **STEP_TOL)
                np.testing.assert_allclose(g, cut[name], err_msg=name,
                                           **STEP_TOL)
                if any(param_spec(name, whole[name], cfg, pctx)):
                    assert g.size < np.prod(whole[name]), (kind, name)


@pytest.mark.parametrize("arch", K.ARCHS)
def test_stored_tp_golden_is_current(jax_arrays, arch):
    stored = dict(np.load(GOLDEN[arch]))
    want = {k[len(f"run/{arch}/"):]: v for k, v in jax_arrays.items()
            if k.startswith(f"run/{arch}/")}
    want.update({k[len(f"engine/{arch}/"):]: v for k, v in jax_arrays.items()
                 if k.startswith(f"engine/{arch}/")})
    want = stored_part(want)
    assert sorted(stored) == sorted(want)
    for key, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_allclose(stored[key], w, rtol=1e-6, atol=1e-7,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(stored[key], w, err_msg=key)
    assert GOLDEN[arch].stat().st_size < 4 * 2**20


@pytest.mark.parametrize("arch", K.ARCHS)
def test_the_ranks_of_a_block_hold_the_same_bits(port_out, arch):
    for i in range(K.GOLDEN_STEPS):
        rows = [r["steps"][arch]["rows"][i] for r in port_out]
        assert all(r["metrics"] == rows[0]["metrics"] for r in rows), i
        for name in rows[0]["held"]:
            blocks = {}
            for r in rows:
                coords, digest = r["held"][name]
                blocks.setdefault(coords, set()).add(digest)
            assert all(len(d) == 1 for d in blocks.values()), (i, name)


# ---------------- serving ----------------------------------------------------


@pytest.mark.parametrize("arch", K.ARCHS)
def test_prefill_and_decode_equal_jax(jax_arrays, port_out, arch):
    """Every step's logits within 1e-4 on every rank; each conv, SSM and
    LRU state block (and K/V leaf) within 1e-5 of the rank's
    `cache_spec` block of the JAX cache, the recurrent states a quarter
    of the channels."""
    tp = K.MESHES[K.GOLDEN_MESH][0][1]
    for r in port_out:
        got = r["forward"][arch]
        pctx = _rank_ctx(r["coords"][K.GOLDEN_MESH], K.GOLDEN_MESH)
        for step, logits in enumerate(got["logits"]):
            np.testing.assert_allclose(
                logits, jax_arrays[f"forward/{arch}/logits/{step}"],
                err_msg=f"step {step}", **LOGIT_TOL)
        for when in ("prefill_cache", "cache"):
            for i, layer in enumerate(got[when]):
                for name, block in layer.items():
                    whole = jax_arrays[f"forward/{arch}/{when}/{i}/{name}"]
                    want = whole[cache_slice(name, whole.shape, pctx)]
                    if name in ("conv", "ssm", "lru"):
                        c = 1 if name == "ssm" else -1
                        assert block.shape[c] * tp == whole.shape[c]
                    np.testing.assert_allclose(
                        block, want, err_msg=f"{when} {i} {name}",
                        **CACHE_TOL)


@pytest.mark.parametrize("arch", K.ARCHS)
def test_a_step_and_a_tick_gather_no_mixer_leaf(port_out, arch):
    """chip_smoke.py's `_Census` of the first (1, 4) step and of a decode
    tick: no mixer leaf gathered at all (at data 1 the split leaves need
    no gather); the partial sums over `model` issued."""
    for r in port_out:
        step = r["steps"][arch]
        tick = r["forward"][arch]["tick"]
        assert not step["mixer_gathers"] and not tick["mixer_gathers"]
        for calls in (step["calls"], tick["calls"]):
            kinds = {k[0] for k in calls if k[1] == "model"}
            want = ({"all_reduce"} if arch == "falcon-mamba-7b"
                    else {"all_reduce", "reduce_scatter"})
            assert want <= kinds, kinds


@pytest.mark.parametrize("arch", K.ARCHS)
def test_engine_equals_the_stored_jax_run(port_out, arch):
    """The JAX `ServeEngine` on the same mesh: greedy tokens equal on
    every rank, every prefill's and tick's logits within 1e-4; the slots'
    recurrent states held as the rank's channels."""
    stored = dict(np.load(GOLDEN[arch]))
    cfg = K.port_config(arch)
    tp = K.MESHES[K.GOLDEN_MESH][0][1]
    lens = K.SERVE["lens"]
    assert any(n % 2 for n in lens) and any(n % 2 == 0 for n in lens)
    for r in port_out:
        got = r["engine"][arch]
        assert sorted(got["tokens"]) == list(range(len(lens)))
        for rid, toks in got["tokens"].items():
            assert toks == stored[f"serve/tokens/{rid}"].tolist(), rid
        np.testing.assert_allclose(got["prefill_logits"],
                                   stored["serve/prefill_logits"],
                                   **LOGIT_TOL)
        np.testing.assert_allclose(got["tick_logits"],
                                   stored["serve/tick_logits"], **LOGIT_TOL)
        width = cfg.d_inner_ if arch == "falcon-mamba-7b" else cfg.lru_width_
        for layer in got["cache_shapes"]:
            if "ssm" in layer:
                assert layer["ssm"][1] * tp == width
            if "conv" in layer:
                assert layer["conv"][-1] * tp == width
            if "lru" in layer:
                assert layer["lru"][-1] * tp == width


if __name__ == "__main__":
    if sys.argv[1:2] == ["--out"]:
        out = {}
        for job in json.loads(sys.argv[3]):
            out.update(jax_job(tuple(job)))
        np.savez(sys.argv[2], **out)
    else:
        for arch in K.ARCHS:
            np.savez_compressed(GOLDEN[arch], **golden_run(arch))
            print(f"wrote {GOLDEN[arch].name}: "
                  f"{GOLDEN[arch].stat().st_size} bytes", file=sys.stderr)

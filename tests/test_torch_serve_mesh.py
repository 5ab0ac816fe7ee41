"""The port's serving over a mesh against the JAX package's.

The JAX package runs in a subprocess on 4 fake CPU devices (``XLA_FLAGS=
--xla_force_host_platform_device_count=4`` must be set before JAX is
imported), its cases in parallel threads, under `compat.set_mesh`; the
port on `torch.distributed` worlds of 2 and 4 gloo ranks on the CPU
(`core.comm.spawn_world`), over the cases of
tests/torch_serve_mesh_cases.py:

* `models.sharding.cache_spec` against the JAX package's `cache_spec`
  for every leaf of `cache_specs(cfg, B, L)` of all ten configs at full
  size, on (data, model) meshes (1, 2), (1, 4), (2, 2) and (4, 1), at L
  512 and 4,096; `kvcache.init_cache` given a mesh holds each K/V leaf as
  its block and the recurrent states' channels cut over `model` where
  their mixer splits (no compute: the meta device);
* `forward_prefill` and three `forward_decode` steps under the same
  mesh context as the JAX functions: reduced f32 qwen3-moe on (1, 2)
  and (1, 4) (8 / 4 heads there) at a prefill length that divides tp
  (the all-to-all branch) and one that does not, deepseek-moe on (1, 2),
  yi-9b on (2, 2) at 4 rows (the cache's batch over `data`), seamless
  and llama-vision on (1, 2) (cross caches of 1,024 positions cut by
  positions too), recurrentgemma on (1, 2) with a 1,024 window (the ring
  cut by positions, wrapped by a 1,100-token prefill) and falcon-mamba
  on (1, 2), each transformer arch at a cache of 1,024 positions (cut by
  positions) and of 64 (cut by KV heads): every step's logits within
  1e-4 on every rank, each cache block within 1e-5 of the rank's block
  of the JAX cache, the MoE decode through E / tp experts a rank and
  `rotor_all_reduce(mode="direct")`, an all-to-all prefill through
  `rotor_all_to_all`;
* `ServeEngine` on a mesh: greedy tokens equal to the JAX engine's on
  the same mesh for qwen3-moe and yi-9b on (1, 4) (qwen3-moe's every
  prefill's and tick's logits within 1e-4 of the stored JAX run,
  ``src/repro_torch/data/qwen3_moe_30b_a3b_reduced_serve_mesh_golden.npz``,
  which chip_smoke.py's serve_mesh_golden holds the card to), and equal
  to the port's one-process engine for seamless and llama-vision (the
  JAX engine attends the padded cross cache, ROADMAP Queue 3 R4); a mesh
  of two data ranks is refused.

Regenerate the stored run with ``JAX_PLATFORMS=cpu PYTHONPATH=src
python tests/test_torch_serve_mesh.py``.
"""
import functools
import json
import os
import subprocess
import sys
import threading
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
import torch_serve_mesh_cases as K
from repro.configs import get_config as j_get_config
from repro.models.kvcache import cache_specs as j_cache_specs
from repro.models.model import forward_decode as j_forward_decode
from repro.models.model import forward_prefill as j_forward_prefill
from repro.models.model import init_params as j_init_params
from repro.models.parallel import ParallelContext as JParallelContext
from repro.models.sharding import cache_spec as j_cache_spec
from repro_torch.configs.base import get_config, list_archs
from repro_torch.core.comm import spawn_world
from repro_torch.models.kvcache import init_cache, layer_cache_shape
from repro_torch.models.parallel import ParallelContext
from repro_torch.models.sharding import (cache_slice, cache_spec,
                                        computes_tp, kv_split)
from repro_torch.models.transformer import stack_plan
from test_torch_fsdp import _norm

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = P.DATA / K.GOLDEN_FILE
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_TOL = dict(atol=1e-5, rtol=1e-5)


# ---------------- the JAX package, in a subprocess ---------------------------


def jax_config(arch: str, replace: tuple):
    jcfg, _ = P.cfgs(arch, "float32", layout=False)
    return K.replaced(jcfg, replace)


@functools.lru_cache(maxsize=None)
def jax_params(arch: str, replace: tuple):
    """The JAX package's reduced f32 parameters of an arch (seeded, the
    constant-initialised leaves perturbed)."""
    return P.perturb(j_init_params(jax_config(arch, replace),
                                   jax.random.key(K.SEED)), K.SEED)


def _used() -> list:
    """Every (arch, replace) a case reads parameters of."""
    keys = [(c.arch, c.replace) for c in K.FORWARD_CASES]
    keys += [(spec[0], spec[2]) for spec in K.ENGINE_CASES.values()]
    return list(dict.fromkeys(keys))


def all_params() -> dict:
    return {K.params_key(a, r) + k: v for a, r in _used()
            for k, v in P._flat(jax_params(a, r)).items()}


def _mesh(name: str):
    from jax.sharding import Mesh

    shape, axes = K.MESHES[name]
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)


def _layers(caches) -> list:
    return [{n: np.asarray(t, np.float32) for n, t in layer.items()}
            for layer in P.j_layers(caches)]


def jax_forward(case) -> dict:
    """A forward case through the JAX package's functions under the
    case's mesh context: each step's logits, the caches after the
    prefill and after the last step."""
    from repro import compat
    from repro.launch.mesh import pctx_for_mesh as j_pctx

    mesh = _mesh(case.mesh)
    pctx = j_pctx(mesh)
    jcfg = jax_config(case.arch, case.replace)
    params = jax_params(case.arch, case.replace)
    data = K.inputs(case, jcfg)
    batch = {k: jnp.asarray(v) for k, v in data.items() if k != "steps"}
    out = {}
    with compat.set_mesh(mesh):
        logits, caches = jax.jit(lambda p, b: j_forward_prefill(
            p, b, jcfg, pctx, cache_len=case.L))(params, batch)
        out["logits/0"] = np.asarray(logits)
        for i, layer in enumerate(_layers(caches)):
            out.update({f"prefill_cache/{i}/{n}": t for n, t in layer.items()})
        decode = jax.jit(lambda p, t, q, c: j_forward_decode(
            p, t, q, c, jcfg, pctx))
        for step in range(K.DECODE_STEPS):
            pos = jnp.full((case.B,), case.S + step, jnp.int32)
            logits, caches = decode(params, jnp.asarray(
                data["steps"][step][:, None]), pos, caches)
            out[f"logits/{step + 1}"] = np.asarray(logits)
    for i, layer in enumerate(_layers(caches)):
        out.update({f"cache/{i}/{n}": t for n, t in layer.items()})
    return {f"{case.id}/{k}": v for k, v in out.items()}


def jax_engine(name: str) -> dict:
    """An engine case through the JAX `ServeEngine` on its mesh: each
    request's greedy tokens, each prefill's and each tick's logits."""
    from repro import compat
    from repro.launch.mesh import pctx_for_mesh as j_pctx
    from repro.serve.engine import Request as JRequest
    from repro.serve.engine import ServeEngine as JServeEngine

    arch, mesh_name, replace, slots, max_seq, lens, new, _ = \
        K.ENGINE_CASES[name]
    mesh = _mesh(mesh_name)
    jcfg = jax_config(arch, replace)
    record = {"prefill": [], "tick": []}
    with compat.set_mesh(mesh):
        eng = JServeEngine(jcfg, jax_params(arch, replace), j_pctx(mesh),
                           slots=slots, max_seq=max_seq)
        for key, attr in (("prefill", "_prefill"), ("tick", "_decode")):
            def recorded(*args, fn=getattr(eng, attr), key=key):
                out = fn(*args)
                record[key].append(np.asarray(out[0], np.float32))
                return out
            setattr(eng, attr, recorded)
        for rid, prompt in enumerate(K.prompts(lens, jcfg.vocab_size)):
            eng.submit(JRequest(rid=rid, prompt=prompt, max_new_tokens=new))
        done = eng.run_to_completion(max_ticks=200)
    out = {f"tokens/{r.rid}": np.asarray(r.out_tokens, np.int32)
           for r in done}
    out["prefill_logits"] = np.concatenate(record["prefill"])
    out["tick_logits"] = np.stack(record["tick"])
    return out


def golden_run(run: dict) -> dict:
    """The stored run: the golden engine case's settings, parameters,
    prompts, the JAX engine's tokens and logits."""
    arch, mesh, replace, slots, max_seq, lens, new, _ = \
        K.ENGINE_CASES[K.GOLDEN_CASE]
    jcfg = jax_config(arch, replace)
    out = {"config": np.array(json.dumps(dict(replace))),
           "mesh": np.array(json.dumps({"shape": list(K.MESHES[mesh][0]),
                                        "axes": list(K.MESHES[mesh][1])})),
           "slots": np.array(slots), "max_seq": np.array(max_seq),
           "max_new": np.array(new)}
    out.update({f"param/{k}": v
                for k, v in P._flat(jax_params(arch, replace)).items()})
    for i, prompt in enumerate(K.prompts(lens, jcfg.vocab_size)):
        out[f"prompt/{i}"] = prompt
    out.update(run)
    return out


def jax_outputs() -> dict:
    """Every case through the JAX package, in parallel threads."""
    from concurrent.futures import ThreadPoolExecutor

    for key in _used():   # drawn once, before the threads
        jax_params(*key)
    engines = [n for n, s in K.ENGINE_CASES.items() if s[-1] == "jax"]
    with ThreadPoolExecutor(8) as pool:
        forwards = list(pool.map(jax_forward, K.FORWARD_CASES))
        runs = list(pool.map(jax_engine, engines))
    out = all_params()
    for f in forwards:
        out.update(f)
    for name, run in zip(engines, runs):
        out.update({f"engine/{name}/{k}": v for k, v in run.items()})
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the JAX package's outputs, each world's rank outputs by world
    size): the JAX subprocess and the port's two worlds run side by
    side, the port from the parameters drawn here."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    jax_path, params_path = tmp / "jax.npz", tmp / "params.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.Popen([sys.executable, __file__, "--out",
                             str(jax_path)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, cwd=ROOT)
    port, errors = {}, []

    def world(size):
        try:
            port[size] = spawn_world(K.serve_mesh_rank, size,
                                     str(params_path), device="cpu",
                                     timeout_s=400)
        except BaseException as e:   # raised below, in the test's thread
            errors.append(e)

    try:
        np.savez(params_path, **all_params())
        threads = [threading.Thread(target=world, args=(n,)) for n in (2, 4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        _, err = proc.communicate(timeout=400)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    if errors:
        raise errors[0]
    assert proc.returncode == 0, err[-4000:]
    jax_out = dict(np.load(jax_path))
    for k, v in np.load(params_path).items():   # the same draws
        np.testing.assert_array_equal(jax_out[k], v, err_msg=k)
    return jax_out, port


@pytest.fixture(scope="module")
def jax_arrays(runs):
    return runs[0]


def _ranks(runs, mesh: str) -> list:
    return runs[1][int(np.prod(K.MESHES[mesh][0]))]


# ---------------- cache_spec, every config -----------------------------------

SPEC_MESHES = ((1, 2), (1, 4), (2, 2), (4, 1))
SPEC_CASES = [pytest.param(a, m, L, id=f"{a}-{m[0]}x{m[1]}-L{L}")
              for a in list_archs() for m in SPEC_MESHES for L in (512, 4096)]


def _stand_in(shape: tuple, rank: int = 0):
    """Stand-in JAX and port contexts of a (data, model) mesh at `rank`'s
    coordinates."""
    sizes = {"data": shape[0], "model": shape[1]}
    coords = dict(zip(sizes, map(int, np.unravel_index(rank, shape))))
    jpctx = JParallelContext(mesh=types.SimpleNamespace(shape=sizes))
    pctx = ParallelContext(mesh=types.SimpleNamespace(shape=sizes,
                                                      coords=coords))
    return jpctx, pctx


@pytest.mark.parametrize("arch,mesh,L", SPEC_CASES)
def test_cache_spec_equals_jax(arch, mesh, L):
    """Every leaf of the JAX package's `cache_specs` at rows 1 and 8: its
    `cache_spec` without the scan axis of a stacked leaf is the port's of
    the one layer's shape."""
    jcfg = j_get_config(arch)
    jpctx, pctx = _stand_in(mesh)
    n = 0
    for B in (1, 8):
        tree = j_cache_specs(jcfg, B, L)
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys = [str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path]
            lead = 1 if keys[0] == "blocks" else 0
            want = _norm(j_cache_spec(path, leaf.shape, jpctx))
            shape = tuple(leaf.shape[lead:])
            assert tuple(want[lead:]) == cache_spec(keys[-1], shape, pctx), (
                keys, shape)
            n += 1
    assert n


@pytest.mark.parametrize("arch,mesh", [
    pytest.param(a, m, id=f"{a}-{m[0]}x{m[1]}") for a in list_archs()
    for m in SPEC_MESHES])
def test_init_cache_holds_every_leaf_as_its_block(arch, mesh):
    """On the meta device, at full size, B 8, L 4,096, the last rank: each
    K/V leaf is its `cache_slice` block of the whole leaf, by positions or
    by heads as `kv_split` says; the conv, SSM and LRU states their rows
    over `data` and their channels over `model` exactly where their mixer
    computes on the rank's channels (`computes_tp`), else whole."""
    cfg = get_config(arch)
    _, pctx = _stand_in(mesh, rank=mesh[0] * mesh[1] - 1)
    B, L = 8, 4096
    caches = init_cache(cfg, B, L, device="meta", pctx=pctx)
    kinds = stack_plan(cfg).kinds
    assert len(caches) == len(kinds) == len(caches.cuts)
    for layer, cut, kind in zip(caches, caches.cuts, kinds):
        for name, (shape, _) in layer_cache_shape(cfg, kind, B, L).items():
            want = np.empty(shape, np.bool_)[
                cache_slice(name, shape, pctx)].shape
            assert tuple(layer[name].shape) == want, (kind, name)
            if name in ("k", "v", "ck", "cv"):
                assert cut[name] == kv_split(name, shape, pctx)
                whole = {"positions": 2, "heads": 1}.get(cut[name])
                if whole is not None:
                    assert want[whole] * mesh[1] == shape[whole]
            else:
                cdim = 1 if name == "ssm" else len(shape) - 1
                mixer = "stack.0.mixer.in_proj" if kind == "ssm" else \
                    f"stack.{kinds.index(kind)}.rec.w_y"
                n = mesh[1] if computes_tp(mixer, cfg, pctx) else 1
                assert want[cdim] * n == shape[cdim], (kind, name)
                assert all(w == s for d, (w, s) in enumerate(zip(want, shape))
                           if d not in (0, cdim)), (kind, name)
                assert want[0] * mesh[0] == shape[0]


def test_a_data_mesh_is_refused():
    """Slots over `data` wait (ROADMAP Queue 1 item 7c): the JAX engine
    cannot prefill an MoE arch there."""
    from repro_torch.serve.engine import ServeEngine

    _, pctx = _stand_in((2, 2))
    with pytest.raises(ValueError, match="slots over"):
        ServeEngine(K.port_config("yi-9b"), None, pctx, device="cpu")


def test_decode_on_a_mesh_takes_cache_blocks():
    from repro_torch.models.model import forward_decode

    _, pctx = _stand_in((1, 2))
    with pytest.raises(TypeError, match="CacheBlocks"):
        forward_decode(None, None, None, [], K.port_config("yi-9b"),
                       pctx=pctx)


# ---------------- prefill and decode -----------------------------------------

FORWARD_IDS = [c.id for c in K.FORWARD_CASES]


@pytest.mark.parametrize("case_id", FORWARD_IDS)
def test_prefill_and_decode_equal_jax(jax_arrays, runs, case_id):
    case = K.CASES[case_id]
    shape, axes = K.MESHES[case.mesh]
    ranks = _ranks(runs, case.mesh)
    for rank, r in enumerate(ranks):
        got = r["forward"][case_id]
        coords = r["coords"][case.mesh]
        pctx = ParallelContext(mesh=types.SimpleNamespace(
            shape=dict(zip(axes, shape)), coords=coords))
        rows = K._rows(np.arange(case.B), pctx)   # of the global batch
        for step, logits in enumerate(got["logits"]):
            want = jax_arrays[f"{case_id}/logits/{step}"][rows]
            np.testing.assert_allclose(logits, want, err_msg=f"step {step}",
                                       **LOGIT_TOL)
        for when in ("prefill_cache", "cache"):
            for i, layer in enumerate(got[when]):
                for name, block in layer.items():
                    whole = jax_arrays[f"{case_id}/{when}/{i}/{name}"]
                    want = whole[cache_slice(name, whole.shape, pctx)]
                    np.testing.assert_allclose(
                        block, want, err_msg=f"{when} {i} {name}",
                        **CACHE_TOL)


def test_every_rank_of_a_row_has_the_same_logits(runs):
    for case in K.FORWARD_CASES:
        ranks = _ranks(runs, case.mesh)
        by_row = {}
        for r in ranks:
            key = r["coords"][case.mesh]["data"]
            got = r["forward"][case.id]["logits"]
            if key in by_row:
                for a, b in zip(got, by_row[key]):
                    np.testing.assert_array_equal(a, b, err_msg=case.id)
            by_row[key] = got


def test_both_cuts_and_the_ring_are_exercised(runs):
    """Caches cut by KV heads and by positions, self and cross, and the
    local-attention ring cut by positions."""
    seen = set()
    for case in K.FORWARD_CASES:
        for cut in _ranks(runs, case.mesh)[0]["forward"][case.id]["cuts"]:
            seen.update((case.arch, n, how) for n, how in cut.items())
    for name in ("k", "ck"):
        assert any(n == name and how == "heads" for _, n, how in seen)
        assert any(n == name and how == "positions" for _, n, how in seen)
    assert ("recurrentgemma-2b", "k", "positions") in seen


MOE_CASES = [c.id for c in K.FORWARD_CASES
             if c.arch in ("qwen3-moe-30b-a3b", "deepseek-moe-16b")]


@pytest.mark.parametrize("case_id", MOE_CASES)
def test_moe_takes_the_jax_branches(runs, case_id):
    """At decode the local branch: E / tp experts a rank through moe_gmm,
    the partials summed by `rotor_all_reduce(mode="direct")`; a prefill
    whose length divides tp through `rotor_all_to_all` (there and back),
    any other through the local branch."""
    case = K.CASES[case_id]
    cfg = K.port_config(case.arch, case.replace)
    tp = K.MESHES[case.mesh][0][1]
    layers = stack_plan(cfg).kinds.count("moe")
    e_loc = f"moe_gmm/E{cfg.moe.num_experts // tp}"
    local = {e_loc: layers, "rotor_all_reduce/direct": layers}
    for r in _ranks(runs, case.mesh):
        got = r["forward"][case_id]["branches"]
        assert got["decode"] == {k: v * K.DECODE_STEPS
                                 for k, v in local.items()}
        if case.S % tp == 0:
            assert got["prefill"] == {e_loc: layers,
                                      "rotor_all_to_all": 2 * layers}
        else:
            assert got["prefill"] == local


# ---------------- the engine -------------------------------------------------


@pytest.mark.parametrize("name", list(K.ENGINE_CASES))
def test_engine_tokens(jax_arrays, runs, name):
    """Every rank's greedy tokens: the JAX engine's on the same mesh, or
    the port's one-process engine's for the cross archs."""
    spec = K.ENGINE_CASES[name]
    ranks = _ranks(runs, spec[1])
    n = len(spec[5])
    for r in ranks:
        got = r["engine"][name]
        assert sorted(got["tokens"]) == list(range(n))
        for rid, toks in got["tokens"].items():
            if spec[-1] == "jax":
                want = jax_arrays[f"engine/{name}/tokens/{rid}"].tolist()
            else:
                want = got["one_process"][rid]
            assert toks == want, (rid, toks, want)
        assert got["tokens"] == ranks[0]["engine"][name]["tokens"]


def test_engine_logits_equal_the_stored_jax_run(runs):
    """What chip_smoke.py's serve_mesh_golden holds the card to: every
    prefill's and every tick's logits within 1e-4 of the stored run."""
    stored = dict(np.load(GOLDEN))
    spec = K.ENGINE_CASES[K.GOLDEN_CASE]
    for r in _ranks(runs, spec[1]):
        got = r["engine"][K.GOLDEN_CASE]
        np.testing.assert_allclose(np.concatenate(got["prefill_logits"]),
                                   stored["prefill_logits"], **LOGIT_TOL)
        np.testing.assert_allclose(np.stack(got["tick_logits"]),
                                   stored["tick_logits"], **LOGIT_TOL)
        for rid, toks in got["tokens"].items():
            assert toks == stored[f"tokens/{rid}"].tolist(), rid
    lens = spec[5]
    assert any(n % 4 == 0 for n in lens) and any(n % 4 for n in lens)


def test_stored_golden_is_current(jax_arrays):
    stored = dict(np.load(GOLDEN))
    prefix = f"engine/{K.GOLDEN_CASE}/"
    run = {k[len(prefix):]: v for k, v in jax_arrays.items()
           if k.startswith(prefix)}
    want = golden_run(run)
    assert sorted(stored) == sorted(want)
    for key, w in want.items():
        if key.endswith("logits"):
            np.testing.assert_allclose(stored[key], w, rtol=1e-6, atol=1e-6,
                                       err_msg=key)
        else:
            np.testing.assert_array_equal(stored[key], w, err_msg=key)
    assert GOLDEN.stat().st_size < 4 * 2**20


if __name__ == "__main__":
    if sys.argv[1:2] == ["--out"]:
        np.savez(sys.argv[2], **jax_outputs())
    else:
        run = jax_engine(K.GOLDEN_CASE)
        np.savez_compressed(GOLDEN, **golden_run(run))
        print(f"wrote {GOLDEN.name}: {GOLDEN.stat().st_size} bytes",
              file=sys.stderr)

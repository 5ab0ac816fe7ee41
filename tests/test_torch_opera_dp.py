"""The port's explicit data-parallel trainer against the JAX package's.

Reduced smollm-360m (2 layers, vocab 64, as
tests/distributed/check_sharded_train.py:37-39, in its own head layout,
float32) with the JAX package's parameters carried across: the port's
`train.opera_dp` step on 4 gloo ranks (`core.comm.spawn_world`) as `pod`
2 x `data` 2 and as `data` 4, plain and with int8 gradient compression
(tests/torch_dist_cases.py `DP_RUNS`), against
`repro.train.opera_dp.make_opera_dp_train_step` on 4 fake CPU devices in
a subprocess: each step's loss, aux, total, grad norm and lr within rtol
1e-5, every parameter after each step at `STEP_TOL` (atol/rtol 1e-5,
tests/test_torch_train.py:103), each rank's carried error likewise but
at rounding ties and the elements they carry into (`_error_held`); the
four replicas hold the same bits after every step.  On a world of one
rank the step is `make_train_step`'s bit for bit (as
tests/test_trainer_serve.py:49-73 holds the JAX pair).  The launcher
trains under torchrun on 2 ranks with ``--compress-grads``.

The first run (`pod` 2 x `data` 2, plain, 3 steps) is stored in
``src/repro_torch/data/smollm_360m_reduced_opera_dp_golden.npz`` for
chip_smoke.py's ``opera_dp_golden``; regenerate it with
``JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_opera_dp.py``
(`test_stored_opera_dp_golden_is_current` fails when it is stale).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

if __name__ == "__main__":   # the JAX side, on fake CPU devices
    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as K
from repro.configs import get_config as j_get_config
from repro.configs.base import reduced_config as j_reduced
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.model import init_params as j_init_params
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro_torch.core.comm import Mesh, spawn_world
from repro_torch.data.pipeline import SyntheticLM, device_batches
from repro_torch.launch.mesh import pctx_for_mesh
from repro_torch.models.convert import params_from_numpy, tree_from_flat
from repro_torch.models.model import init_params
from repro_torch.models.parallel import single_device_ctx
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.opera_dp import (init_opera_dp_state,
                                        make_opera_dp_train_step)
from repro_torch.train.trainer import init_train_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = ROOT / "src" / "repro_torch" / "data" / \
    "smollm_360m_reduced_opera_dp_golden.npz"
STEP_TOL = dict(atol=1e-5, rtol=1e-5)
METRICS = ("loss", "aux", "total", "grad_norm", "lr")


# ---------------- the JAX package, in a subprocess ----------------------------


def _flat(tree, prefix: str = "") -> dict:
    """Leaves under their key paths; a list's entries under "0", "1"."""
    out = {}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for name, value in items:
        if isinstance(value, (dict, list)):
            out.update(_flat(value, f"{prefix}{name}/"))
        else:
            out[f"{prefix}{name}"] = np.asarray(value, np.float32)
    return out


def jax_runs() -> dict:
    """`K.DP_RUNS` through the JAX package's opera-dp step on 4 fake CPU
    devices: the parameters (``param/``), and per run and step the
    metrics, the parameters and each device's carried error."""
    from repro import compat
    from repro.launch.mesh import pctx_for_mesh as j_pctx_for_mesh
    from repro.train.opera_dp import (init_opera_dp_state as j_init_state,
                                      make_opera_dp_train_step as j_step)

    jcfg = j_reduced(j_get_config("smollm-360m")).replace(**K.DP_CONFIG)
    params = j_init_params(jcfg, jax.random.key(0))
    src = JSyntheticLM(jcfg.vocab_size, K.DP_DATA["seq"], K.DP_DATA["batch"],
                       seed=K.DP_DATA["seed"])
    out = {f"param/{k}": v for k, v in _flat(params).items()}
    for r, (layout, compress, steps) in enumerate(K.DP_RUNS):
        shape, axes = K.LAYOUTS[layout]
        mesh = compat.make_mesh(shape + (1,), axes + ("model",),
                                devices=jax.devices()[:4])
        ranks = list(mesh.devices.reshape(-1))
        step = jax.jit(j_step(jcfg, j_pctx_for_mesh(mesh),
                              JAdamWConfig(**K.DP_OPT), compress))
        with compat.set_mesh(mesh):
            state = j_init_state(params, compress)
            for i in range(steps):
                state, m = step(state, jax.tree.map(jnp.asarray,
                                                    src.batch_at(i)))
                at = f"{r}/step{i + 1}"
                out.update({f"{at}/metric/{k}": np.float32(m[k])
                            for k in METRICS})
                out.update({f"{at}/param/{k}": v
                            for k, v in _flat(state["params"]).items()})
                if compress:
                    for path, leaf in jax.tree_util.tree_flatten_with_path(
                            state["err"])[0]:
                        key = "/".join(str(getattr(p, "key", getattr(
                            p, "idx", p))) for p in path)
                        by_dev = {s.device: np.asarray(s.data)
                                  for s in leaf.addressable_shards}
                        for rank, dev in enumerate(ranks):
                            out[f"{at}/err{rank}/{key}"] = by_dev[dev]
    return out


def golden_from(runs: dict) -> dict:
    """The stored run: the first of `K.DP_RUNS`, as the training goldens
    are laid out (tests/test_torch_train.py)."""
    layout, _, steps = K.DP_RUNS[0]
    shape, axes = K.LAYOUTS[layout]
    out = {"config": np.array(json.dumps(K.DP_CONFIG, sort_keys=True)),
           "opt": np.array(json.dumps(K.DP_OPT, sort_keys=True)),
           "data": np.array(json.dumps(K.DP_DATA, sort_keys=True)),
           "mesh": np.array(json.dumps({"shape": list(shape),
                                        "axes": list(axes)}))}
    out.update({k: v for k, v in runs.items() if k.startswith("param/")})
    for k in ("loss", "grad_norm", "lr"):
        out[k] = np.array([runs[f"0/step{i + 1}/metric/{k}"]
                           for i in range(steps)], np.float32)
    for i in range(steps):
        prefix = f"0/step{i + 1}/param/"
        out.update({f"after{i + 1}/{k[len(prefix):]}": v
                    for k, v in runs.items() if k.startswith(prefix)})
    return out


@pytest.fixture(scope="module")
def jax_out(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax") / "opera_dp.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "XLA_FLAGS": "--xla_force_host_platform_device_count=8",
           "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run([sys.executable, __file__, "--out", str(path)],
                          env=env, capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return dict(np.load(path))


@pytest.fixture(scope="module")
def port_out(jax_out):
    flat = {k[len("param/"):]: v for k, v in jax_out.items()
            if k.startswith("param/")}
    return spawn_world(K.dp_rank, 4, flat, device="cpu", timeout_s=240)


def _named(flat: dict, prefix: str) -> dict:
    """The JAX arrays under `prefix`, by the port's parameter names."""
    tree = tree_from_flat({k[len(prefix):]: v for k, v in flat.items()
                           if k.startswith(prefix)})
    return {k: v.detach().numpy() for k, v in params_from_numpy(
        K.dp_config(), tree, device="cpu", masters=True).named_parameters()}


STEPS = [pytest.param(r, i, id=f"{lay}-{'int8' if c else 'plain'}-{i + 1}")
         for r, (lay, c, n) in enumerate(K.DP_RUNS) for i in range(n)]


# ---------------- the step against the JAX package ----------------------------


@pytest.mark.parametrize("run,i", STEPS)
def test_opera_dp_step_equals_jax(jax_out, port_out, run, i):
    at = f"{run}/step{i + 1}"
    row = port_out[0][run]["rows"][i]
    for k in METRICS:
        np.testing.assert_allclose(row["metrics"][k],
                                   jax_out[f"{at}/metric/{k}"], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = _named(jax_out, f"{at}/param/")
    assert sorted(want) == sorted(row["params"])
    for name, w in want.items():
        np.testing.assert_allclose(row["params"][name], w, err_msg=name,
                                   **STEP_TOL)
    if K.DP_RUNS[run][1]:
        for rank, rr in enumerate(port_out):
            tied = {}
            for j in range(i + 1):   # ties carry into the later steps
                want = _named(jax_out, f"{run}/step{j + 1}/err{rank}/")
                for name, w in want.items():
                    tied[name] = _error_held(
                        rr[run]["rows"][j]["err"][name], w,
                        tied.get(name, np.zeros(w.shape, bool)),
                        f"rank {rank} step {j + 1} {name}")


def _error_held(got: np.ndarray, want: np.ndarray, tied: np.ndarray,
                what: str) -> np.ndarray:
    """A carried quantization error at `STEP_TOL`, but where the two
    packages' gradients, a few ulp apart, fall on the two sides of a
    rounding tie of x / scale: there the errors are +-scale / 2, the same
    magnitude and opposite signs, and the element carries a different
    error into the later steps (`tied`, returned with this step's ties).
    Ties are rare: at most one element in a thousand."""
    close = np.isclose(got, want, **STEP_TOL)
    ties = ~close & ~tied & np.isclose(got, -want, **STEP_TOL)
    held = close | ties | tied
    assert held.all(), (what, got[~held], want[~held])
    tied = tied | ties
    assert tied.sum() <= max(1, tied.size // 1000), (what, tied.sum())
    return tied


@pytest.mark.parametrize("run", range(len(K.DP_RUNS)))
def test_replicas_hold_the_same_bits(port_out, run):
    """After every step the four ranks' parameters are the same bits, and
    their metrics the same numbers."""
    for i in range(K.DP_RUNS[run][2]):
        rows = [r[run]["rows"][i] for r in port_out]
        assert len({r["digest"] for r in rows}) == 1, i
        assert all(r["metrics"] == rows[0]["metrics"] for r in rows), i


@pytest.mark.parametrize("compress", [False, True])
def test_a_world_of_one_gives_make_train_step(compress):
    """On one rank the opera-dp step is `make_train_step`'s bit for bit;
    with compression, the error fed back is the int8 residual, and the
    step moves the parameters otherwise."""
    cfg = K.dp_config()
    opt = AdamWConfig(**K.DP_OPT)
    pctx = pctx_for_mesh(Mesh((1, 1), ("data", "model")))
    runs = []
    for fn in ("plain", "dp"):
        params = init_params(cfg, 0, device="cpu", masters=True)
        if fn == "plain":
            state = init_train_state(cfg, params)
            step = make_train_step(cfg, single_device_ctx(), opt)
        else:
            state = init_opera_dp_state(params, compress)
            step = make_opera_dp_train_step(cfg, pctx, opt, compress)
        rows = []
        src = SyntheticLM(cfg.vocab_size, 16, 4, seed=0)
        for _, batch in zip(range(2), device_batches(src, 0, "cpu")):
            state, m = step(state, batch)
            rows.append({k: float(v) for k, v in m.items()})
        runs.append((rows, state))
    (rows, a), (dp_rows, b) = runs
    same = all(torch.equal(p, q) for p, q in zip(
        a["params"].parameters(), b["params"].parameters()))
    if not compress:
        assert rows == dp_rows and same
    else:
        assert not same and set(b["err"]) == set(
            dict(b["params"].named_parameters()))
        assert all(float(e.abs().max()) > 0 for e in b["err"].values())


# ---------------- the stored run and the launcher ------------------------------


def test_stored_opera_dp_golden_is_current(jax_out):
    stored, golden = dict(np.load(GOLDEN)), golden_from(jax_out)
    assert sorted(stored) == sorted(golden)
    for key, want in golden.items():
        if want.dtype.kind == "f":
            np.testing.assert_allclose(stored[key], want, rtol=1e-6,
                                       atol=1e-7, err_msg=key)
        else:
            np.testing.assert_array_equal(stored[key], want, err_msg=key)
    assert GOLDEN.stat().st_size < 4 * 2**20


def test_launcher_trains_on_two_ranks_under_torchrun():
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--device", "cpu", "--reduced", "--steps", "2",
         "--compress-grads"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src"),
             "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "[world] 2 ranks, backend gloo" in proc.stdout
    assert "mesh {'data': 2, 'model': 1}, trainer=opera-dp" in proc.stdout
    assert proc.stdout.count("[train] done: loss") == 1   # rank 0 alone


if __name__ == "__main__":
    runs = jax_runs()
    if sys.argv[1:2] == ["--out"]:
        np.savez(sys.argv[2], **runs)
    else:
        np.savez(GOLDEN, **golden_from(runs))
        print(f"wrote {GOLDEN.name}: {GOLDEN.stat().st_size} bytes",
              file=sys.stderr)

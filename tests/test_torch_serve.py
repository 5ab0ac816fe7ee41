"""The port's serving engine against the JAX package's, on the CPU, and
the stored golden run that `chip_smoke.py` holds the card to.

Reduced qwen3-moe-30b-a3b, falcon-mamba-7b and recurrentgemma-2b in
float32 with the JAX package's parameters (carried across with
`params_from_numpy`); prompts are seeded numpy arrays handed to both
engines.  Greedy tokens must be equal.

The golden files ``src/repro_torch/data/*_reduced_golden.npz`` hold,
for each arch, the JAX package's parameters (seed 0), four prompts, the
JAX engine's greedy tokens (2 slots) and each prompt's prefill logits.
Every prompt is at least 5 tokens, so the conv states of the recurrent
archs are full (ROADMAP.md Queue 3, R3), and recurrentgemma's are longer
than its reduced window of 8, so its ring cache wraps.  Regenerate them
with ``JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_serve.py
[arch ...]``.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import reduced_config as j_reduced
from repro.models.model import forward_prefill as j_forward_prefill
from repro.models.model import init_params as j_init_params
from repro.models.parallel import single_device_ctx
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve as serve_cli
from repro_torch.models.convert import params_from_numpy, tree_from_flat
from repro_torch.models.model import forward_prefill
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "qwen3-moe-30b-a3b"
DATA = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "data"
GOLDEN = DATA / "qwen3_moe_reduced_golden.npz"
RECURRENT = ("falcon-mamba-7b", "recurrentgemma-2b")
GOLDENS = {ARCH: GOLDEN,
           "falcon-mamba-7b": DATA / "falcon_mamba_reduced_golden.npz",
           "recurrentgemma-2b": DATA / "recurrentgemma_reduced_golden.npz"}
SHORTEST = {ARCH: 5, "falcon-mamba-7b": 5, "recurrentgemma-2b": 9}
SLOTS, MAX_SEQ, MAX_NEW, REQUESTS = 2, 64, 8, 4


def _prompts(seed=0, shortest=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(shortest, 20))).astype(
        np.int32) for _ in range(REQUESTS)]


def _flat(tree, prefix=""):
    """Leaves under their key paths; a list's entries under "0", "1"."""
    out = {}
    items = enumerate(tree) if isinstance(tree, list) else tree.items()
    for name, value in items:
        if isinstance(value, (dict, list)):
            out.update(_flat(value, f"{prefix}{name}/"))
        else:
            out[f"{prefix}{name}"] = np.asarray(value, np.float32)
    return out


def _run(engine_cls, request_cls, cfg, params, prompts, **kw):
    eng = engine_cls(cfg, params, slots=SLOTS, max_seq=MAX_SEQ, **kw)
    for rid, prompt in enumerate(prompts):
        eng.submit(request_cls(rid=rid, prompt=prompt, max_new_tokens=MAX_NEW))
    done = eng.run_to_completion(max_ticks=200)
    assert len(done) == len(prompts)
    return eng, {r.rid: r.out_tokens for r in done}


def golden_reference(arch: str = ARCH) -> dict:
    """The JAX package's golden run: parameters, prompts, greedy tokens
    and prefill logits."""
    cfg = j_reduced(j_get_config(arch)).replace(compute_dtype="float32")
    params = j_init_params(cfg, jax.random.key(0))
    prompts = _prompts(shortest=SHORTEST[arch])
    pctx = single_device_ctx()
    _, toks = _run(lambda c, p, **kw: JServeEngine(c, p, pctx, **kw),
                   JRequest, cfg, params, prompts)
    out = {f"param/{k}": v for k, v in _flat(params).items()}
    for i, prompt in enumerate(prompts):
        logits, _ = j_forward_prefill(params, {"tokens": jnp.asarray(prompt[None])},
                                      cfg, pctx)
        out[f"prompt/{i}"] = prompt
        out[f"tokens/{i}"] = np.asarray(toks[i], np.int32)
        out[f"logits/{i}"] = np.asarray(logits[0], np.float32)
    return out


def _port_cfg(arch=ARCH):
    return reduced_config(get_config(arch)).replace(compute_dtype="float32")


def _port_params(flat, arch=ARCH):
    tree = tree_from_flat({k[len("param/"):]: v for k, v in flat.items()
                           if k.startswith("param/")})
    return params_from_numpy(_port_cfg(arch), tree, device="cpu")


@pytest.fixture(scope="module")
def golden():
    return golden_reference()


@pytest.fixture(scope="module", params=RECURRENT)
def recurrent_golden(request):
    return request.param, golden_reference(request.param)


def test_engine_matches_jax_engine(golden):
    prompts = [golden[f"prompt/{i}"] for i in range(REQUESTS)]
    launch_counts.clear()
    eng, toks = _run(ServeEngine, Request, _port_cfg(), _port_params(golden),
                     prompts, device="cpu")
    for i in range(REQUESTS):
        assert toks[i] == golden[f"tokens/{i}"].tolist(), i
    assert eng.prefills == REQUESTS and eng.ticks > 0
    assert not launch_counts   # the CPU runs the plain versions


def test_recurrent_engine_matches_jax_engine(recurrent_golden):
    """The recurrent states' slots (conv, ssm, lru) and the ring window
    cache go through the engine's insert and decode as in the JAX one."""
    arch, golden = recurrent_golden
    prompts = [golden[f"prompt/{i}"] for i in range(REQUESTS)]
    assert min(map(len, prompts)) >= SHORTEST[arch]
    launch_counts.clear()
    eng, toks = _run(ServeEngine, Request, _port_cfg(arch),
                     _port_params(golden, arch), prompts, device="cpu")
    for i in range(REQUESTS):
        assert toks[i] == golden[f"tokens/{i}"].tolist(), i
    assert eng.prefills == REQUESTS and eng.ticks > 0
    assert not launch_counts


def _stored_is_current(path, golden):
    stored = dict(np.load(path))
    assert sorted(stored) == sorted(golden)
    for key, want in golden.items():
        if key.startswith("logits/"):
            np.testing.assert_allclose(stored[key], want, rtol=1e-6,
                                       atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(stored[key], want, err_msg=key)
    assert path.stat().st_size < 2 * 2**20


def _reproduces_golden(arch):
    stored = dict(np.load(GOLDENS[arch]))
    params = _port_params(stored, arch)
    for i in range(REQUESTS):
        tokens = torch.from_numpy(stored[f"prompt/{i}"][None]).long()
        logits, _ = forward_prefill(params, {"tokens": tokens},
                                    _port_cfg(arch))
        np.testing.assert_allclose(logits[0].numpy(), stored[f"logits/{i}"],
                                   atol=1e-4, rtol=1e-4)


class TestGoldenData:
    def test_stored_data_is_current(self, golden):
        _stored_is_current(GOLDEN, golden)

    def test_recurrent_stored_data_is_current(self, recurrent_golden):
        arch, golden = recurrent_golden
        _stored_is_current(GOLDENS[arch], golden)

    @pytest.mark.parametrize("arch", RECURRENT)
    def test_recurrent_port_reproduces_golden_on_cpu(self, arch):
        _reproduces_golden(arch)

    def test_port_reproduces_golden_on_cpu(self):
        """What chip_smoke.py checks on the card, on the CPU path."""
        _reproduces_golden(ARCH)


def test_cli_serves_on_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--arch", "qwen3-moe-30b-a3b",
                    "--requests", "3", "--slots", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert "[serve] qwen3-moe-30b-a3b on cpu: 3 requests, 12 tokens" in out


def test_cli_defaults_to_the_reference_arch(capsys):
    """With no --arch the launcher serves smollm-360m, as
    repro.launch.serve does."""
    serve_cli.main(["--device", "cpu", "--requests", "2", "--slots", "2",
                    "--max-new", "3"])
    out = capsys.readouterr().out
    assert "[serve] smollm-360m on cpu: 2 requests, 6 tokens" in out


@pytest.mark.parametrize("arch", RECURRENT)
def test_cli_serves_recurrent_archs_on_cpu(arch, capsys):
    serve_cli.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                    "--slots", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"[serve] {arch} on cpu: 3 requests, 12 tokens" in out


if __name__ == "__main__":
    for name in sys.argv[1:] or GOLDENS:
        data = golden_reference(name)
        path = GOLDENS[name]
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **data)
        print(f"wrote {path.name}: {len(data)} arrays, "
              f"{path.stat().st_size} bytes", file=sys.stderr)

"""The port's training path against the JAX package's, on the CPU.

Reduced models in float32 (tests/torch_arch_parity.py): smollm-360m in
its own head layout (hd 64, 3 query heads a KV head), qwen3-moe and
deepseek-moe (the router aux term, the moe_gmm kernel's plain version),
falcon-mamba (mamba_scan's) and recurrentgemma (rglru_scan's and the
local attention), the JAX package's parameters carried across with
`params_from_numpy(..., masters=True)`, as are its gradients.  The loss
and every gradient leaf of `loss_fn` within 1e-4 of `jax.value_and_grad`
relative to the leaf's largest gradient (the f32 whole-model tolerance
of tests/torch_arch_parity.py; the two sum in other orders); the losses,
z-loss and their input gradients alone within 1e-5.  Five steps of
`train.trainer.make_train_step` against the JAX package's
`make_train_step`, stored in
``src/repro_torch/data/<arch>_reduced_train_golden.npz`` for smollm-360m,
qwen3-moe-30b-a3b, falcon-mamba-7b and recurrentgemma-2b (`GOLDEN_ARCHS`):
losses, gradient norms and lrs within rtol 1e-5, the parameters after
each step within atol/rtol 1e-5 (tests/test_trainer_serve.py:70-73).
Regenerate them with ``JAX_PLATFORMS=cpu PYTHONPATH=src python
tests/test_torch_train.py [arch ...]``; `test_stored_train_golden_is_current`
and `test_stored_arch_train_golden_is_current` fail when one is stale.
chip_smoke.py holds the card to the same files.

Also: the loss falls (tests/test_trainer_serve.py:33-47), every arch
trains on the CPU (the plain versions under autograd), the checkpointer
(round trip, keep-last-k, async save, a restart that repeats the run bit
for bit), the fleet monitor's decisions equal the JAX package's, and the
train launcher on one process (tests/test_torch_opera_dp.py runs it
under torchrun).
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import torch_arch_parity as P
from repro.configs import get_config as j_get_config
from repro.configs.base import reduced_config as j_reduced
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models.model import init_params as j_init_params
from repro.models.model import loss_fn as j_loss_fn
from repro.models.model import softmax_xent as j_softmax_xent
from repro.models.model import softmax_xent_chunked as j_softmax_xent_chunked
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.train import health as JH
from repro.train.trainer import init_train_state as j_init_train_state
from repro.train.trainer import make_train_step as j_make_train_step
from repro_torch.configs.base import get_config, list_archs, reduced_config
from repro_torch.data.pipeline import SyntheticLM, device_batches
from repro_torch.launch import train as train_cli
from repro_torch.models.convert import params_from_numpy, tree_from_flat
from repro_torch.models.model import (
    CROSS_INPUT,
    _pick_chunk,
    forward_prefill,
    init_params,
    loss_fn,
    softmax_xent,
    softmax_xent_chunked,
)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import health as H
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.models.parallel import single_device_ctx
from repro_torch.train.trainer import init_train_state, make_train_step

ARCH = "smollm-360m"
# the archs whose training runs are stored; smollm's in its head layout
GOLDEN_ARCHS = (ARCH, "qwen3-moe-30b-a3b", "falcon-mamba-7b",
                "recurrentgemma-2b")


def golden_path(arch: str) -> Path:
    return P.DATA / f"{arch.replace('-', '_')}_reduced_train_golden.npz"


GOLDEN = golden_path(ARCH)
# AdamW moves each element by lr x m / sqrt(v), whatever its gradient's
# size: an element whose gradient sits at the f32 noise floor of the two
# packages' summation orders moves differently by a few percent of lr
# (at lr 1e-3, 1.5e-5 in 3 of 120K elements after 3 steps; at 1e-4,
# 1.5e-6), so the run keeps lr below the 1e-5 it is held to
OPT = dict(lr=1e-4, warmup_steps=2, total_steps=10)
# recurrentgemma's gates form sqrt(1 - exp(2 log a)), which cancels as a
# nears 1: half an ulp of exp moves its gradients by more than 1e-5 of a
# leaf's largest (`test_rglru_gates_amplify_half_an_ulp_of_exp`), and at
# lr 1e-4 the card's run (expf: 2 ulp) left the 1e-5 after 3 steps, with
# every kernel or with its plain version alike (ROADMAP Queue 3, B5); at
# lr 1e-5 AdamW's normalised step keeps that below 1e-5
OPTS = {"recurrentgemma-2b": dict(OPT, lr=1e-5)}
DATA = dict(seq=64, batch=4, seed=0)
STEPS = 5
KEPT = (3, STEPS)   # steps after which the parameters are stored
GRAD_TOL = 1e-4     # of each leaf's largest gradient
STEP_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: with several test
    workers on the host, each sizing torch's pool to every core, the
    pools contend (a 60-step run took 135 s at 8 threads under load, 3.6 s
    at one).  Restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tokens(vocab: int, shape, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _grads_close(tgrads: dict, jgrads, tcfg, what: str) -> None:
    """Each port gradient leaf within GRAD_TOL of the JAX package's,
    relative to the leaf's largest gradient."""
    want = dict(params_from_numpy(tcfg, jax.tree.map(np.asarray, jgrads),
                                  device="cpu", masters=True)
                .named_parameters())
    assert sorted(tgrads) == sorted(want)
    for name, g in tgrads.items():
        w = want[name].detach().numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_TOL,
                                   atol=GRAD_TOL * scale,
                                   err_msg=f"{what} {name}")


def _port_grads(params, batch, cfg):
    names, leaves = zip(*params.named_parameters())
    total, metrics = loss_fn(params, batch, cfg)
    grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                materialize_grads=True)
    return (total.detach(), {k: v.detach() for k, v in metrics.items()},
            dict(zip(names, grads)))


# ---------------- losses ------------------------------------------------------


class TestLosses:
    @pytest.mark.parametrize("shape", [(2, 5, 48), (1, 7, 256)])
    def test_softmax_xent_and_grad_equal_jax(self, shape):
        rng = np.random.default_rng(sum(shape))
        logits = (3 * rng.normal(size=shape)).astype(np.float32)
        targets = _tokens(shape[-1], shape[:2], 1)
        (jt, jce), jg = jax.value_and_grad(
            lambda x: j_softmax_xent(x, jnp.asarray(targets)),
            has_aux=True)(jnp.asarray(logits))
        x = torch.from_numpy(logits).requires_grad_()
        total, ce = softmax_xent(x, torch.from_numpy(targets))
        (g,) = torch.autograd.grad(total, x)
        np.testing.assert_allclose(float(total.detach()), float(jt),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(ce.detach()), float(jce), rtol=1e-6)
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-7,
                                   rtol=1e-5)

    @pytest.mark.parametrize("V,chunk", [(48, 16), (256, 100), (50, 7)])
    def test_chunked_xent_and_grads_equal_jax(self, V, chunk):
        assert _pick_chunk(V, chunk) == __import__(
            "repro.models.model", fromlist=["_pick_chunk"])._pick_chunk(
                V, chunk)
        rng = np.random.default_rng(V)
        x = rng.normal(size=(2, 6, 16)).astype(np.float32)
        head = (0.5 * rng.normal(size=(16, V))).astype(np.float32)
        targets = _tokens(V, (2, 6), 2)
        (jt, jce), (jgx, jgh) = jax.value_and_grad(
            lambda a, b: j_softmax_xent_chunked(a, b, jnp.asarray(targets),
                                                chunk),
            argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(head))
        tx, th = (torch.from_numpy(a).requires_grad_() for a in (x, head))
        total, ce = softmax_xent_chunked(tx, th, torch.from_numpy(targets),
                                         chunk)
        gx, gh = torch.autograd.grad(total, (tx, th))
        np.testing.assert_allclose(float(total.detach()), float(jt),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(ce.detach()), float(jce), rtol=1e-5)
        for got, want in ((gx, jgx), (gh, jgh)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=1e-6, rtol=1e-5)
        # the chunked loss is the full one
        full, _ = softmax_xent(tx @ th, torch.from_numpy(targets))
        np.testing.assert_allclose(float(total.detach()),
                                   float(full.detach()), rtol=1e-5)


# ---------------- attention gradients ----------------------------------------


class TestAttentionGrads:
    """The flash backward kernel's plain counterpart (autograd through
    `flash_attention_ref`, what `flash_attention` runs on the CPU)
    against `jax.grad` of the attention the JAX package trains through,
    `chunked_attention` (attention.py:85), within 2e-5 of each
    gradient's largest value (the kernels' f32 tolerance)."""

    @pytest.mark.parametrize("case", [  # B, Hq, Hkv, Sq, Sk, hd, causal, window
        (2, 6, 2, 24, 24, 64, True, 0), (1, 4, 1, 20, 20, 32, True, 6),
        (1, 4, 4, 16, 40, 16, False, 0), (1, 2, 1, 12, 30, 160, True, 0)])
    def test_grads_equal_jax_chunked_attention(self, case):
        from repro.models.attention import chunked_attention
        from repro_torch.kernels.flash_attention import flash_attention

        B, Hq, Hkv, Sq, Sk, hd, causal, window = case
        rng = np.random.default_rng(sum(case[:6]))
        q, do = (rng.normal(size=(B, Hq, Sq, hd)).astype(np.float32)
                 for _ in range(2))
        k, v = (rng.normal(size=(B, Hkv, Sk, hd)).astype(np.float32)
                for _ in range(2))
        qpos = jnp.arange(Sq, dtype=jnp.int32) + (Sk - Sq)
        kpos = jnp.arange(Sk, dtype=jnp.int32)
        _, vjp = jax.vjp(lambda a, b, c: chunked_attention(
            a, b, c, qpos, kpos, causal=causal, window=window, chunk_q=8,
            chunk_k=8), *(jnp.asarray(t) for t in (q, k, v)))
        want = vjp(jnp.asarray(do))
        tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
        o = flash_attention(tq, tk, tv, causal=causal, window=window)
        got = torch.autograd.grad(o, (tq, tk, tv), torch.from_numpy(do))
        for name, g, w in zip(("dq", "dk", "dv"), got, want):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-5,
                                       atol=2e-5 * np.abs(w).max(),
                                       err_msg=name)

    def test_backward_head_dims(self):
        from repro_torch.kernels.flash_attention.kernel import bwd_head_dim

        assert [bwd_head_dim(h) for h in (1, 16, 48, 64, 160, 256)] == [
            16, 16, 64, 64, 256, 256]
        for hd in (257, 320, 1024):
            with pytest.raises(ValueError, match="backward.*6b"):
                bwd_head_dim(hd)


# ---------------- loss_fn gradients -----------------------------------------


def _qwen3_models():
    """Reduced qwen3-moe in f32 (its reduced layout, hd 16, 2 query heads
    a KV head), the JAX package's parameters, constants perturbed."""
    arch = "qwen3-moe-30b-a3b"
    jcfg, tcfg = P.cfgs(arch, "float32", layout=False)
    jp = P.perturb(j_init_params(jcfg, jax.random.key(3)), 3)
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu",
                           masters=True)
    return jcfg, tcfg, jp, tp


def _smollm_models():
    jcfg, tcfg = P.cfgs(ARCH, "float32")
    jp = P.j_params(ARCH)
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu",
                           masters=True)
    return jcfg, tcfg, jp, tp


@functools.lru_cache(maxsize=None)
def _j_reduced_params(arch: str, seed: int = 0):
    """The JAX package's reduced f32 parameters of an arch in its reduced
    layout, constants perturbed (P.perturb)."""
    jcfg, _ = P.cfgs(arch, "float32", layout=False)
    return P.perturb(j_init_params(jcfg, jax.random.key(seed)), seed)


def _reduced_models(arch: str):
    """(jcfg, tcfg, JAX params, the port's masters) of `arch` reduced in
    f32, in its reduced layout (hd 16, two query heads a KV head; the
    layout the kernels see matters on the card, not here)."""
    jcfg, tcfg = P.cfgs(arch, "float32", layout=False)
    jp = _j_reduced_params(arch)
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu",
                           masters=True)
    return jcfg, tcfg, jp, tp


def _models(arch: str):
    if arch == ARCH:
        return _smollm_models()
    if arch == "qwen3-moe-30b-a3b":
        return _qwen3_models()
    return _reduced_models(arch)


# (arch, vocab chunk): the loss's chunking is arch-independent, so only
# the first two archs take both
LOSS_CASES = [(a, c) for a in (ARCH, "qwen3-moe-30b-a3b")
              for c in (0, 64)] + [
    (a, 0) for a in ("deepseek-moe-16b", "falcon-mamba-7b",
                     "recurrentgemma-2b")]


class TestLossFnGrads:
    @pytest.mark.parametrize("arch,chunk", LOSS_CASES,
                             ids=[f"{a}-{c}" for a, c in LOSS_CASES])
    def test_loss_and_every_grad_equal_jax(self, arch, chunk):
        jcfg, tcfg, jp, tp = _models(arch)
        jcfg = jcfg.replace(loss_chunk_vocab=chunk)
        tcfg = tcfg.replace(loss_chunk_vocab=chunk)
        toks = _tokens(tcfg.vocab_size, (2, 12), 4)
        tgts = _tokens(tcfg.vocab_size, (2, 12), 5)
        (jtot, jm), jg = jax.jit(jax.value_and_grad(
            lambda p: j_loss_fn(p, {"tokens": jnp.asarray(toks),
                                    "targets": jnp.asarray(tgts)},
                                jcfg, P.PCTX), has_aux=True))(jp)
        total, metrics, grads = _port_grads(
            tp, {"tokens": torch.from_numpy(toks).long(),
                 "targets": torch.from_numpy(tgts).long()}, tcfg)
        np.testing.assert_allclose(float(total), float(jtot), rtol=1e-5)
        for k in ("loss", "aux", "total"):
            np.testing.assert_allclose(float(metrics[k]), float(jm[k]),
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        if tcfg.moe is not None:   # the router aux term takes part
            assert float(metrics["aux"]) > 0
            routers = [k for k in grads if k.endswith(".moe.router")]
            assert routers and all(float(grads[k].abs().max()) > 0
                                   for k in routers)
        _grads_close(grads, jg, tcfg, tcfg.name)

    def test_masters_give_the_serving_forward_bits(self):
        """Masters cast at every use: bf16 logits equal the serving
        tree's, whose weights are stored in the compute dtype."""
        cfg = reduced_config(get_config(ARCH)).replace(
            **P.LAYOUTS[ARCH])
        serve = init_params(cfg, 0, device="cpu")
        masters = init_params(cfg, 0, device="cpu", masters=True)
        for (name, s), (_, m) in zip(serve.named_parameters(),
                                     masters.named_parameters()):
            assert m.dtype == torch.float32 and m.requires_grad, name
            assert not s.requires_grad, name
            assert torch.equal(s, m.detach().to(s.dtype)), name
        batch = {"tokens": torch.from_numpy(_tokens(256, (2, 9), 6)).long()}
        with torch.no_grad():
            a, _ = forward_prefill(serve, batch, cfg)
            b, _ = forward_prefill(masters, batch, cfg)
        assert torch.equal(a, b)

    @pytest.mark.parametrize("arch", list_archs())
    def test_every_arch_trains_on_the_cpu(self, arch):
        """The plain versions under autograd: a finite loss and a
        gradient on every mixer's weights (the kernels' archs too)."""
        cfg = reduced_config(get_config(arch)).replace(
            compute_dtype="float32")
        params = init_params(cfg, 0, device="cpu", masters=True)
        toks = torch.from_numpy(_tokens(cfg.vocab_size, (2, 10), 7)).long()
        batch = {"tokens": toks, "targets": toks.roll(-1, 1)}
        name = CROSS_INPUT.get(cfg.family)
        if name:
            batch[name] = torch.randn(2, 6, cfg.d_model)
        total, _, grads = _port_grads(params, batch, cfg)
        assert torch.isfinite(total)
        mixers = [k for k in grads if any(
            f".{m}." in k for m in ("attn", "xattn", "mixer", "rec", "moe"))]
        assert mixers
        for k in mixers:
            assert torch.isfinite(grads[k]).all(), k
        assert all(float(grads[k].abs().max()) > 0 for k in mixers
                   if not k.endswith(("bq", "bk", "bv", ".b_in", ".b")))


# ---------------- train steps against the JAX package ------------------------


@functools.lru_cache(maxsize=None)
def train_golden_reference(arch: str = ARCH) -> dict:
    """The JAX package's `make_train_step` run that the port (and the
    card, chip_smoke.py) is held to: reduced `arch` in f32 (smollm-360m in
    its head layout, the others in their reduced one), its parameters,
    SyntheticLM batches, `STEPS` steps; each step's loss, grad norm and
    lr, the parameters after steps 3 and `STEPS` (``after3/...``,
    ``after5/...``)."""
    if arch == ARCH:
        jcfg, _ = P.cfgs(ARCH, "float32")
        params, layout = P.j_params(ARCH), P.LAYOUTS[ARCH]
    else:
        jcfg, _ = P.cfgs(arch, "float32", layout=False)
        params, layout = _j_reduced_params(arch), {}
    opt = OPTS.get(arch, OPT)
    step = jax.jit(j_make_train_step(jcfg, P.PCTX, JAdamWConfig(**opt)))
    state = j_init_train_state(jcfg, params)
    src = JSyntheticLM(jcfg.vocab_size, DATA["seq"], DATA["batch"],
                       seed=DATA["seed"])
    out = {"config": np.array(json.dumps(layout, sort_keys=True)),
           "opt": np.array(json.dumps(opt, sort_keys=True)),
           "data": np.array(json.dumps(DATA, sort_keys=True))}
    out.update({f"param/{k}": v for k, v in P._flat(params).items()})
    rows = {"loss": [], "grad_norm": [], "lr": []}
    for i in range(STEPS):
        state, m = step(state, jax.tree.map(jnp.asarray, src.batch_at(i)))
        for k in rows:
            rows[k].append(float(m[k]))
        if i + 1 in KEPT:
            out.update({f"after{i + 1}/{k}": v
                        for k, v in P._flat(state["params"]).items()})
    out.update({k: np.asarray(v, np.float32) for k, v in rows.items()})
    return out


def _stored(arch: str = ARCH):
    return dict(np.load(golden_path(arch)))


def _port_run(stored, steps: int, arch: str = ARCH, **cfg_kw):
    """The port's run from the stored parameters on the CPU: (cfg, state,
    per-step metrics as floats)."""
    cfg = reduced_config(get_config(arch)).replace(
        compute_dtype="float32", **json.loads(str(stored["config"])),
        **cfg_kw)
    params = params_from_numpy(cfg, tree_from_flat(
        {k[len("param/"):]: v for k, v in stored.items()
         if k.startswith("param/")}), device="cpu", masters=True)
    state = init_train_state(cfg, params)
    step = make_train_step(cfg, single_device_ctx(),
                           AdamWConfig(**json.loads(str(stored["opt"]))))
    data = json.loads(str(stored["data"]))
    batches = device_batches(SyntheticLM(cfg.vocab_size, data["seq"],
                                         data["batch"], seed=data["seed"]),
                             0, "cpu")
    rows = []
    for _ in range(steps):
        state, m = step(state, next(batches))
        rows.append({k: float(v) for k, v in m.items()})
    return cfg, state, rows


def _golden_is_current(arch: str) -> None:
    stored, golden = _stored(arch), train_golden_reference(arch)
    assert sorted(stored) == sorted(golden)
    for key, want in golden.items():
        if want.dtype.kind == "f":
            np.testing.assert_allclose(stored[key], want, rtol=1e-6,
                                       atol=1e-7, err_msg=key)
        else:
            np.testing.assert_array_equal(stored[key], want, err_msg=key)
    assert golden_path(arch).stat().st_size < 4 * 2**20


# (arch, steps): smollm's cases keep their ids
STEP_CASES = [pytest.param(a, n, id=str(n) if a == ARCH else f"{a}-{n}")
              for a in GOLDEN_ARCHS for n in KEPT]


class TestTrainSteps:
    def test_stored_train_golden_is_current(self):
        _golden_is_current(ARCH)

    @pytest.mark.parametrize("arch", GOLDEN_ARCHS[1:])
    def test_stored_arch_train_golden_is_current(self, arch):
        _golden_is_current(arch)

    @pytest.mark.parametrize("arch,steps", STEP_CASES)
    def test_train_steps_equal_jax_make_train_step(self, arch, steps):
        stored = _stored(arch)
        cfg, state, rows = _port_run(stored, steps, arch)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose([r[k] for r in rows],
                                       stored[k][:steps], rtol=1e-5,
                                       err_msg=k)
        want = params_from_numpy(cfg, tree_from_flat(
            {k.split("/", 1)[1]: v for k, v in stored.items()
             if k.startswith(f"after{steps}/")}), device="cpu",
            masters=True)
        got = dict(state["params"].named_parameters())
        for name, w in want.named_parameters():
            np.testing.assert_allclose(got[name].detach().numpy(),
                                       w.detach().numpy(), err_msg=name,
                                       **STEP_TOL)
        assert int(state["opt"]["step"]) == steps

    def test_remat_does_not_change_the_step(self):
        stored = _stored()
        _, a, ra = _port_run(stored, 2)
        _, b, rb = _port_run(stored, 2, remat="none")
        assert ra == rb
        for (n, x), (_, y) in zip(a["params"].named_parameters(),
                                  b["params"].named_parameters()):
            assert torch.equal(x, y), n

    def test_rglru_gates_amplify_half_an_ulp_of_exp(self, monkeypatch):
        """B5 (ROADMAP Queue 3): recurrentgemma's gate sqrt(1 - exp(2 log
        a)) cancels as a nears 1, so exp's last bit reaches the gradients.
        The stored run's first step on the CPU with every exp of the gates
        moved by -1/2, 0 or +1/2 ulp (a hash of its argument's bits picks,
        so that remat's recompute moves it alike): some gradient leaf
        moves by more than 1e-5 of its largest value, the tolerance the
        parameters are held to."""
        import repro_torch.models.rglru as R

        stored = _stored("recurrentgemma-2b")
        cfg, state, _ = _port_run(stored, 0, "recurrentgemma-2b")
        data = json.loads(str(stored["data"]))
        batch = next(device_batches(SyntheticLM(
            cfg.vocab_size, data["seq"], data["batch"], seed=data["seed"]),
            0, "cpu"))
        exact = _port_grads(state["params"], batch, cfg)[2]

        def exp(x):   # torch.exp, moved by -1/2, 0 or +1/2 ulp
            y = torch.exp(x)
            bits = x.detach().contiguous().view(torch.int32).long()
            u = ((bits * 2654435761) >> 13) % 3 - 1
            return y + u * y * torch.finfo(torch.float32).eps / 2

        def gates(p, x, tp=None):   # R._gates with `exp`, one process
            assert tp is None
            r = torch.sigmoid((x @ p["w_a"].to(x.dtype)).float())
            i = torch.sigmoid((x @ p["w_i"].to(x.dtype)).float())
            log_a = -R._C * F.softplus(p["lambda"]) * r
            beta = torch.sqrt(torch.clamp(1.0 - exp(2.0 * log_a), min=1e-12))
            return exp(log_a), beta * (i * x.float())

        monkeypatch.setattr(R, "_gates", gates)
        moved = _port_grads(state["params"], batch, cfg)[2]
        rel = max(float((moved[k] - g).abs().max() / g.abs().max())
                  for k, g in exact.items() if g.abs().max() > 0)
        print(f"largest move {rel:.3g} of a leaf's largest gradient")
        assert 1e-5 < rel < 1e-3, rel

    def test_loss_decreases(self):
        cfg = reduced_config(get_config(ARCH)).replace(num_layers=2,
                                                       vocab_size=64)
        state = init_train_state(cfg, init_params(cfg, 0, device="cpu",
                                                  masters=True))
        step = make_train_step(cfg, single_device_ctx(),
                               AdamWConfig(lr=2e-3, warmup_steps=5,
                                           total_steps=60))
        batches = device_batches(SyntheticLM(cfg.vocab_size, 32, 8, seed=0),
                                 0, "cpu")
        losses = []
        for _ in range(60):
            state, m = step(state, next(batches))
            losses.append(float(m["loss"]))
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        assert last < first - 0.5, f"not learning: {first:.3f} -> {last:.3f}"
        assert last < np.log(cfg.vocab_size)   # beats uniform


# ---------------- checkpoints --------------------------------------------------


def _tiny_state(seed: int = 0):
    cfg = reduced_config(get_config(ARCH)).replace(num_layers=2,
                                                   vocab_size=64)
    return cfg, init_train_state(cfg, init_params(cfg, seed, device="cpu",
                                                  masters=True))


def _leaves(state) -> dict:
    out = {f"p/{k}": v.detach() for k, v in state["params"].named_parameters()}
    for part in ("m", "v"):
        out.update({f"{part}/{k}": v for k, v in state["opt"][part].items()})
    out["step"] = state["opt"]["step"]
    return out


class TestCheckpoint:
    def test_roundtrip_with_layout(self, tmp_path):
        _, state = _tiny_state()
        ck = Checkpointer(str(tmp_path), keep=2)
        ck.save(100, state, extra={"note": 1}, blocking=True)
        d = tmp_path / "step_00000100"
        manifest = json.loads((d / "manifest.json").read_text())
        assert manifest["step"] == 100 and manifest["extra"] == {"note": 1}
        keys = set(np.load(d / "arrays.npz").files)
        assert {"params/embed", "params/stack/0/attn/wq", "opt/step",
                "opt/m/stack/1/ffn/w_down"} <= keys
        assert keys == set(manifest["keys"])
        _, fresh = _tiny_state(seed=1)
        restored, step = ck.restore(fresh)
        assert step == 100 and restored is fresh
        want, got = _leaves(state), _leaves(restored)
        for k in want:
            assert torch.equal(want[k], got[k]), k
        assert all(p.requires_grad
                   for p in restored["params"].parameters())

    def test_restore_checks_shapes(self, tmp_path):
        _, state = _tiny_state()
        ck = Checkpointer(str(tmp_path))
        ck.save(1, state, blocking=True)
        cfg = reduced_config(get_config(ARCH)).replace(num_layers=2,
                                                       vocab_size=128)
        other = init_train_state(cfg, init_params(cfg, 0, device="cpu",
                                                  masters=True))
        with pytest.raises(ValueError, match="params/embed"):
            ck.restore(other)

    def test_keep_last_k(self, tmp_path):
        _, state = _tiny_state()
        ck = Checkpointer(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            ck.save(s, state, blocking=True)
        assert ck.steps() == [3, 4] and ck.latest_step() == 4

    def test_async_save_then_wait(self, tmp_path):
        _, state = _tiny_state()
        before = _leaves(state)
        before = {k: v.clone() for k, v in before.items()}
        ck = Checkpointer(str(tmp_path))
        ck.save(3, state, blocking=False)
        with torch.no_grad():   # the loop writes on while the thread saves
            for p in state["params"].parameters():
                p.add_(1.0)
        ck.wait()
        assert ck.latest_step() == 3
        _, fresh = _tiny_state(seed=2)
        got = _leaves(ck.restore(fresh)[0])
        for k in before:
            assert torch.equal(before[k], got[k]), k

    def test_restart_repeats_the_run_bit_for_bit(self, tmp_path):
        cfg, state = _tiny_state()
        step = make_train_step(cfg, single_device_ctx(),
                               AdamWConfig(lr=1e-3, warmup_steps=2,
                                           total_steps=6))
        src = SyntheticLM(cfg.vocab_size, 16, 4, seed=0)
        ck = Checkpointer(str(tmp_path))
        straight = []
        for i, batch in zip(range(6), device_batches(src, 0, "cpu")):
            state, m = step(state, batch)
            straight.append(float(m["loss"]))
            if i == 2:
                ck.save(3, state)
        ck.wait()
        _, fresh = _tiny_state(seed=5)
        fresh, start = ck.restore(fresh)
        assert start == 3 and int(fresh["opt"]["step"]) == 3
        again = []
        for _, batch in zip(range(3), device_batches(src, start, "cpu")):
            fresh, m = step(fresh, batch)
            again.append(float(m["loss"]))
        assert again == straight[3:]
        want, got = _leaves(state), _leaves(fresh)
        for k in want:
            assert torch.equal(want[k], got[k]), k


# ---------------- fleet health -------------------------------------------------


def _script(mod):
    """The same heartbeat script through a module's monitor: w2 dies at
    step 6, w1 runs 3x slow from step 3; each step's check, then the
    restart plan."""
    mon = mod.FleetMonitor([f"w{i}" for i in range(4)],
                           mod.HealthConfig(timeout_steps=3, patience=3))
    decisions = []
    for step in range(1, 13):
        for w in sorted(mon.workers):
            if w == "w2" and step >= 6:
                continue
            mon.heartbeat(w, step, 3.0 if w == "w1" and step >= 3 else 1.0)
        decisions.append((mon.check(step), mon.healthy(),
                          mon.median_duration()))
    plan = mod.RestartPlan.from_failure(mon, 8, devices_per_worker=2,
                                        model_axis=2)
    return decisions, dataclasses.asdict(plan)


class TestHealth:
    def test_decisions_equal_the_jax_package(self):
        got, want = _script(H), _script(JH)
        assert got == want
        decisions, plan = got
        assert any(d[0]["dead"] == ["w2"] for d in decisions)
        assert any(d[0]["stragglers"] == ["w1"] for d in decisions)
        assert plan["surviving_workers"] == ["w0", "w3"]


# ---------------- launcher -----------------------------------------------------


class TestLauncher:
    def test_main_trains_on_the_cpu(self, capsys, tmp_path):
        run = train_cli.main(["--device", "cpu", "--reduced", "--steps", "3",
                              "--ckpt-dir", str(tmp_path),
                              "--trainer", "gspmd"])
        out = capsys.readouterr().out
        assert "floor=" in out and "done: loss" in out
        assert len(run["losses"]) == len(run["step_s"]) == 3
        assert all(np.isfinite(run["losses"]))
        assert Checkpointer(str(tmp_path)).latest_step() == 3
        resumed = train_cli.main(["--device", "cpu", "--reduced", "--steps",
                                  "4", "--ckpt-dir", str(tmp_path),
                                  "--resume"])
        assert resumed["start_step"] == 3 and len(resumed["losses"]) == 1

    def test_both_trainers_give_the_same_run(self):
        a, b = (train_cli.main(["--device", "cpu", "--reduced", "--steps",
                                "2", "--trainer", t])
                for t in ("opera-dp", "gspmd"))
        assert a["losses"] == b["losses"]

    @pytest.mark.parametrize("flags", [["--mesh", "pod"],
                                       ["--mesh", "multipod"],
                                       ["--tp", "2"], ["--compress-grads"]])
    def test_multi_process_flags_raise(self, flags):
        """The pod meshes on a world of one rank raise, naming item 7c;
        ``--tp 2`` on a world of one rank raises a ValueError (two model
        ranks need a world of a multiple of two); ``--compress-grads``
        trains (opera-dp's int8 gradient sync over a mesh of one rank)."""
        argv = ["--device", "cpu", "--reduced", "--steps", "2", *flags]
        if flags == ["--compress-grads"]:
            run = train_cli.main(argv)
            assert len(run["losses"]) == 2 and all(np.isfinite(run["losses"]))
            return
        if flags == ["--tp", "2"]:
            with pytest.raises(ValueError, match="--tp 2 does not divide"):
                train_cli.main(argv)
            return
        with pytest.raises(NotImplementedError, match="item 7c"):
            train_cli.main(argv)

    def test_the_full_config_is_the_default_as_in_the_reference(
            self, monkeypatch):
        """F5: both launchers train the full config unless given
        ``--reduced`` (src/repro/launch/train.py:35); the port's
        ``--no-reduced`` is still accepted.  Each launcher is stopped
        after its config is chosen."""
        import repro.launch.train as JT

        class Stop(Exception):
            pass

        def stop(*a, **k):
            raise Stop

        def reduced_under(mod, argv, stop_at):
            calls = []
            real = mod.reduced_config
            monkeypatch.setattr(mod, "reduced_config",
                                lambda c: calls.append(1) or real(c))
            monkeypatch.setattr(mod, stop_at, stop)
            with pytest.raises(Stop):
                mod.main(argv)
            return bool(calls)

        for argv, want in (([], False), (["--reduced"], True)):
            assert reduced_under(JT, argv, "make_host_mesh") is want
            assert reduced_under(train_cli, ["--device", "cpu", *argv],
                                 "init_params") is want
        assert not reduced_under(train_cli, ["--device", "cpu",
                                             "--no-reduced"], "init_params")

    def test_module_runs(self):
        root = Path(__file__).resolve().parents[1]
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--device",
             "cpu", "--reduced", "--steps", "3"], capture_output=True,
            text=True, timeout=300, cwd=root,
            env={**os.environ, "PYTHONPATH": str(root / "src"),
                 "OMP_NUM_THREADS": "1"})
        assert proc.returncode == 0, proc.stderr
        assert "[train] done: loss" in proc.stdout


if __name__ == "__main__":
    for arch in sys.argv[1:] or GOLDEN_ARCHS:
        data = train_golden_reference(arch)
        path = golden_path(arch)
        np.savez(path, **data)
        print(f"wrote {path.name}: {len(data)} arrays, "
              f"{path.stat().st_size} bytes", file=sys.stderr)

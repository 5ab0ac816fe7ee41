"""The port's optimizer and data pipeline against the JAX package's, on
the CPU.

`optim.adamw` on the same seeded numpy parameters and gradients as
`repro.optim.adamw`: one and several steps, clipping (the norm reported
before it), no decay on norm scales and biases, `lr_at` over the
warmup and the cosine schedule; parameters and moments within float32
rounding (atol 1e-6, rtol 1e-5: the same operations in another
summation order).  `SyntheticLM` is a numpy copy: its batches equal the
JAX package's bit for bit, and `device_batches` hands them over as int64
tensors.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import adamw as JA
from repro_torch.data.pipeline import SyntheticLM, device_batches
from repro_torch.optim import adamw as A

TOL = dict(atol=1e-6, rtol=1e-5)
# leaf names as a ParamTree names them; the decay mask reads the last part
SHAPES = {"w": (4, 6), "ln.scale": (6,), "attn.bq": (6,), "ffn.w_up": (6, 3),
          "mixer.D": (5,), "rec.lambda": (3,), "embed": (7, 4)}


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


def _nested(flat: dict) -> dict:
    out: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _pair(seed: int, scale: float = 1.0):
    """(port params, JAX params) of the same seeded values."""
    rng = np.random.default_rng(seed)
    arrs = {k: (scale * rng.normal(size=s)).astype(np.float32)
            for k, s in SHAPES.items()}
    return ({k: torch.from_numpy(a.copy()) for k, a in arrs.items()},
            _nested({k: jnp.asarray(a) for k, a in arrs.items()}))


def _flat(jtree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in jtree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _close(port: dict, jax_tree: dict) -> None:
    want = _flat(jax_tree)
    assert sorted(port) == sorted(want)
    for k, v in port.items():
        np.testing.assert_allclose(v.numpy(), want[k], err_msg=k, **TOL)


def _run(c_kw: dict, steps: int, grad_scale: float = 1.0, seed: int = 0):
    """`steps` AdamW steps through both packages on the same seeded
    gradients; returns the port's and the JAX package's (params, state,
    metrics of each step)."""
    c, jc = A.AdamWConfig(**c_kw), JA.AdamWConfig(**c_kw)
    tp, jp = _pair(seed)
    ts, js = A.init_opt_state(tp), JA.init_opt_state(jp)
    tms, jms = [], []
    for i in range(steps):
        tg, jg = _pair(seed + 100 + i, grad_scale)
        tp, ts, tm = A.adamw_update(c, tp, tg, ts)
        jp, js, jm = JA.adamw_update(jc, jp, jg, js)
        tms.append(tm)
        jms.append(jm)
    return (tp, ts, tms), (jp, js, jms)


class TestAdamW:
    @pytest.mark.parametrize("steps", [1, 4])
    @pytest.mark.parametrize("weight_decay", [0.0, 0.1])
    def test_update_equals_jax(self, steps, weight_decay):
        (tp, ts, tms), (jp, js, jms) = _run(
            dict(lr=1e-2, warmup_steps=2, total_steps=6,
                 weight_decay=weight_decay), steps)
        _close(tp, jp)
        _close(ts["m"], js["m"])
        _close(ts["v"], js["v"])
        assert int(ts["step"]) == int(js["step"]) == steps
        assert ts["step"].dtype == torch.int32
        for tm, jm in zip(tms, jms):
            for k in ("grad_norm", "lr"):
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-6, err_msg=k)

    def test_clipping_equals_jax(self):
        (tp, _, tms), (jp, _, jms) = _run(
            dict(clip_norm=1.0, warmup_steps=1), 2, grad_scale=1e6)
        assert float(tms[0]["grad_norm"]) > 1e5   # reported before clipping
        np.testing.assert_allclose(float(tms[0]["grad_norm"]),
                                   float(jms[0]["grad_norm"]), rtol=1e-6)
        _close(tp, jp)

    def test_no_decay_on_norm_scales_and_biases(self):
        c = A.AdamWConfig(lr=0.1, weight_decay=1.0, warmup_steps=1)
        tp, _ = _pair(0)
        before = {k: v.clone() for k, v in tp.items()}
        zero = {k: torch.zeros_like(v) for k, v in tp.items()}
        A.adamw_update(c, tp, zero, A.init_opt_state(tp))
        for name, v in tp.items():
            decays = name.split(".")[-1] in ("w", "w_up", "embed")
            assert A._decay_mask(name) == decays, name
            if decays:
                assert torch.all(v.abs() < before[name].abs()), name
            else:
                assert torch.equal(v, before[name]), name

    def test_updates_a_param_tree_in_place(self):
        from repro_torch.configs.base import get_config, reduced_config
        from repro_torch.models.model import init_params

        cfg = reduced_config(get_config("smollm-360m"))
        params = init_params(cfg, 0, device="cpu", masters=True)
        leaves = dict(params.named_parameters())
        before = {k: v.detach().clone() for k, v in leaves.items()}
        state = A.init_opt_state(params)
        grads = {k: torch.ones_like(v) for k, v in leaves.items()}
        out, state, _ = A.adamw_update(A.AdamWConfig(warmup_steps=1),
                                       params, grads, state)
        assert out is params and int(state["step"]) == 1
        for k, v in params.named_parameters():
            assert v is leaves[k] and v.requires_grad
            assert not torch.equal(v.detach(), before[k]), k

    @pytest.mark.parametrize(
        "step", [0, 1, 50, 99, 100, 101, 500, 5000, 9999, 10_000, 13_337,
                 20_000])
    def test_lr_schedule_equals_jax(self, step):
        kw = dict(lr=3e-4, warmup_steps=100, total_steps=10_000)
        got = A.lr_at(A.AdamWConfig(**kw), torch.tensor(step))
        want = JA.lr_at(JA.AdamWConfig(**kw), jnp.asarray(step))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)

    @pytest.mark.parametrize("s", [0.1, 3.7, 100.0])
    def test_global_norm_equals_jax(self, s):
        tp, jp = _pair(5, s)
        np.testing.assert_allclose(float(A.global_norm(tp)),
                                   float(JA.global_norm(jp)), rtol=1e-6)


class TestPipeline:
    @pytest.mark.parametrize("vocab,seq,batch,seed,step", [
        (128, 16, 4, 7, 13), (256, 64, 4, 0, 0), (49_152, 33, 3, 2, 5)])
    def test_batches_equal_the_jax_package(self, vocab, seq, batch, seed,
                                           step):
        got = SyntheticLM(vocab, seq, batch, seed=seed).batch_at(step)
        want = JSyntheticLM(vocab, seq, batch, seed=seed).batch_at(step)
        assert sorted(got) == sorted(want) == ["targets", "tokens"]
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
        assert (SyntheticLM(vocab, seq, batch, seed=seed)
                .conditional_entropy() == JSyntheticLM(
                    vocab, seq, batch, seed=seed).conditional_entropy())

    def test_device_batches_from_a_step(self):
        src = SyntheticLM(128, 16, 4, seed=7)
        it = device_batches(src, 3, "cpu")
        for step in (3, 4):
            b = next(it)
            for k, v in src.batch_at(step).items():
                assert b[k].dtype == torch.int64 and b[k].device.type == "cpu"
                np.testing.assert_array_equal(b[k].numpy(), v)

    def test_device_batches_refuse_a_missing_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            next(device_batches(SyntheticLM(16, 4, 2), 0))

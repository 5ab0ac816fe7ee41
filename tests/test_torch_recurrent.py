"""The port's recurrent families, falcon-mamba-7b (Mamba-1 SSM) and
recurrentgemma-2b (RG-LRU + local attention), against the JAX package,
on the CPU.

Reduced configs (2 and 5 layers, d_model 64), their parameters drawn by
the JAX package and carried across with `params_from_numpy`; inputs are
seeded numpy arrays handed to both.  Tolerances: f32 compute 1e-4, bf16
compute 2e-2.

Whole bf16 forwards are held to the JAX forward run op by op
(`jax.disable_jit`) with its bf16 activations (`jax.nn.silu`,
`jax.nn.gelu`) computed in f32 and rounded once, as PyTorch computes
them: the JAX package's bf16 activations round inside (their results
differ from the f32 ones rounded once in about a third of the
elements), and its compiled scan keeps excess precision in its fusions.
With both, the port's bf16 logits miss the unmodified JAX forward's by
up to 0.08 (ROADMAP.md Queue 3, B2); with neither, they agree to 1e-6.
The unmodified, compiled JAX forward is held to the port in f32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import reduced_config as j_reduced
from repro.models import attention as JA
from repro.models import kvcache as JK
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro.models import transformer as JT
from repro.models.layers import apply_causal_conv as j_causal_conv
from repro.models.model import count_params as j_count_params
from repro.models.model import forward_decode as j_forward_decode
from repro.models.model import forward_prefill as j_forward_prefill
from repro.models.model import init_params as j_init_params
from repro.models.parallel import single_device_ctx
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.models import attention as A
from repro_torch.models import kvcache as K
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy, tree_from_flat
from repro_torch.models.layers import apply_causal_conv
from repro_torch.models.model import (
    count_params,
    forward_decode,
    forward_prefill,
    init_params,
)
from repro_torch.serve.engine import Request, ServeEngine

MAMBA, RGEMMA = "falcon-mamba-7b", "recurrentgemma-2b"
ARCHS = (MAMBA, RGEMMA)
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PCTX = single_device_ctx()
FULL_PARAMS = {MAMBA: 7_272_665_088, RGEMMA: 2_894_481_920}


def _cfgs(arch, dtype):
    jcfg = j_reduced(j_get_config(arch)).replace(compute_dtype=dtype)
    tcfg = reduced_config(get_config(arch)).replace(compute_dtype=dtype)
    return jcfg, tcfg


def _models(arch, dtype, seed=0):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = j_init_params(jcfg, jax.random.key(seed))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def mamba(request):
    return (request.param,) + _models(MAMBA, request.param)


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def rgemma(request):
    return (request.param,) + _models(RGEMMA, request.param)


def _close(got, want, dtype, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol[dtype])


def _x(shape, dtype, seed, scale=1.0):
    a = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    return torch.from_numpy(a).to(TDT[dtype]), jnp.asarray(a, dtype)


def _jlayer(jp, block, i):
    return jax.tree.map(lambda a: a[i], jp["stack"]["blocks"][str(block)])


class TestConfig:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_configs_equal_the_jax_package(self, arch):
        for j, t in (_cfgs(arch, "bfloat16"),
                     (j_get_config(arch), get_config(arch))):
            assert dataclasses.asdict(t) == dataclasses.asdict(j)

    @pytest.mark.parametrize("reduced", [True, False])
    @pytest.mark.parametrize("arch", ARCHS)
    def test_param_count_matches_jax(self, arch, reduced):
        jcfg, tcfg = j_get_config(arch), get_config(arch)
        if reduced:
            jcfg, tcfg = j_reduced(jcfg), reduced_config(tcfg)
        else:
            assert count_params(tcfg) == FULL_PARAMS[arch]
        assert count_params(tcfg) == j_count_params(jcfg)
        assert count_params(tcfg, True) == j_count_params(jcfg, True)

    @pytest.mark.parametrize("reduced", [True, False])
    @pytest.mark.parametrize("arch", ARCHS)
    def test_stack_plan_and_cache_shapes_match_jax(self, arch, reduced):
        jcfg, tcfg = j_get_config(arch), get_config(arch)
        if reduced:
            jcfg, tcfg = j_reduced(jcfg), reduced_config(tcfg)
        jplan, plan = JT.stack_plan(jcfg), T.stack_plan(tcfg)
        assert (plan.pattern, plan.n_scan, plan.tail) == (
            jplan.pattern, jplan.n_scan, jplan.tail)
        if arch == RGEMMA and not reduced:
            assert plan.kinds.count("rglru") == 18
            assert plan.kinds.count("local_attn") == 8
        for kind in set(plan.kinds):
            for L in (6, 4096):
                want = JK.layer_cache_shape(jcfg, kind, 3, L)
                got = K.layer_cache_shape(tcfg, kind, 3, L)
                assert {n: s for n, (s, _) in got.items()} == {
                    n: s for n, (s, _) in want.items()}
                assert {n: str(d).replace("torch.", "")
                        for n, (_, d) in got.items()} == {
                    n: str(d) for n, (_, d) in want.items()}

    def test_cache_stacks_each_kind(self):
        _, tcfg = _cfgs(RGEMMA, "float32")
        caches = K.init_cache(tcfg, 2, 16)
        kinds = T.stack_plan(tcfg).kinds
        assert [sorted(c) for c in caches] == [
            ["conv", "lru"] if k == "rglru" else ["k", "v"] for k in kinds]
        assert caches[2]["k"].shape == (2, 2, 8, 16)   # the ring: window 8
        caches[0]["lru"].fill_(1.0)
        assert float(caches[1]["lru"].abs().sum()) == 0.0

    @pytest.mark.parametrize("arch", ARCHS)
    def test_init_params_shapes_and_storage_dtypes(self, arch):
        _, tcfg = _cfgs(arch, "bfloat16")
        tp = init_params(tcfg, 0, device="cpu")
        assert sum(p.numel() for p in tp.parameters()) == count_params(tcfg)
        layer = tp["stack"][0]
        if arch == MAMBA:
            m = layer["mixer"]
            assert m["in_proj"].dtype == m["conv"]["w"].dtype == torch.bfloat16
            for name in ("A_log", "D", "dt_bias"):
                assert m[name].dtype == torch.float32
            assert torch.equal(m["A_log"][3], torch.log(torch.arange(1., 5.)))
            step = torch.nn.functional.softplus(m["dt_bias"])
            assert 1e-3 <= float(step.min()) and float(step.max()) <= 1e-1
            assert tp["lm_head"].dtype == torch.float32
        else:
            rec = layer["rec"]
            assert rec["w_a"].dtype == rec["conv"]["b"].dtype == torch.bfloat16
            a_c = torch.exp(-8 * torch.nn.functional.softplus(rec["lambda"]))
            assert 0.9 <= float(a_c.min()) and float(a_c.max()) <= 0.999 + 1e-6
            assert tp["embed"].dtype == torch.float32   # tied: the f32 head
            assert "lm_head" not in tp


class TestCausalConv:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("with_state", [False, True])
    def test_matches_jax(self, dtype, with_state):
        w, jw = _x((12, 4), "float32", 20, 0.5)
        b, jb = _x((12,), "float32", 21, 0.1)
        x, jx = _x((2, 7, 12), dtype, 22)
        state = jstate = None
        if with_state:
            state, jstate = _x((2, 3, 12), dtype, 23)
        y, new = apply_causal_conv({"w": w, "b": b}, x, state)
        jy, jnew = j_causal_conv({"w": jw, "b": jb}, jx, jstate)
        _close(y, jy, dtype)
        _close(new, jnew, dtype)

    def test_short_input_state_is_right_aligned(self):
        """Two inputs into a 4-tap conv leave [0, x0, x1]."""
        w, _ = _x((5, 4), "float32", 24)
        x, _ = _x((1, 2, 5), "float32", 25)
        _, new = apply_causal_conv({"w": w, "b": torch.zeros(5)}, x)
        assert new.shape == (1, 3, 5)
        assert float(new[0, 0].abs().sum()) == 0.0
        torch.testing.assert_close(new[0, 1:], x[0], atol=0, rtol=0)


class TestMamba:
    def test_mamba_mix_with_state(self, mamba):
        dtype, jcfg, tcfg, jp, tp = mamba
        x, jx = _x((2, 12, 64), dtype, 30)
        out, conv, h = S.mamba_mix(tp["stack"][1]["mixer"], x, tcfg,
                                   return_state=True)
        jout, jconv, jh = JS.mamba_mix(_jlayer(jp, 0, 1)["mixer"], jx, jcfg,
                                       return_state=True)
        assert conv.shape == (2, 3, 128) and h.dtype == torch.float32
        for got, want in ((out, jout), (conv, jconv), (h, jh)):
            _close(got, want, dtype)

    def test_mamba_decode(self, mamba):
        dtype, jcfg, tcfg, jp, tp = mamba
        x, jx = _x((3, 1, 64), dtype, 31)
        conv, jconv = _x((3, 3, 128), dtype, 32)
        h, jh = _x((3, 128, 4), "float32", 33)
        got = S.mamba_decode(tp["stack"][0]["mixer"], x, tcfg, conv, h)
        want = JS.mamba_decode(_jlayer(jp, 0, 0)["mixer"], jx, jcfg, jconv, jh)
        for g, w in zip(got, want):
            _close(g, w, dtype)


class TestRGLRU:
    def test_block_mix_with_state(self, rgemma):
        dtype, jcfg, tcfg, jp, tp = rgemma
        x, jx = _x((2, 12, 64), dtype, 40)
        got = R.rglru_block_mix(tp["stack"][3]["rec"], x, tcfg,
                                return_state=True)
        want = JR.rglru_block_mix(jp["stack"]["tail"][0]["rec"], jx, jcfg,
                                  return_state=True)
        assert got[2].dtype == torch.float32
        for g, w in zip(got, want):
            _close(g, w, dtype)

    def test_block_decode(self, rgemma):
        dtype, jcfg, tcfg, jp, tp = rgemma
        x, jx = _x((3, 1, 64), dtype, 41)
        conv, jconv = _x((3, 3, 64), dtype, 42)
        h, jh = _x((3, 64), "float32", 43)
        got = R.rglru_block_decode(tp["stack"][1]["rec"], x, tcfg, conv, h)
        want = JR.rglru_block_decode(_jlayer(jp, 1, 0)["rec"], jx, jcfg,
                                     jconv, jh)
        for g, w in zip(got, want):
            _close(g, w, dtype)


class TestWindowedAttention:
    @pytest.mark.parametrize("S,window", [(20, 8), (24, 8), (13, 5),
                                          (16, 16), (9, 12)])
    def test_block_local_attention(self, S, window):
        """Against the JAX function and the flash kernel's plain version
        with the window (mask 0 <= q - k < window)."""
        q, jq = _x((1, 4, S, 16), "float32", 50)
        k, jk = _x((1, 2, S, 16), "float32", 51)
        v, jv = _x((1, 2, S, 16), "float32", 52)
        got = A.block_local_attention(q, k, v, window)
        want = JA.block_local_attention(jq, jk, jv, jnp.arange(S), window)
        _close(got, want, "float32")
        torch.testing.assert_close(
            got, flash_attention_ref(q, k, v, causal=True, window=window),
            atol=1e-5, rtol=1e-5)

    @pytest.mark.parametrize("S", [5, 8, 13, 16])
    def test_windowed_prefill_ring(self, rgemma, S):
        """The prefill cache is the trailing window rolled by S % window
        (S >= window), else the whole sequence."""
        dtype, jcfg, tcfg, jp, tp = rgemma
        x, jx = _x((2, S, 64), dtype, 53)
        pos = np.arange(S, dtype=np.int32)
        got = A.attention_block(tp["stack"][2]["attn"], x, tcfg,
                                torch.from_numpy(pos), window=8,
                                return_kv=True)
        want = JA.attention_block(_jlayer(jp, 2, 0)["attn"], jx, jcfg,
                                  jnp.asarray(pos), window=8, return_kv=True)
        assert got[1].shape[2] == min(S, 8)
        for g, w in zip(got, want):
            _close(g, w, dtype)

    @pytest.mark.parametrize("positions", [[0, 5, 7], [8, 13, 21]])
    def test_ring_decode(self, rgemma, positions):
        """A cache exactly one window long is a ring written at pos % 8,
        past the window too."""
        dtype, jcfg, tcfg, jp, tp = rgemma
        x, jx = _x((3, 1, 64), dtype, 54)
        kc, jkc = _x((3, 2, 8, 16), dtype, 55)
        vc, jvc = _x((3, 2, 8, 16), dtype, 56)
        pos = np.array(positions, np.int32)
        want = JA.attention_block_decode(
            _jlayer(jp, 2, 0)["attn"], jx, jcfg, jnp.asarray(pos), jkc, jvc,
            window=8)
        got = A.attention_block_decode(
            tp["stack"][2]["attn"], x, tcfg, torch.from_numpy(pos).long(),
            kc, vc, window=8)
        assert got[1] is kc and got[2] is vc   # written in place
        for g, w in zip(got, want):
            _close(g, w, dtype)

    def test_decode_attention_window(self):
        """A cache longer than the window masks entries before it."""
        q, jq = _x((3, 4, 1, 16), "float32", 57)
        kc, jkc = _x((3, 2, 12, 16), "float32", 58)
        vc, jvc = _x((3, 2, 12, 16), "float32", 59)
        kv_len = np.array([3, 9, 12], np.int32)
        got = A.decode_attention(q, kc, vc, torch.from_numpy(kv_len).long(),
                                 window=5)
        want = JA.decode_attention(jq, jkc, jvc, jnp.asarray(kv_len), window=5)
        _close(got, want, "float32")


def _round_once(fn):
    def act(x, *args, **kw):
        return fn(x.astype(jnp.float32), *args, **kw).astype(x.dtype)
    return act


def _forwards(jp, tp, jcfg, tcfg, S=10, L=24):
    """Prefill 2 x S tokens into L-slot caches, then one decode step,
    through both packages.  Returns ((logits, caches, decode logits,
    caches after decode) of the port, the same of JAX, per layer)."""
    B = 2
    toks = np.random.default_rng(60).integers(0, 256, (B, S)).astype(np.int32)
    nxt = np.array([[5], [77]], np.int32)
    pos = np.array([S, S], np.int32)
    logits, caches = forward_prefill(
        tp, {"tokens": torch.from_numpy(toks).long()}, tcfg, cache_len=L)
    pre = [{n: t.clone() for n, t in c.items()} for c in caches]
    dlogits, caches = forward_decode(
        tp, torch.from_numpy(nxt).long(), torch.from_numpy(pos).long(),
        caches, tcfg)
    jlogits, jpre = j_forward_prefill(
        jp, {"tokens": jnp.asarray(toks)}, jcfg, PCTX, cache_len=L)
    jdlogits, jcaches = j_forward_decode(
        jp, jnp.asarray(nxt), jnp.asarray(pos), jpre, jcfg, PCTX)
    plan = T.stack_plan(tcfg)

    def layers(c):
        out = [{n: v[i] for n, v in c["blocks"][str(j)].items()}
               for i in range(plan.n_scan) for j in range(len(plan.pattern))]
        return out + list(c["tail"])
    return ((logits, pre, dlogits, caches),
            (jlogits, layers(jpre), jdlogits, layers(jcaches)))


class TestForwards:
    @pytest.mark.parametrize("arch", ARCHS)
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_forward_prefill_and_decode(self, arch, dtype, monkeypatch):
        """Against the JAX forward run op by op, its bf16 activations
        rounded once (see the docstring).  recurrentgemma's 10-token
        prefill passes its window of 8 and the decode wraps the ring."""
        jcfg, tcfg, jp, tp = _models(arch, dtype)
        monkeypatch.setattr(jax.nn, "silu", _round_once(jax.nn.silu))
        monkeypatch.setattr(jax.nn, "gelu", _round_once(jax.nn.gelu))
        with jax.disable_jit():
            got, want = _forwards(jp, tp, jcfg, tcfg)
        logits, pre, dlogits, caches = got
        assert logits.dtype == torch.float32 and logits.shape == (2, 256)
        _close(logits, want[0], dtype)
        _close(dlogits, want[2], dtype)
        for i in range(tcfg.num_layers):
            assert sorted(pre[i]) == sorted(want[1][i])
            for name in pre[i]:
                assert pre[i][name].shape == want[1][i][name].shape
                _close(pre[i][name], want[1][i][name], dtype)
                _close(caches[i][name], want[3][i][name], dtype)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_compiled_jax_forward(self, arch):
        """The unmodified, compiled JAX forward, in f32."""
        jcfg, tcfg, jp, tp = _models(arch, "float32")
        got, want = _forwards(jp, tp, jcfg, tcfg)
        _close(got[0], want[0], "float32")
        _close(got[2], want[2], "float32")
        for i in range(tcfg.num_layers):
            for name in got[3][i]:
                _close(got[3][i][name], want[3][i][name], "float32")


def _flat(tree, prefix=""):
    out = {}
    items = (enumerate(tree) if isinstance(tree, list) else tree.items())
    for name, value in items:
        if isinstance(value, (dict, list)):
            out.update(_flat(value, f"{prefix}{name}/"))
        else:
            out[prefix + str(name)] = np.asarray(value, np.float32)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_weights_round_trip(arch):
    """The JAX package's reduced parameters, saved flat under their key
    paths (the tail's list entries under "0", "1") and read back, make
    the same model: every layer's leaves in scan order, and one forward
    equal to the JAX one."""
    jcfg, tcfg, jp, tp = _models(arch, "float32", seed=3)
    back = params_from_numpy(tcfg, tree_from_flat(_flat(jp)), device="cpu")
    mine = dict(tp.named_parameters())
    assert sorted(dict(back.named_parameters())) == sorted(mine)
    for name, t in back.named_parameters():
        assert torch.equal(t, mine[name]), name
    plan = T.stack_plan(tcfg)
    if plan.tail:   # the tail's first layer comes after the scanned blocks
        torch.testing.assert_close(
            back["stack"][len(plan.kinds) - len(plan.tail)]["rec"]["w_a"],
            torch.from_numpy(np.array(jp["stack"]["tail"][0]["rec"]["w_a"])))
    toks = np.random.default_rng(61).integers(0, 256, (1, 11)).astype(np.int32)
    logits, _ = forward_prefill(back, {"tokens": torch.from_numpy(toks).long()},
                                tcfg)
    jlogits, _ = j_forward_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                   PCTX)
    _close(logits, jlogits, "float32")


@pytest.mark.parametrize("arch", ARCHS)
def test_short_prompt_decode_state(arch):
    """R3 (ROADMAP.md Queue 3): after a 2-token prompt the port's engine
    decodes the next token as a fresh prefill of the 3 tokens does; the
    JAX engine pads the 2-row conv state at its end and does not."""
    jcfg, tcfg, jp, tp = _models(arch, "float32")
    prompt = np.array([17, 201], np.int32)
    nxt = 42
    full = np.array([[17, 201, nxt]], np.int32)
    tok = np.array([[nxt]], np.int32)
    fresh, _ = forward_prefill(tp, {"tokens": torch.from_numpy(full).long()},
                               tcfg)
    eng = ServeEngine(tcfg, tp, slots=1, max_seq=16, device="cpu")
    eng._insert(0, Request(rid=0, prompt=prompt))
    mine, _ = forward_decode(tp, torch.from_numpy(tok).long(),
                             torch.tensor([2]), eng.cache, tcfg)
    np.testing.assert_allclose(mine.numpy(), fresh.numpy(), atol=1e-5,
                               rtol=1e-5)
    jfresh, _ = j_forward_prefill(jp, {"tokens": jnp.asarray(full)}, jcfg,
                                  PCTX)
    np.testing.assert_allclose(fresh.numpy(), np.asarray(jfresh), atol=1e-4,
                               rtol=1e-4)
    jeng = JServeEngine(jcfg, jp, PCTX, slots=1, max_seq=16)
    jeng._insert(0, JRequest(rid=0, prompt=prompt))
    theirs, _ = jeng._decode(jp, jnp.asarray(tok), jnp.asarray([2], jnp.int32),
                             jeng.cache)
    assert float(np.abs(np.asarray(theirs) - np.asarray(jfresh)).max()) > 1e-2

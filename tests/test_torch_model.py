"""The port's qwen3-moe model stack against the JAX package, on the CPU.

Reduced qwen3-moe-30b-a3b (3 layers, d_model 64, 8 experts top-2), its
parameters drawn by the JAX package and carried across with
`params_from_numpy`; inputs are seeded numpy arrays handed to both.
Tolerances: f32 compute atol/rtol 1e-5, bf16 compute 2e-2.

The whole forwards route top-2, as the config says.  Their reference is
the JAX forward run op by op (`jax.disable_jit`), its expert FFN through
the JAX package's own `moe_gmm_ref`, as the port's through its kernel:
the FFN rounds once in f32 where the JAX model's einsums round g, u and
the activation to bf16, and compiled XLA keeps excess precision inside
its fusions.  Either rounding moves the bf16 router's inputs enough to
flip near-tied expert choices, so the unmodified, compiled JAX forward
is held to the port in f32 at 1e-5 and, in bf16, to its expert choices:
at most one (token, layer) in 20 may differ (ROADMAP.md Queue 3, B1).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import list_archs as j_list_archs
from repro.configs.base import reduced_config as j_reduced
from repro.kernels.moe_gmm.ref import moe_gmm_ref as j_moe_gmm_ref
from repro.models import attention as JA
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.layers import apply_norm as j_apply_norm
from repro.models.layers import apply_rope as j_apply_rope
from repro.models.layers import rms_head_norm as j_rms_head_norm
from repro.models.model import count_params as j_count_params
from repro.models.model import forward_decode as j_forward_decode
from repro.models.model import forward_prefill as j_forward_prefill
from repro.models.model import init_params as j_init_params
from repro.models.parallel import single_device_ctx
from repro_torch.configs.base import get_config, list_archs, reduced_config
from repro_torch.models import attention as A
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import apply_norm, apply_rope, rms_head_norm
from repro_torch.models.model import (
    count_params,
    forward_decode,
    forward_prefill,
    init_params,
)

ARCH = "qwen3-moe-30b-a3b"
TOL = {"float32": dict(atol=1e-5, rtol=1e-5),
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PCTX = single_device_ctx()


def _cfgs(dtype, **kw):
    jcfg = j_reduced(j_get_config(ARCH)).replace(compute_dtype=dtype, **kw)
    tcfg = reduced_config(get_config(ARCH)).replace(compute_dtype=dtype, **kw)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    dtype = request.param
    jcfg, tcfg = _cfgs(dtype)
    jp = j_init_params(jcfg, jax.random.key(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return dtype, jcfg, tcfg, jp, tp


def _close(got, want, dtype, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol[dtype])


def _x(shape, dtype, seed):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(a).to(TDT[dtype]), jnp.asarray(a, dtype)


class TestConfig:
    @pytest.mark.parametrize("arch", list_archs())
    def test_configs_equal_the_jax_package(self, arch):
        jred = j_reduced(j_get_config(arch)).replace(compute_dtype="bfloat16")
        tred = reduced_config(get_config(arch)).replace(
            compute_dtype="bfloat16")
        for j, t in ((jred, tred), (j_get_config(arch), get_config(arch))):
            assert dataclasses.asdict(t) == dataclasses.asdict(j)

    def test_list_archs_lists_all_ten_and_unknown_raises(self):
        assert list_archs() == j_list_archs() == (
            "deepseek-moe-16b", "falcon-mamba-7b", "llama-3.2-vision-90b",
            "qwen1.5-110b", ARCH, "recurrentgemma-2b",
            "seamless-m4t-large-v2", "smollm-360m", "stablelm-12b", "yi-9b")
        with pytest.raises(KeyError, match="unknown arch"):
            get_config("no-such-arch")

    @pytest.mark.parametrize("change", [
        dict(family="encdec", encoder_layers=2),
        dict(family="vlm", cross_attn_every=3),
        dict(family="vlm", cross_attn_every=0, num_image_tokens=8)])
    def test_cross_stack_plans_match_jax(self, change):
        """The encdec stack and its encoder, and the vlm family with or
        without its cross-attention layers (uniform without), as the
        JAX package splits them."""
        jcfg = j_reduced(j_get_config(ARCH)).replace(**change)
        cfg = reduced_config(get_config(ARCH)).replace(**change)
        for plan, jplan in ((T.stack_plan, JT.stack_plan),
                            (T.encoder_plan, JT.encoder_plan)):
            assert dataclasses.astuple(plan(cfg)) == dataclasses.astuple(
                jplan(jcfg))

    def test_full_width_param_count(self):
        cfg = get_config(ARCH)
        assert count_params(cfg) == 30_532_122_624
        assert cfg.param_count() == 30_532_122_624

    @pytest.mark.parametrize("active_only", [False, True])
    def test_reduced_param_count_matches_jax(self, active_only):
        jcfg, tcfg = _cfgs("float32")
        assert count_params(tcfg, active_only) == j_count_params(
            jcfg, active_only)

    def test_init_params_shapes_and_storage_dtypes(self):
        jcfg, tcfg = _cfgs("bfloat16")
        tp = init_params(tcfg, 0, device="cpu")
        n = sum(p.numel() for p in tp.parameters())
        assert n == count_params(tcfg)
        layer = tp["stack"][0]
        assert layer["attn"]["wq"].dtype == torch.bfloat16
        assert layer["moe"]["w_gate"].shape == (8, 64, 32)
        assert layer["moe"]["w_gate"].dtype == torch.bfloat16
        assert layer["moe"]["router"].dtype == torch.float32
        assert layer["attn"]["q_norm"].dtype == torch.float32
        assert tp["lm_head"].dtype == torch.float32
        assert tp["embed"].dtype == torch.bfloat16


class TestLayers:
    @pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
    @pytest.mark.parametrize("upcast", [True, False])
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_norms(self, kind, upcast, dtype):
        rng = np.random.default_rng(1)
        scale = (1 + 0.1 * rng.normal(size=64)).astype(np.float32)
        bias = (0.1 * rng.normal(size=64)).astype(np.float32)
        p = {"scale": scale} | ({"bias": bias} if kind == "layernorm" else {})
        x, jx = _x((2, 5, 64), dtype, 2)
        got = apply_norm(kind, {k: torch.from_numpy(v) for k, v in p.items()},
                         x, upcast=upcast)
        want = j_apply_norm(kind, {k: jnp.asarray(v) for k, v in p.items()},
                            jx, upcast=upcast)
        assert got.dtype == x.dtype
        _close(got, want, dtype)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_qk_norm(self, dtype):
        scale = np.linspace(0.5, 1.5, 16).astype(np.float32)
        x, jx = _x((2, 4, 5, 16), dtype, 3)
        _close(rms_head_norm(torch.from_numpy(scale), x),
               j_rms_head_norm(jnp.asarray(scale), jx), dtype)

    @pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
    def test_rope_prefill_and_decode_positions(self, theta):
        x, jx = _x((2, 4, 7, 16), "float32", 4)
        pos = np.arange(7, dtype=np.int32) + 300
        _close(apply_rope(x, torch.from_numpy(pos), theta),
               j_apply_rope(jx, jnp.asarray(pos), theta), "float32")
        x1, jx1 = _x((3, 4, 1, 16), "float32", 5)
        dpos = np.array([[0], [17], [511]], np.int32)   # (B, 1) at decode
        _close(apply_rope(x1, torch.from_numpy(dpos), theta),
               j_apply_rope(jx1, jnp.asarray(dpos), theta), "float32")


class TestBlocks:
    def test_attention_block_prefill(self, model):
        dtype, jcfg, tcfg, jp, tp = model
        x, jx = _x((2, 12, 64), dtype, 6)
        pos = np.arange(12, dtype=np.int32)
        y, k, v = A.attention_block(tp["stack"][1]["attn"], x, tcfg,
                                    torch.from_numpy(pos), return_kv=True)
        jl = jax.tree.map(lambda a: a[1], jp["stack"]["blocks"]["0"])
        jy, jk, jv = JA.attention_block(jl["attn"], jx, jcfg,
                                        jnp.asarray(pos), return_kv=True)
        for got, want in ((y, jy), (k, jk), (v, jv)):
            _close(got, want, dtype)

    def test_attention_block_decode(self, model):
        dtype, jcfg, tcfg, jp, tp = model
        B, S = 3, 16
        x, jx = _x((B, 1, 64), dtype, 7)
        kc, jkc = _x((B, 2, S, 16), dtype, 8)
        vc, jvc = _x((B, 2, S, 16), dtype, 9)
        pos = np.array([0, 9, 20], np.int32)   # 20 >= S: clamped slot
        jl = jax.tree.map(lambda a: a[2], jp["stack"]["blocks"]["0"])
        jy, jk, jv = JA.attention_block_decode(
            jl["attn"], jx, jcfg, jnp.asarray(pos), jkc, jvc)
        y, k, v = A.attention_block_decode(
            tp["stack"][2]["attn"], x, tcfg, torch.from_numpy(pos).long(),
            kc, vc)
        assert k is kc and v is vc   # written in place
        for got, want in ((y, jy), (k, jk), (v, jv)):
            _close(got, want, dtype)

    @pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
    def test_apply_moe(self, model, capacity_factor):
        """0.25 forces capacity drops (sentinel row, gates zeroed)."""
        dtype, jcfg, tcfg, jp, tp = model
        moe = dataclasses.replace(tcfg.moe, capacity_factor=capacity_factor)
        jcfg = jcfg.replace(moe=dataclasses.replace(
            jcfg.moe, capacity_factor=capacity_factor))
        tcfg = tcfg.replace(moe=moe)
        x, jx = _x((2, 32, 64), dtype, 10)
        jl = jax.tree.map(lambda a: a[0], jp["stack"]["blocks"]["0"])
        y, aux = M.apply_moe(tp["stack"][0]["moe"], x, tcfg)
        jy, jaux = JM.apply_moe(jl["moe"], jx, jcfg, PCTX)
        _close(y, jy, dtype)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
        # how many slots the capacity kept
        T = 64
        cap = M._capacity(T, 2, 8, capacity_factor)
        logits = x.reshape(T, 64).float() @ tp["stack"][0]["moe"]["router"]
        _, idx, _ = M._topk_route(logits, 2)
        kept = int((M._rank_within_expert(idx.reshape(-1), 8) < cap).sum())
        assert kept <= 8 * cap
        if capacity_factor < 1:
            assert kept < 2 * T

    def test_rank_within_expert_is_stable(self):
        e = torch.tensor([3, 1, 3, 0, 1, 3, 2, 0])
        assert M._rank_within_expert(e, 4).tolist() == [0, 0, 1, 0, 1, 2, 0, 1]

    @pytest.mark.parametrize("arch", [ARCH, "deepseek-moe-16b"])
    @pytest.mark.parametrize("act", ["gelu", "relu"])
    def test_non_silu_moe_equals_jax(self, act, arch):
        """The config's activation in the routed experts (the moe_gmm
        kernel's plain version) and in deepseek's shared experts: the
        one-shard `apply_moe` and its gradients (x and every leaf, one
        seeded cotangent) against `jax.vjp` of the JAX package's in f32,
        at the kernels' 2e-5 forward and 1e-4 of each gradient's largest
        value.  The expert-parallel branch's case is in
        tests/test_torch_tp_recurrent.py, whose JAX side has a mesh."""
        jcfg = j_reduced(j_get_config(arch)).replace(
            compute_dtype="float32", act=act)
        tcfg = reduced_config(get_config(arch)).replace(
            compute_dtype="float32", act=act)
        jp = j_init_params(jcfg, jax.random.key(3))
        layer = len(T.stack_plan(tcfg).prefix)   # the first MoE layer
        jl = jax.tree.map(lambda a: np.asarray(a[0], np.float32),
                          jp["stack"]["blocks"]["0"])["moe"]
        tl = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp),
                               device="cpu", masters=True)
        leaves = dict(tl["stack"][layer]["moe"].named_parameters())
        assert sorted(leaves) == sorted(jl)
        x, jx = _x((2, 32, 64), "float32", 30)
        dy = np.random.default_rng(31).normal(size=(2, 32, 64)).astype(
            np.float32)
        x.requires_grad_()
        y, aux = M.apply_moe(leaves, x, tcfg)
        grads = torch.autograd.grad(y, [x, *leaves.values()],
                                    torch.from_numpy(dy))
        (jy, jaux), vjp = jax.vjp(
            lambda p, a: JM.apply_moe(p, a, jcfg, PCTX), jl, jx)
        jgp, jgx = vjp((jnp.asarray(dy), jnp.zeros_like(jaux)))
        _close(y.detach(), jy, "float32", {"float32": dict(atol=2e-5,
                                                           rtol=2e-5)})
        np.testing.assert_allclose(float(aux.detach()), float(jaux),
                                   rtol=1e-5)
        for name, g in zip(["x", *leaves], grads):
            want = np.asarray(jgx if name == "x" else jgp[name])
            scale = max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(g.numpy(), want, rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=name)


def _j_dispatch_round_once(x_tok, gates, idx, wg, wu, wd, cfg, capacity):
    """The JAX package's single-shard `_dispatch_combine_local` with its
    einsum trio replaced by its own `moe_gmm_ref`, which rounds once, as
    the Pallas kernel and the port's kernel do."""
    E = cfg.moe.num_experts
    T_, D = x_tok.shape
    k = idx.shape[1]
    e_flat, g_flat = idx.reshape(-1), gates.reshape(-1)
    t_flat = jnp.repeat(jnp.arange(T_), k)
    rank = JM._rank_within_expert(e_flat, E)
    keep = rank < capacity
    slot = jnp.where(keep, e_flat * capacity + rank, E * capacity)
    buf = jnp.zeros((E * capacity + 1, D), x_tok.dtype).at[slot].set(x_tok[t_flat])
    h = buf[:-1].reshape(E, capacity, D)
    out = j_moe_gmm_ref(h, wg.astype(h.dtype), wu.astype(h.dtype),
                        wd.astype(h.dtype))
    flat = jnp.concatenate([out.reshape(E * capacity, D),
                            jnp.zeros((1, D), out.dtype)])
    y_slots = flat[slot] * (g_flat * keep)[:, None].astype(out.dtype)
    return jnp.zeros((T_, D), out.dtype).at[t_flat].add(y_slots)


def _forwards(jp, tp, jcfg, tcfg):
    """Prefill 2 x 10 tokens into 24-slot caches, then one decode step,
    through both packages.  Returns ((logits, caches, decode logits,
    caches after decode) of the port, the same of JAX)."""
    B, S, L = 2, 10, 24
    toks = np.random.default_rng(11).integers(0, 256, (B, S)).astype(np.int32)
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
    jl = lambda c: [{n: c["blocks"]["0"][n][i] for n in ("k", "v")}
                    for i in range(tcfg.num_layers)]
    return ((logits, pre, dlogits, caches),
            (jlogits, jl(jpre), jdlogits, jl(jcaches)))


def _routes(monkeypatch, module, record):
    """Record every `_topk_route` call's expert indices (JAX's through an
    ordered callback, so that compiled code reports them too)."""
    route = module._topk_route

    def spy(logits, k):
        gates, idx, probs = route(logits, k)
        if module is M:
            record.append(idx.numpy())
        else:
            jax.debug.callback(lambda i: record.append(np.asarray(i)), idx,
                               ordered=True)
        return gates, idx, probs
    monkeypatch.setattr(module, "_topk_route", spy)


class TestForwards:
    def test_forward_prefill_and_decode(self, model, monkeypatch):
        """Against the JAX forward run op by op, its expert FFN rounding
        once (see the docstring); top-2 routing in both."""
        dtype, jcfg, tcfg, jp, tp = model
        assert tcfg.moe.top_k == 2
        monkeypatch.setattr(JM, "_dispatch_combine_local",
                            _j_dispatch_round_once)
        with jax.disable_jit():
            got, want = _forwards(jp, tp, jcfg, tcfg)
        logits, pre, dlogits, caches = got
        assert logits.dtype == torch.float32 and logits.shape == (2, 256)
        _close(logits, want[0], dtype)
        _close(dlogits, want[2], dtype)
        for i in range(tcfg.num_layers):
            for name in ("k", "v"):
                assert pre[i][name].shape == (2, 2, 24, 16)
                _close(pre[i][name], want[1][i][name], dtype)
                _close(caches[i][name], want[3][i][name], dtype)

    def test_compiled_jax_forward(self, model, monkeypatch):
        """The unmodified, compiled JAX forward: f32 logits and caches at
        1e-5; the same expert choices but for at most 1 in 20 tokens of
        a layer in bf16 (ROADMAP.md Queue 3, B1)."""
        dtype, jcfg, tcfg, jp, tp = model
        mine, theirs = [], []
        _routes(monkeypatch, M, mine)
        _routes(monkeypatch, JM, theirs)
        got, want = _forwards(jp, tp, jcfg, tcfg)
        jax.effects_barrier()
        # 3 layers of prefill (20 tokens), 3 of decode (2 tokens)
        assert [r.shape for r in mine] == [r.shape for r in theirs] == (
            [(20, 2)] * 3 + [(2, 2)] * 3)
        differ = sum(int((np.sort(a, -1) != np.sort(b, -1)).any(-1).sum())
                     for a, b in zip(mine, theirs))
        if dtype == "float32":
            assert differ == 0
            _close(got[0], want[0], dtype)
            _close(got[2], want[2], dtype)
            for i in range(tcfg.num_layers):
                for name in ("k", "v"):
                    _close(got[3][i][name], want[3][i][name], dtype)
        else:
            assert differ * 20 <= sum(len(r) for r in mine)

    def test_dense_stack_prefill(self):
        """self_attn layers with a SwiGLU FFN, the stack's other kind."""
        jcfg, tcfg = _cfgs("float32", family="dense", moe=None, num_layers=2)
        jp = j_init_params(jcfg, jax.random.key(1))
        tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
        toks = np.random.default_rng(12).integers(0, 256, (1, 9)).astype(np.int32)
        logits, _ = forward_prefill(tp, {"tokens": torch.from_numpy(toks).long()},
                                    tcfg)
        jlogits, _ = j_forward_prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg,
                                       PCTX)
        _close(logits, jlogits, "float32")

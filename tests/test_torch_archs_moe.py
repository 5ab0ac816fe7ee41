"""The port's deepseek-moe-16b against the JAX package, on the CPU:
shared experts, the dense first layer and its `StackPlan.prefix`.

Reduced (3 layers: one dense, two MoE; d_model 64, 8 routed experts
top-2 of width 32, a shared branch of width 64, a dense FFN of width
128) in deepseek's own head layout, MHA at hd 128
(tests/torch_arch_parity.py), with the JAX package's parameters carried
across with `params_from_numpy`.  Tolerances: f32 blocks 2e-5, f32
forwards 1e-4, bf16 2e-2.  bf16 whole forwards are held to the JAX
forward run op by op with its expert FFN rounding once (B1) and its bf16
silu computed in f32 and rounded once (B2), and the unmodified,
compiled JAX forward to its expert choices: at most one (token, layer)
in 20 may route differently in bf16, none in f32 (ROADMAP Queue 3).

Golden run: regenerate the stored file with ``JAX_PLATFORMS=cpu
PYTHONPATH=src python tests/test_torch_archs_moe.py``.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_arch_parity as P
from repro.configs import get_config as j_get_config
from repro.configs.base import reduced_config as j_reduced
from repro.models import kvcache as JK
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.model import count_params as j_count_params
from repro_torch.configs.base import get_config, list_archs, reduced_config
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve as serve_cli
from repro_torch.models import ffn as FF
from repro_torch.models import kvcache as K
from repro_torch.models import moe as M
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_numpy, tree_from_flat
from repro_torch.models.model import count_params, forward_prefill, init_params
from repro_torch.serve.engine import Request, ServeEngine

ARCH = "deepseek-moe-16b"
FULL_PARAMS, FULL_ACTIVE = 16_375_728_128, 2_828_650_496


@pytest.fixture(scope="module", params=["float32", "bfloat16"])
def model(request):
    return (request.param,) + P.models(ARCH, request.param)


def _jlayer(jp, i):
    """Layer i of the JAX stack: the prefix's dense layer, then the
    scanned MoE layers."""
    if i == 0:
        return jp["stack"]["prefix"][0]
    return jax.tree.map(lambda a: a[i - 1], jp["stack"]["blocks"]["0"])


class TestConfig:
    def test_configs_equal_the_jax_package(self):
        for j, t in (P.cfgs(ARCH, "bfloat16"), P.cfgs(ARCH, "bfloat16", False),
                     (j_get_config(ARCH), get_config(ARCH))):
            assert dataclasses.asdict(t) == dataclasses.asdict(j)

    def test_full_width_param_count(self):
        cfg = get_config(ARCH)
        assert count_params(cfg) == FULL_PARAMS == cfg.param_count()
        assert count_params(cfg, True) == FULL_ACTIVE
        assert j_get_config(ARCH).param_count() == FULL_PARAMS
        assert j_get_config(ARCH).active_param_count() == FULL_ACTIVE

    @pytest.mark.parametrize("active_only", [False, True])
    @pytest.mark.parametrize("layout", [True, False])
    def test_reduced_param_count_matches_jax(self, layout, active_only):
        jcfg, tcfg = P.cfgs(ARCH, "float32", layout)
        assert count_params(tcfg, active_only) == j_count_params(
            jcfg, active_only)

    @pytest.mark.parametrize("arch", list_archs())
    def test_stack_plan_matches_jax(self, arch):
        for full in (True, False):
            jcfg, tcfg = j_get_config(arch), get_config(arch)
            if not full:
                jcfg, tcfg = j_reduced(jcfg), reduced_config(tcfg)
            assert dataclasses.astuple(T.stack_plan(tcfg)) == (
                dataclasses.astuple(JT.stack_plan(jcfg)))
        assert T.stack_plan(get_config(ARCH)) == T.StackPlan(
            ("dense",), ("moe",), 27)

    def test_cache_shapes_match_jax(self):
        jcfg, tcfg = P.cfgs(ARCH, "bfloat16")
        mine = K.init_cache(tcfg, 3, 20, device="cpu")
        theirs = P.j_layers(JK.init_cache(jcfg, 3, 20))
        assert [sorted(c) for c in mine] == [sorted(c) for c in theirs]
        for c, jc in zip(mine, theirs):
            for name in c:
                assert tuple(c[name].shape) == jc[name].shape == (3, 2, 20, 128)
                assert str(c[name].dtype).endswith(str(jc[name].dtype))

    def test_init_params_shapes_and_storage_dtypes(self):
        _, tcfg = P.cfgs(ARCH, "bfloat16")
        tp = init_params(tcfg, 0, device="cpu")
        assert sum(p.numel() for p in tp.parameters()) == count_params(tcfg)
        dense, moe = tp["stack"][0], tp["stack"][1]
        assert "moe" not in dense and "ffn" not in moe
        assert dense["ffn"]["w_gate"].shape == (64, 128)     # d_ff_dense
        assert dense["ffn"]["w_down"].dtype == torch.bfloat16
        assert moe["moe"]["w_gate"].shape == (8, 64, 32)
        assert moe["moe"]["router"].dtype == torch.float32
        for name, shape in (("shared_gate", (64, 64)), ("shared_up", (64, 64)),
                            ("shared_down", (64, 64))):
            assert moe["moe"][name].shape == shape
            assert moe["moe"][name].dtype == torch.bfloat16

    def test_init_ffn_takes_its_width(self):
        _, tcfg = P.cfgs(ARCH, "float32")
        gen = torch.Generator().manual_seed(0)
        p = FF.init_ffn(gen, tcfg, d_ff=96)
        assert p["w_up"].shape == (64, 96) and p["w_down"].shape == (96, 64)
        assert FF.init_ffn(gen, tcfg)["w_up"].shape == (64, tcfg.d_ff)

    def test_params_from_numpy_with_a_prefix(self, model):
        """The JAX tree's `stack/prefix` list comes first, from a nested
        tree or from flat key paths ("stack/prefix/0/..."), and every leaf
        keeps its bits (in its storage dtype)."""
        _, jcfg, tcfg, jp, tp = model
        back = params_from_numpy(tcfg, tree_from_flat(P._flat(jp)),
                                 device="cpu")
        mine = dict(tp.named_parameters())
        assert sorted(dict(back.named_parameters())) == sorted(mine)
        for name, t in back.named_parameters():
            assert torch.equal(t, mine[name]), name
        for got, want in (
                (back["stack"][0]["ffn"]["w_gate"],
                 jp["stack"]["prefix"][0]["ffn"]["w_gate"]),
                (back["stack"][2]["moe"]["shared_up"],
                 jp["stack"]["blocks"]["0"]["moe"]["shared_up"][1])):
            want = torch.from_numpy(np.array(want, np.float32))
            assert torch.equal(got, want.to(got.dtype))
        with pytest.raises(ValueError, match="layers"):
            tree = jax.tree.map(np.asarray, jp)
            tree["stack"] = dict(tree["stack"], prefix=[])
            params_from_numpy(tcfg, tree, device="cpu")


class TestBlocks:
    @pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
    def test_apply_moe_with_shared_experts(self, model, capacity_factor,
                                           monkeypatch):
        """Routed experts plus the shared branch; 0.25 drops slots.  bf16
        against the JAX function with B1 and B2 taken out."""
        dtype, jcfg, tcfg, jp, tp = model
        moe = dict(moe=dataclasses.replace(tcfg.moe,
                                           capacity_factor=capacity_factor))
        jcfg, tcfg = jcfg.replace(**moe), tcfg.replace(**moe)
        x, jx = P.x_pair((2, 32, 64), dtype, 10)
        if dtype == "bfloat16":
            monkeypatch.setattr(JM, "_dispatch_combine_local",
                                P.j_dispatch_round_once)
            monkeypatch.setattr(jax.nn, "silu", P.round_once(jax.nn.silu))
        y, aux = M.apply_moe(tp["stack"][1]["moe"], x, tcfg)
        with jax.disable_jit():
            jy, jaux = JM.apply_moe(_jlayer(jp, 1)["moe"], jx, jcfg, P.PCTX)
        tol = {"float32": P.BLOCK_TOL, "bfloat16": P.TOL["bfloat16"]}
        P.close(y, jy, dtype, {dtype: tol[dtype]})
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)

    def test_shared_branch_takes_part(self, model):
        dtype, _, tcfg, _, tp = model
        p = tp["stack"][1]["moe"]
        x, _ = P.x_pair((1, 6, 64), dtype, 12)
        y, _ = M.apply_moe(p, x, tcfg)
        routed, _ = M.apply_moe(p, x, tcfg.replace(moe=dataclasses.replace(
            tcfg.moe, num_shared_experts=0)))
        f = torch.nn.functional.silu
        shared = (f(x @ p["shared_gate"].to(x.dtype)) * (
            x @ p["shared_up"].to(x.dtype))) @ p["shared_down"].to(x.dtype)
        assert float(shared.abs().max()) > 1e-2
        torch.testing.assert_close(y, routed + shared, atol=0, rtol=0)

    @pytest.mark.parametrize("mode", ["prefill", "decode"])
    def test_dense_layer(self, mode):
        """The prefix's `dense` kind: attention, then an FFN of width
        d_ff_dense, in f32 at 2e-5."""
        jcfg, tcfg, jp, tp = P.models(ARCH, "float32")
        jl = _jlayer(jp, 0)
        B, S, L = 2, 9, 16
        if mode == "prefill":
            x, jx = P.x_pair((B, S, 64), "float32", 13)
            pos = np.arange(S, dtype=np.int32)
            y, _, c = T.apply_layer("dense", tp["stack"][0], x, tcfg,
                                    T.LayerCtx(positions=torch.from_numpy(pos)))
            jy, _, jc = JT.apply_layer(
                "dense", jl, jx, jcfg, P.PCTX,
                JT.LayerCtx(positions=jnp.asarray(pos), mode="prefill"))
        else:
            x, jx = P.x_pair((B, 1, 64), "float32", 14)
            kc, jkc = P.x_pair((B, 2, L, 128), "float32", 15)
            vc, jvc = P.x_pair((B, 2, L, 128), "float32", 16)
            pos = np.array([3, 11], np.int32)
            y, _, c = T.apply_layer(
                "dense", tp["stack"][0], x, tcfg,
                T.LayerCtx(pos=torch.from_numpy(pos).long(), mode="decode"),
                {"k": kc, "v": vc})
            jy, _, jc = JT.apply_layer(
                "dense", jl, jx, jcfg, P.PCTX,
                JT.LayerCtx(pos=jnp.asarray(pos), mode="decode"),
                {"k": jkc, "v": jvc})
        P.close(y, jy, "float32", {"float32": P.BLOCK_TOL})
        for name in ("k", "v"):
            P.close(c[name], jc[name], "float32", {"float32": P.BLOCK_TOL})


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
    def test_bf16_forward_prefill_and_decode(self, monkeypatch):
        """bf16 against the JAX forward run op by op, B1 and B2 taken out:
        prefill, two decode steps and every layer's caches (f32 is held
        to the compiled JAX forward below)."""
        jcfg, tcfg, jp, tp = P.models(ARCH, "bfloat16")
        monkeypatch.setattr(JM, "_dispatch_combine_local",
                            P.j_dispatch_round_once)
        monkeypatch.setattr(jax.nn, "silu", P.round_once(jax.nn.silu))
        with jax.disable_jit():
            got, want = P.forwards(jp, tp, jcfg, tcfg, steps=2)
        P.hold_forwards(got, want, "bfloat16", tcfg.num_layers)

    def test_compiled_jax_forward(self, model, monkeypatch):
        """The unmodified, compiled JAX forward: in f32 logits and caches
        at 1e-4 and every expert choice equal; in bf16 at most one
        (token, layer) in 20 routed otherwise (B1)."""
        dtype, jcfg, tcfg, jp, tp = model
        mine, theirs = [], []
        _routes(monkeypatch, M, mine)
        _routes(monkeypatch, JM, theirs)
        got, want = P.forwards(jp, tp, jcfg, tcfg)
        jax.effects_barrier()
        # 2 MoE layers of prefill (20 tokens), then of 3 decode steps
        assert [r.shape for r in mine] == [r.shape for r in theirs] == (
            [(20, 2)] * 2 + [(2, 2)] * 6)
        differ = sum(int((np.sort(a, -1) != np.sort(b, -1)).any(-1).sum())
                     for a, b in zip(mine, theirs))
        if dtype == "float32":
            assert differ == 0
            P.hold_forwards(got, want, dtype, tcfg.num_layers)
        else:
            assert differ * 20 <= sum(len(r) for r in mine)


@pytest.fixture(scope="module")
def golden():
    return P.golden_reference(ARCH)


class TestGolden:
    def test_engine_matches_jax_engine(self, golden):
        cfg, params = P.port_from_golden(ARCH, golden)
        prompts = [golden[f"prompt/{i}"] for i in range(P.REQUESTS)]
        launch_counts.clear()
        eng, toks = P.run_engine(ServeEngine, Request, cfg, params, prompts,
                                 device="cpu")
        for i in range(P.REQUESTS):
            assert toks[i] == golden[f"tokens/{i}"].tolist(), i
        assert eng.prefills == P.REQUESTS and eng.ticks > 0
        assert not launch_counts   # the CPU runs the plain versions

    def test_stored_data_is_current(self, golden):
        P.stored_is_current(ARCH, golden)

    def test_port_reproduces_golden_on_cpu(self):
        """What chip_smoke.py checks on the card, on the CPU path."""
        stored = dict(np.load(P.GOLDENS[ARCH]))
        cfg, params = P.port_from_golden(ARCH, stored)
        assert cfg.head_dim == 128 and cfg.num_kv_heads == cfg.num_heads
        for i in range(P.REQUESTS):
            tokens = torch.from_numpy(stored[f"prompt/{i}"][None]).long()
            logits, _ = forward_prefill(params, {"tokens": tokens}, cfg)
            np.testing.assert_allclose(logits[0].numpy(),
                                       stored[f"logits/{i}"], atol=1e-4,
                                       rtol=1e-4)
        prompts = [stored[f"prompt/{i}"] for i in range(P.REQUESTS)]
        _, toks = P.run_engine(ServeEngine, Request, cfg, params, prompts,
                               device="cpu")
        for i in range(P.REQUESTS):
            assert toks[i] == stored[f"tokens/{i}"].tolist(), i


def test_cli_serves_on_cpu(capsys):
    serve_cli.main(["--device", "cpu", "--arch", ARCH, "--requests", "3",
                    "--slots", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"[serve] {ARCH} on cpu: 3 requests, 12 tokens" in out


if __name__ == "__main__":
    P.write_goldens([ARCH])

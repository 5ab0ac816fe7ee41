"""The port's four dense archs, smollm-360m, yi-9b, stablelm-12b and
qwen1.5-110b, against the JAX package, on the CPU.

Each runs reduced (2 layers, d_model 64) in its own head layout
(tests/torch_arch_parity.py: smollm hd 64 with 3 query heads a KV head,
yi and qwen1.5 hd 128 with 8, stablelm hd 160 with 4; stablelm's
LayerNorm, smollm's tied embedding, qwen1.5's QKV bias and rope theta
1e6 as their configs have them), with the JAX package's parameters,
constant leaves perturbed.  Tolerances: f32 forwards 1e-4; bf16 2e-2
against the JAX forward run op by op with its bf16 silu computed in f32
and rounded once, as PyTorch computes it (ROADMAP Queue 3, B2).

Golden runs: regenerate the stored files with ``JAX_PLATFORMS=cpu
PYTHONPATH=src python tests/test_torch_archs_dense.py [arch ...]``.
"""
import dataclasses
import sys

import jax
import numpy as np
import pytest
import torch

import torch_arch_parity as P
from repro.configs import get_config as j_get_config
from repro.configs.base import reduced_config as j_reduced
from repro.models import transformer as JT
from repro.models.model import count_params as j_count_params
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve as serve_cli
from repro_torch.models import transformer as T
from repro_torch.models.model import count_params, forward_prefill, init_params
from repro_torch.serve.engine import Request, ServeEngine

ARCHS = ("smollm-360m", "yi-9b", "stablelm-12b", "qwen1.5-110b")
FULL_PARAMS = {"smollm-360m": 361_821_120, "yi-9b": 8_829_407_232,
               "stablelm-12b": 12_143_339_520,
               "qwen1.5-110b": 111_209_914_368}


class TestConfig:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_configs_equal_the_jax_package(self, arch):
        for j, t in (P.cfgs(arch, "bfloat16"), P.cfgs(arch, "bfloat16", False),
                     (j_get_config(arch), get_config(arch))):
            assert dataclasses.asdict(t) == dataclasses.asdict(j)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_full_width_param_count(self, arch):
        cfg = get_config(arch)
        assert count_params(cfg) == FULL_PARAMS[arch] == cfg.param_count()
        assert j_get_config(arch).param_count() == FULL_PARAMS[arch]

    @pytest.mark.parametrize("layout", [True, False])
    @pytest.mark.parametrize("arch", ARCHS)
    def test_reduced_param_count_matches_jax(self, arch, layout):
        jcfg, tcfg = P.cfgs(arch, "float32", layout)
        for active_only in (False, True):
            assert count_params(tcfg, active_only) == j_count_params(
                jcfg, active_only)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_stack_plan_matches_jax(self, arch):
        for full in (True, False):
            jcfg, tcfg = j_get_config(arch), get_config(arch)
            if not full:
                jcfg, tcfg = j_reduced(jcfg), reduced_config(tcfg)
            assert dataclasses.astuple(T.stack_plan(tcfg)) == (
                dataclasses.astuple(JT.stack_plan(jcfg)))

    @pytest.mark.parametrize("arch", ARCHS)
    def test_init_params_shapes_and_storage_dtypes(self, arch):
        _, tcfg = P.cfgs(arch, "bfloat16")
        tp = init_params(tcfg, 0, device="cpu")
        assert sum(p.numel() for p in tp.parameters()) == count_params(tcfg)
        attn = tp["stack"][0]["attn"]
        hd, hq = tcfg.head_dim, tcfg.num_heads
        assert attn["wq"].shape == (64, hq * hd)
        assert attn["wq"].dtype == torch.bfloat16
        assert ("bq" in attn) == tcfg.qkv_bias
        if tcfg.qkv_bias:
            assert attn["bq"].dtype == torch.bfloat16
        ln = tp["stack"][0]["ln1"]
        assert ("bias" in ln) == (tcfg.norm == "layernorm")
        assert ln["scale"].dtype == torch.float32
        # a tied embedding doubles as the f32 head
        assert ("lm_head" in tp) != tcfg.tie_embeddings
        assert tp["embed"].dtype == (torch.float32 if tcfg.tie_embeddings
                                     else torch.bfloat16)


class TestForwards:
    @pytest.mark.parametrize("arch", ARCHS)
    def test_compiled_jax_forward(self, arch):
        """The unmodified, compiled JAX forward in f32: prefill, three
        decode steps and every layer's caches at 1e-4."""
        jcfg, tcfg, jp, tp = P.models(arch, "float32")
        got, want = P.forwards(jp, tp, jcfg, tcfg)
        P.hold_forwards(got, want, "float32", tcfg.num_layers)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_bf16_forward_prefill_and_decode(self, arch, monkeypatch):
        """bf16 against the JAX forward run op by op, its silu rounded
        once (B2)."""
        jcfg, tcfg, jp, tp = P.models(arch, "bfloat16")
        monkeypatch.setattr(jax.nn, "silu", P.round_once(jax.nn.silu))
        with jax.disable_jit():
            got, want = P.forwards(jp, tp, jcfg, tcfg, steps=2)
        P.hold_forwards(got, want, "bfloat16", tcfg.num_layers)

    def test_qkv_bias_and_layernorm_bias_take_part(self):
        """The perturbed constant leaves move the logits, so the forwards
        above hold qwen1.5's QKV bias and stablelm's LayerNorm bias."""
        for arch, leaf in (("qwen1.5-110b", ("attn", "bk")),
                           ("stablelm-12b", ("ln1", "bias"))):
            _, tcfg, _, tp = P.models(arch, "float32")
            toks = torch.arange(7)[None]
            base, _ = forward_prefill(tp, {"tokens": toks}, tcfg)
            tp["stack"][0][leaf[0]][leaf[1]].data.zero_()
            moved, _ = forward_prefill(tp, {"tokens": toks}, tcfg)
            assert float((base - moved).abs().max()) > 1e-3, arch


@pytest.fixture(scope="module", params=ARCHS)
def golden(request):
    return request.param, P.golden_reference(request.param)


class TestGolden:
    def test_engine_matches_jax_engine(self, golden):
        arch, ref = golden
        cfg, params = P.port_from_golden(arch, ref)
        prompts = [ref[f"prompt/{i}"] for i in range(P.REQUESTS)]
        launch_counts.clear()
        eng, toks = P.run_engine(ServeEngine, Request, cfg, params, prompts,
                                 device="cpu")
        for i in range(P.REQUESTS):
            assert toks[i] == ref[f"tokens/{i}"].tolist(), i
        assert eng.prefills == P.REQUESTS and eng.ticks > 0
        assert not launch_counts   # the CPU runs the plain versions

    def test_stored_data_is_current(self, golden):
        P.stored_is_current(*golden)

    @pytest.mark.parametrize("arch", ARCHS)
    def test_port_reproduces_golden_on_cpu(self, arch):
        """What chip_smoke.py checks on the card, on the CPU path: prefill
        logits at 1e-4 and the engine's greedy tokens."""
        stored = dict(np.load(P.GOLDENS[arch]))
        cfg, params = P.port_from_golden(arch, stored)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_on_cpu(arch, capsys):
    serve_cli.main(["--device", "cpu", "--arch", arch, "--requests", "3",
                    "--slots", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"[serve] {arch} on cpu: 3 requests, 12 tokens" in out


if __name__ == "__main__":
    P.write_goldens(sys.argv[1:] or ARCHS)

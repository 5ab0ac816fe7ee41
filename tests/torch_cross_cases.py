"""The test cases of the port's cross-attention families against the
JAX package, on the CPU: tests/test_torch_archs_seamless.py
(seamless-m4t-large-v2, encoder-decoder) and
tests/test_torch_archs_llama_vision.py (llama-3.2-vision-90b, every
second layer of the reduced stack a cross-attention layer over image
embeddings) collect these classes, each with its `arch` fixture, so that
each family's file runs alone in under a minute.

Each arch runs reduced (d_model 64; 2 encoder and 2 decoder layers, or 4
layers over 8 image tokens) in its own head layout
(tests/torch_arch_parity.py: seamless MHA at hd 64, llama-vision hd 128
with 8 query heads a KV head), with the JAX package's parameters,
constant leaves perturbed (seamless's LayerNorm biases take part).  The
engine's zero stubs would hide the cross path (zero image embeddings give
zero cross K/V), so every forward here reads seeded encoder frames or
image embeddings, with source lengths below and above the prompt's.
Tolerances: f32 blocks 2e-5, f32 forwards 1e-4; bf16 2e-2 against the
JAX forward run op by op with its bf16 silu computed in f32 and rounded
once, as PyTorch computes it (ROADMAP Queue 3, B2).

R4 (ROADMAP Queue 3): the JAX engine zero-pads a request's cross K/V to
the slot's length and attends the padding; the port masks it, so a slot
decodes as a fresh prefill-then-decode does.

Golden runs: ``src/repro_torch/data/<arch>_reduced_golden.npz`` holds,
for each arch, its head layout (``config``, JSON), the JAX package's f32
parameters (constant leaves perturbed), four prompts and, for each
prompt: a seeded source (``embeds``: encoder frames shorter and longer
than the prompt, or 8 image embeddings), the JAX prefill logits on it
and three greedy decode steps' tokens and logits; the greedy tokens of
the request run alone with the engine's zero stubs (``tokens``: unpadded
cross caches, what a port slot gives); and the JAX engine's tokens (2
slots, 8 new tokens), which attend the zero padding of seamless's cross
caches (R4).  chip_smoke.py holds the card to them.  Regenerate them
with ``JAX_PLATFORMS=cpu PYTHONPATH=src python
tests/test_torch_archs_seamless.py`` and ``...
tests/test_torch_archs_llama_vision.py``.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_arch_parity as P
from repro.configs import get_config as j_get_config
from repro.configs.base import reduced_config as j_reduced
from repro.models import attention as JA
from repro.models import transformer as JT
from repro.models.kvcache import init_cache as j_init_cache
from repro.models.model import _encode as j_encode
from repro.models.model import count_params as j_count_params
from repro.models.model import forward_decode as j_forward_decode
from repro.models.model import forward_prefill as j_forward_prefill
from repro.models.model import init_params as j_init_params
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.kernels import launch_counts
from repro_torch.launch import serve as serve_cli
from repro_torch.models import attention as A
from repro_torch.models import transformer as T
from repro_torch.models.kvcache import init_cache
from repro_torch.models.model import (
    CROSS_INPUT,
    _encode,
    count_params,
    forward_decode,
    forward_prefill,
    init_params,
)
from repro_torch.serve.engine import Request, ServeEngine

ENCDEC, VLM = "seamless-m4t-large-v2", "llama-3.2-vision-90b"
FULL_PARAMS = {ENCDEC: 1_632_698_368, VLM: 87_666_794_496}
SEEDED_STEPS = 3      # decode steps of a golden run on seeded embeddings
MAX_MIB = {ENCDEC: 2, VLM: 4}   # llama-vision's hd-128 layout is larger


def _j_layer(tree, j: int = 0):
    """Layer 0 of a JAX stack's scanned superblock entry `j`: the port's
    layer `j` (`params_from_numpy` keeps the scan order)."""
    return jax.tree.map(lambda a: a[0], tree["blocks"][str(j)])


def _cross_layer(jcfg) -> int:
    """The first cross-attention layer (llama-vision) or decoder layer."""
    return len(JT.stack_plan(jcfg).pattern) - 1


class TestConfig:
    def test_configs_equal_the_jax_package(self, arch):
        for j, t in (P.cfgs(arch, "bfloat16"), P.cfgs(arch, "bfloat16", False),
                     (j_get_config(arch), get_config(arch))):
            assert dataclasses.asdict(t) == dataclasses.asdict(j)

    def test_full_width_param_count(self, arch):
        cfg = get_config(arch)
        assert count_params(cfg) == FULL_PARAMS[arch] == cfg.param_count()
        assert j_get_config(arch).param_count() == FULL_PARAMS[arch]

    @pytest.mark.parametrize("layout", [True, False])
    def test_reduced_param_count_matches_jax(self, arch, layout):
        jcfg, tcfg = P.cfgs(arch, "float32", layout)
        assert count_params(tcfg) == j_count_params(jcfg)

    def test_stack_and_encoder_plans_match_jax(self, arch):
        for full in (True, False):
            jcfg, tcfg = j_get_config(arch), get_config(arch)
            if not full:
                jcfg, tcfg = j_reduced(jcfg), reduced_config(tcfg)
            for plan, jplan in ((T.stack_plan, JT.stack_plan),
                                (T.encoder_plan, JT.encoder_plan)):
                assert dataclasses.astuple(plan(tcfg)) == (
                    dataclasses.astuple(jplan(jcfg)))

    def test_cross_layers_have_no_qk_norm(self, arch):
        """With QK-norm and QKV bias on, the port's tree has the JAX
        package's leaves: no q_norm/k_norm in a cross-attention."""
        jcfg, tcfg = P.cfgs(arch, "float32")
        jcfg, tcfg = (c.replace(qk_norm=True, qkv_bias=True)
                      for c in (jcfg, tcfg))
        jp = j_init_params(jcfg, jax.random.key(0))
        tp = init_params(tcfg, 0, device="cpu")
        want = sorted(jax.tree_util.keystr(k, simple=True, separator="/")
                      for k, _ in jax.tree_util.tree_leaves_with_path(
                          _j_layer(jp["stack"], _cross_layer(jcfg))))
        cross = tp["stack"][_cross_layer(jcfg)]
        got = sorted(n.replace(".", "/") for n, _ in cross.named_parameters())
        assert got == want
        xattn = cross["attn"] if arch == VLM else cross["xattn"]
        assert "q_norm" not in xattn and "bq" in xattn
        assert count_params(tcfg) == j_count_params(jcfg) == sum(
            p.numel() for p in tp.parameters())

    def test_init_params_shapes_and_storage_dtypes(self, arch):
        _, tcfg = P.cfgs(arch, "bfloat16")
        tp = init_params(tcfg, 0, device="cpu")
        assert sum(p.numel() for p in tp.parameters()) == count_params(tcfg)
        assert len(tp["stack"]) == tcfg.num_layers
        assert ("encoder" in tp) == ("enc_norm" in tp) == (arch == ENCDEC)
        if arch == ENCDEC:
            assert len(tp["encoder"]) == tcfg.encoder_layers
            assert tp["stack"][0]["xattn"]["wq"].dtype == torch.bfloat16
            assert tp["enc_norm"]["bias"].dtype == torch.float32
        hq, hkv, hd = tcfg.num_heads, tcfg.num_kv_heads, tcfg.head_dim
        last = tp["stack"][-1]["attn"]   # a cross layer in both
        assert last["wq"].shape == (64, hq * hd)
        assert last["wk"].shape == (64, hkv * hd)

    def test_cache_shapes_match_jax(self, arch):
        jcfg, tcfg = P.cfgs(arch, "bfloat16")
        got = init_cache(tcfg, 3, 24, device="cpu")
        want = P.j_layers(j_init_cache(jcfg, 3, 24))
        assert len(got) == len(want) == tcfg.num_layers
        for c, jc in zip(got, want):
            assert sorted(c) == sorted(jc)
            for name in c:
                assert tuple(c[name].shape) == tuple(jc[name].shape)
                assert c[name].dtype == torch.bfloat16
        n = tcfg.num_image_tokens if arch == VLM else 24
        assert got[-1]["ck"].shape == (3, tcfg.num_kv_heads, n, tcfg.head_dim)


class TestBlocks:
    def test_bidirectional_attention_block(self, arch):
        """The encoder's self-attention: RoPE on, no causal mask."""
        jcfg, tcfg, jp, tp = P.models(arch, "float32")
        stack = "encoder" if arch == ENCDEC else "stack"
        jtree, ttree = _j_layer(jp[stack]), tp[stack][0]
        tx, jx = P.x_pair((2, 13, 64), "float32", 21)
        pos = np.arange(13)
        got = A.attention_block(ttree["attn"], tx, tcfg,
                                torch.from_numpy(pos), causal=False)
        want = JA.attention_block(jtree["attn"], jx, jcfg, jnp.asarray(pos),
                                  causal=False)
        P.close(got, want, "float32", {"float32": P.BLOCK_TOL})

    @pytest.mark.parametrize("src_len", [6, 17])
    def test_cross_attention_block(self, arch, src_len):
        jcfg, tcfg, jp, tp = P.models(arch, "float32")
        name = "attn" if arch == VLM else "xattn"
        jattn = _j_layer(jp["stack"], _cross_layer(jcfg))[name]
        tattn = tp["stack"][_cross_layer(jcfg)][name]
        tx, jx = P.x_pair((2, 10, 64), "float32", 22)
        ts, js = P.x_pair((2, src_len, 64), "float32", 23)
        ck, cv = A.project_cross_kv(tattn, ts, tcfg)
        jck, jcv = JA.project_cross_kv(jattn, js, jcfg)
        P.close(ck, jck, "float32", {"float32": P.BLOCK_TOL})
        got = A.cross_attention_block(tattn, tx, tcfg, ck, cv)
        want = JA.cross_attention_block(jattn, jx, jcfg, jck, jcv)
        P.close(got, want, "float32", {"float32": P.BLOCK_TOL})
        # one query against the cache, zero-padded to 24 and masked at
        # src_len: the JAX block over the unpadded K/V
        ck, cv = (torch.nn.functional.pad(t, (0, 0, 0, 24 - src_len))
                  for t in (ck, cv))
        got = A.cross_attention_decode(tattn, tx[:, :1], tcfg, ck, cv,
                                       torch.full((2,), src_len))
        want = JA.cross_attention_block(jattn, jx[:, :1], jcfg, jck, jcv)
        P.close(got, want, "float32", {"float32": P.BLOCK_TOL})

class TestForwards:
    @pytest.mark.parametrize("src_len", [6, 17])
    def test_compiled_jax_forward(self, arch, src_len):
        """The unmodified, compiled JAX forward in f32 on seeded encoder
        frames or image embeddings, shorter and longer than the 10-token
        prompt: prefill, three decode steps and every layer's caches at
        1e-4."""
        jcfg, tcfg, jp, tp = P.models(arch, "float32")
        got, want = P.forwards(jp, tp, jcfg, tcfg, src_len=src_len)
        P.hold_forwards(got, want, "float32", tcfg.num_layers)

    def test_bf16_forward_prefill_and_decode(self, arch, monkeypatch):
        """bf16 against the JAX forward run op by op, its silu rounded
        once (B2); seamless's relu rounds nothing."""
        jcfg, tcfg, jp, tp = P.models(arch, "bfloat16")
        monkeypatch.setattr(jax.nn, "silu", P.round_once(jax.nn.silu))
        with jax.disable_jit():
            got, want = P.forwards(jp, tp, jcfg, tcfg, steps=2, src_len=13)
        P.hold_forwards(got, want, "bfloat16", tcfg.num_layers)

    def test_cross_inputs_take_part(self, arch):
        """The seeded source moves the logits, prefill and decode alike,
        so the forwards above hold the cross path; the engine's zero
        stubs give zero cross K/V for llama-vision."""
        _, tcfg, _, tp = P.models(arch, "float32")
        toks = np.arange(7, dtype=np.int32)[None]
        out = []
        for seed in (30, 31):
            batch, _ = P.batches(tcfg, toks, 8, seed=seed)
            logits, caches = forward_prefill(tp, batch, tcfg, cache_len=12)
            nxt, _ = forward_decode(tp, torch.tensor([[3]]),
                                    torch.tensor([7]), caches, tcfg)
            out.append((logits, nxt))
        for a, b in zip(*out):
            assert float((a - b).abs().max()) > 1e-3
        zeros = {"tokens": torch.from_numpy(toks).long(),
                 CROSS_INPUT[tcfg.family]: torch.zeros(1, 8, 64)}
        _, caches = forward_prefill(tp, zeros, tcfg)
        zero_kv = float(caches[-1]["ck"].abs().max()) == 0.0
        assert zero_kv == (arch == VLM)


class TestServing:
    def test_engine_decode_equals_fresh_prefill_then_decode(self, arch):
        """Requests with seeded sources of their own lengths share the
        slots (cross caches `max_seq` or `num_image_tokens` long, masked
        at each slot's length) and give the tokens of a prefill-then-decode
        of each request alone."""
        _, tcfg, _, tp = P.models(arch, "float32")
        rng = np.random.default_rng(5)
        reqs = []
        for rid in range(4):
            L = int(rng.integers(5, 15))
            n = P.src_len(rid, L) if arch == ENCDEC else (
                tcfg.num_image_tokens - rid % 2)
            reqs.append((rng.integers(0, 256, L).astype(np.int32),
                         rng.normal(size=(n, 64)).astype(np.float32)))
        eng = ServeEngine(tcfg, tp, slots=2, max_seq=32, device="cpu")
        for rid, (prompt, emb) in enumerate(reqs):
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=6,
                               embeds=emb))
        done = {r.rid: r.out_tokens for r in eng.run_to_completion()}
        for rid, (prompt, emb) in enumerate(reqs):
            batch = {"tokens": torch.from_numpy(prompt[None]).long(),
                     CROSS_INPUT[tcfg.family]: torch.from_numpy(emb[None])}
            logits, caches = forward_prefill(tp, batch, tcfg, cache_len=32)
            toks = [int(logits.argmax())]
            for i in range(5):
                logits, caches = forward_decode(
                    tp, torch.tensor([[toks[-1]]]),
                    torch.tensor([len(prompt) + i]), caches, tcfg)
                toks.append(int(logits.argmax()))
            assert done[rid] == toks, rid


class TestEncoder:
    """seamless-m4t's encoder and its cross caches (encdec only)."""

    @pytest.mark.parametrize("src_len", [6, 17])
    def test_encode(self, src_len):
        jcfg, tcfg, jp, tp = P.models(ENCDEC, "float32")
        tx, jx = P.x_pair((2, src_len, 64), "float32", 24)
        P.close(_encode(tp, tx, tcfg), j_encode(jp, jx, jcfg, P.PCTX),
                "float32", {"float32": P.BLOCK_TOL})

    def test_jax_decode_attends_the_padded_cross_cache(self):
        """R4 on the JAX side: its decode over a cross cache zero-padded to
        the slot's length (as its engine's `_insert` leaves it) misses the
        decode over the unpadded cache; the port's, masked at the source
        length, does not."""
        jcfg, tcfg, jp, tp = P.models(ENCDEC, "float32")
        toks = np.random.default_rng(7).integers(0, 256, (2, 10)).astype(
            np.int32)
        tb, jb = P.batches(tcfg, toks, 6)
        _, jc = j_forward_prefill(jp, jb, jcfg, P.PCTX, cache_len=24)
        _, tc = forward_prefill(tp, tb, tcfg, cache_len=24)

        def pad(path, a):
            name = str(getattr(path[-1], "key", ""))
            if name not in ("ck", "cv"):
                return a
            widths = [(0, 0)] * a.ndim
            widths[-2] = (0, 24 - a.shape[-2])
            return jnp.pad(a, widths)

        nxt, pos = jnp.asarray(toks[:, :1]), jnp.full((2,), 10)
        fresh, _ = j_forward_decode(jp, nxt, pos, jc, jcfg, P.PCTX)
        padded, _ = j_forward_decode(
            jp, nxt, pos, jax.tree_util.tree_map_with_path(pad, jc), jcfg,
            P.PCTX)
        assert float(jnp.abs(fresh - padded).max()) > 1e-2
        tpad = [{n: (torch.nn.functional.pad(t, (0, 0, 0, 18))
                     if n in ("ck", "cv") else t) for n, t in c.items()}
                for c in tc]
        got, _ = forward_decode(tp, torch.from_numpy(toks[:, :1]).long(),
                                torch.full((2,), 10), tpad, tcfg,
                                cross_len=torch.full((2,), 6))
        P.close(got, fresh, "float32")


# ---------------- golden runs ------------------------------------------------


def _greedy(prefill, decode, params, batch, n: int):
    """`n` greedy tokens of one request alone (prefill, then decode over
    its own caches: the cross K/V unpadded) and each step's logits."""
    logits, c = prefill(params, batch)
    out, all_logits = [int(jnp.argmax(logits[0]))], [logits[0]]
    pos = batch["tokens"].shape[1]
    for i in range(n - 1):
        logits, c = decode(params, jnp.asarray([[out[-1]]], jnp.int32),
                           jnp.asarray([pos + i], jnp.int32), c)
        out.append(int(jnp.argmax(logits[0])))
        all_logits.append(logits[0])
    return out, np.asarray(all_logits, np.float32)


def cross_golden_reference(arch: str) -> dict:
    """The JAX package's golden run of `arch` in its layout: config,
    parameters, prompts; each prompt's seeded source (`embeds`), its
    prefill logits and `SEEDED_STEPS` greedy decode steps' tokens and
    logits; the greedy tokens of each request alone with the engine's
    zero stubs (`tokens`, what a port slot gives) and the JAX engine's
    tokens (2 slots; its padded cross caches, R4)."""
    jcfg, _ = P.cfgs(arch, "float32")
    params = P.j_params(arch)
    prompts = P._prompts()
    _, engine_toks = P.run_engine(
        lambda c, p, **kw: JServeEngine(c, p, P.PCTX, **kw), JRequest, jcfg,
        params, prompts)
    prefill = jax.jit(lambda p, b: j_forward_prefill(
        p, b, jcfg, P.PCTX, cache_len=P.MAX_SEQ))
    decode = jax.jit(lambda p, t, q, c: j_forward_decode(p, t, q, c, jcfg,
                                                         P.PCTX))
    name = CROSS_INPUT[jcfg.family]
    rng = np.random.default_rng(1)
    out = {"config": np.array(json.dumps(P.LAYOUTS[arch], sort_keys=True))}
    out.update({f"param/{k}": v for k, v in P._flat(params).items()})
    for i, prompt in enumerate(prompts):
        n = (len(prompt) if arch == ENCDEC else jcfg.num_image_tokens)
        tokens = jnp.asarray(prompt[None])
        stub = jnp.zeros((1, n, jcfg.d_model), jnp.float32)
        toks, _ = _greedy(prefill, decode, params,
                          {"tokens": tokens, name: stub}, P.MAX_NEW)
        n = P.src_len(i, len(prompt)) if arch == ENCDEC else n
        emb = rng.normal(size=(n, jcfg.d_model)).astype(np.float32)
        seeded, logits = _greedy(prefill, decode, params,
                                 {"tokens": tokens, name: jnp.asarray(emb[None])},
                                 SEEDED_STEPS + 1)
        out[f"prompt/{i}"] = prompt
        out[f"embeds/{i}"] = emb
        out[f"logits/{i}"] = logits[0]
        out[f"seeded_tokens/{i}"] = np.asarray(seeded, np.int32)
        out[f"seeded_logits/{i}"] = logits[1:]
        out[f"tokens/{i}"] = np.asarray(toks, np.int32)
        out[f"jax_engine_tokens/{i}"] = np.asarray(engine_toks[i], np.int32)
    return out


@pytest.fixture(scope="module")
def golden(arch):
    return arch, cross_golden_reference(arch)


def _stored(arch):
    return dict(np.load(P.GOLDENS[arch]))


class TestGolden:
    def test_stored_data_is_current(self, golden):
        arch, ref = golden
        P.stored_is_current(arch, ref, MAX_MIB[arch])

    def test_engine_gives_each_request_alone(self, golden):
        """The port's engine (2 slots, zero stubs) against the JAX run of
        each request alone; no kernel launches on the CPU."""
        arch, ref = golden
        cfg, params = P.port_from_golden(arch, ref)
        prompts = [ref[f"prompt/{i}"] for i in range(P.REQUESTS)]
        launch_counts.clear()
        eng, toks = P.run_engine(ServeEngine, Request, cfg, params, prompts,
                                 device="cpu")
        for i in range(P.REQUESTS):
            assert toks[i] == ref[f"tokens/{i}"].tolist(), i
        assert eng.prefills == P.REQUESTS and eng.ticks > 0
        assert not launch_counts

    def test_jax_engine_differs_only_by_r4(self, arch):
        """llama-vision's cross caches are never padded, so its JAX engine
        gives the requests' own tokens; seamless's JAX engine attends the
        zero padding of its cross caches (R4) and gives other tokens."""
        stored = _stored(arch)
        differ = [i for i in range(P.REQUESTS)
                  if stored[f"jax_engine_tokens/{i}"].tolist()
                  != stored[f"tokens/{i}"].tolist()]
        assert bool(differ) == (arch == ENCDEC), differ

    def test_port_reproduces_golden_on_cpu(self, arch):
        """What chip_smoke.py checks on the card, on the CPU path: on the
        seeded sources, prefill and decode logits at 1e-4; with the stubs,
        the engine's greedy tokens."""
        stored = _stored(arch)
        cfg, params = P.port_from_golden(arch, stored)
        name = CROSS_INPUT[cfg.family]
        for i in range(P.REQUESTS):
            prompt, seeded = stored[f"prompt/{i}"], stored[f"seeded_tokens/{i}"]
            batch = {"tokens": torch.from_numpy(prompt[None]).long(),
                     name: torch.from_numpy(stored[f"embeds/{i}"][None])}
            logits, caches = forward_prefill(params, batch, cfg,
                                             cache_len=P.MAX_SEQ)
            got = [logits[0]]
            for s in range(SEEDED_STEPS):
                logits, caches = forward_decode(
                    params, torch.tensor([[int(seeded[s])]]),
                    torch.tensor([len(prompt) + s]), caches, cfg)
                got.append(logits[0])
            want = np.concatenate([stored[f"logits/{i}"][None],
                                   stored[f"seeded_logits/{i}"]])
            np.testing.assert_allclose(torch.stack(got).numpy(), want,
                                       atol=1e-4, rtol=1e-4)
        prompts = [stored[f"prompt/{i}"] for i in range(P.REQUESTS)]
        _, toks = P.run_engine(ServeEngine, Request, cfg, params, prompts,
                               device="cpu")
        for i in range(P.REQUESTS):
            assert toks[i] == stored[f"tokens/{i}"].tolist(), i


class TestCli:
    def test_cli_serves_on_cpu(self, arch, capsys):
        serve_cli.main(["--device", "cpu", "--arch", arch, "--requests",
                        "3", "--slots", "2", "--max-new", "4"])
        out = capsys.readouterr().out
        assert f"[serve] {arch} on cpu: 3 requests, 12 tokens" in out

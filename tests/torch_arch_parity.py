"""Shared machinery of tests/test_torch_archs_moe.py,
tests/test_torch_archs_dense.py and tests/test_torch_archs_cross.py: the
port's transformer archs held to the JAX package at reduced size, each
in its own head layout.

`reduced_config` gives every arch head_dim 16 and two query heads a KV
head, which would hide the layouts the kernels see at full width; so
each arch runs reduced with its own layout (`LAYOUTS`): deepseek-moe-16b
MHA at hd 128, smollm-360m hd 64 with 3 query heads a KV head,
yi-9b and qwen1.5-110b hd 128 with 8, stablelm-12b hd 160 (which the
card's flash wrapper zero-pads to 256) with 4, seamless-m4t-large-v2 MHA
at hd 64, llama-3.2-vision-90b hd 128 with 8.  The JAX package's
parameters are drawn from a seed and carried across with
`params_from_numpy`; the leaves it initialises to constants (QKV and
LayerNorm biases, norm scales) are perturbed from a numpy seed first, so
that qwen1.5's QKV bias and stablelm's LayerNorm bias take part.

Golden runs: ``src/repro_torch/data/<arch>_reduced_golden.npz`` holds,
for each arch, its layout (``config``, JSON), the JAX package's f32
parameters, four prompts, the JAX engine's greedy tokens (2 slots, 8 new
tokens each) and each prompt's prefill logits.  chip_smoke.py holds the
card to them.
"""
from __future__ import annotations

import functools
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import reduced_config as j_reduced
from repro.models import moe as JM
from repro.models.model import forward_decode as j_forward_decode
from repro.models.model import forward_prefill as j_forward_prefill
from repro.models.model import init_params as j_init_params
from repro.models.parallel import single_device_ctx
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.configs.base import get_config, reduced_config
from repro_torch.models.convert import params_from_numpy, tree_from_flat
from repro_torch.models.model import (
    CROSS_INPUT,
    forward_decode,
    forward_prefill,
)

DATA = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "data"
LAYOUTS = {
    "deepseek-moe-16b": dict(num_heads=2, num_kv_heads=2, head_dim=128),
    "smollm-360m": dict(num_heads=3, num_kv_heads=1, head_dim=64),
    "yi-9b": dict(num_heads=8, num_kv_heads=1, head_dim=128),
    "stablelm-12b": dict(num_heads=4, num_kv_heads=1, head_dim=160),
    "qwen1.5-110b": dict(num_heads=8, num_kv_heads=1, head_dim=128),
    "seamless-m4t-large-v2": dict(num_heads=2, num_kv_heads=2, head_dim=64),
    "llama-3.2-vision-90b": dict(num_heads=8, num_kv_heads=1, head_dim=128),
}

GOLDENS = {arch: DATA / f"{arch.replace('-', '_').replace('.', '')}"
           "_reduced_golden.npz" for arch in LAYOUTS}
# named as its config module is
GOLDENS["llama-3.2-vision-90b"] = DATA / "llama32_vision_90b_reduced_golden.npz"
TOL = {"float32": dict(atol=1e-4, rtol=1e-4),      # whole forwards
       "bfloat16": dict(atol=2e-2, rtol=2e-2)}
BLOCK_TOL = dict(atol=2e-5, rtol=2e-5)             # f32 blocks
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
PCTX = single_device_ctx()
SLOTS, MAX_SEQ, MAX_NEW, REQUESTS = 2, 64, 8, 4
PERTURBED = {"bq", "bk", "bv", "bias", "scale"}


def cfgs(arch: str, dtype: str, layout: bool = True):
    """(JAX config, port config): reduced, in `arch`'s head layout."""
    kw = dict(LAYOUTS[arch]) if layout else {}
    return (j_reduced(j_get_config(arch)).replace(compute_dtype=dtype, **kw),
            reduced_config(get_config(arch)).replace(compute_dtype=dtype, **kw))


def perturb(params, seed: int):
    """The JAX parameters with every constant-initialised leaf (QKV and
    norm biases to 0.1 N(0, 1), norm scales to 1 + 0.1 N(0, 1)) drawn
    from a numpy seed."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        name = str(getattr(path[-1], "key", ""))
        if name not in PERTURBED:
            return a
        noise = 0.1 * rng.normal(size=a.shape).astype(np.float32)
        return jnp.asarray(noise + (1.0 if name == "scale" else 0.0), a.dtype)
    return jax.tree_util.tree_map_with_path(leaf, params)


@functools.lru_cache(maxsize=None)
def j_params(arch: str, seed: int = 0):
    """The JAX package's parameters of `arch` in its layout, perturbed
    (drawn once: they are float32 whatever the compute dtype)."""
    jcfg, _ = cfgs(arch, "float32")
    return perturb(j_init_params(jcfg, jax.random.key(seed)), seed)


def models(arch: str, dtype: str, seed: int = 0):
    """(jcfg, tcfg, JAX params, the port's params from them)."""
    jcfg, tcfg = cfgs(arch, dtype)
    jp = j_params(arch, seed)
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


def close(got, want, dtype, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol[dtype])


def x_pair(shape, dtype: str, seed: int):
    a = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return torch.from_numpy(a).to(TDT[dtype]), jnp.asarray(a, dtype)


def j_layers(c: dict) -> list:
    """A JAX stack's caches, one dict per layer in the scan order."""
    blocks = c.get("blocks") or {}
    n_scan = len(next(iter(blocks["0"].values()))) if blocks else 0
    scanned = [{name: v[i] for name, v in blocks[str(j)].items()}
               for i in range(n_scan) for j in range(len(blocks))]
    return list(c["prefix"]) + scanned + list(c["tail"])


def batches(tcfg, toks: np.ndarray, src_len: int = 0, seed: int = 12):
    """(port batch, JAX batch) of `toks`, with seeded (B, src_len, D)
    encoder frames or image embeddings in the compute dtype where the
    family reads them."""
    tb, jb = {"tokens": torch.from_numpy(toks).long()}, {
        "tokens": jnp.asarray(toks)}
    name = CROSS_INPUT.get(tcfg.family)
    if name:
        tb[name], jb[name] = x_pair((toks.shape[0], src_len, tcfg.d_model),
                                    tcfg.compute_dtype, seed)
    return tb, jb


def src_len(i: int, prompt_len: int) -> int:
    """Request i's encoder length: below the prompt's, then above."""
    return prompt_len // 2 + 1 if i % 2 == 0 else prompt_len + 5


def forwards(jp, tp, jcfg, tcfg, steps: int = 3, src_len: int = 8):
    """Prefill 2 x 10 tokens into 24-slot caches (with `src_len` seeded
    source positions where the family has cross-attention), then `steps`
    decode steps, through both packages.  Returns (port, JAX), each a list
    of logits (prefill first) and the caches after the last step."""
    B, S, L = 2, 10, 24
    rng = np.random.default_rng(11)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    nxt = rng.integers(0, 256, (steps, B, 1)).astype(np.int32)
    tb, jb = batches(tcfg, toks, src_len)
    logits, caches = forward_prefill(tp, tb, tcfg, cache_len=L)
    jlogits, jcaches = j_forward_prefill(jp, jb, jcfg, PCTX, cache_len=L)
    mine, theirs = [logits], [jlogits]
    for i in range(steps):
        pos = np.full((B,), S + i, np.int32)
        logits, caches = forward_decode(
            tp, torch.from_numpy(nxt[i]).long(), torch.from_numpy(pos).long(),
            caches, tcfg)
        jlogits, jcaches = j_forward_decode(
            jp, jnp.asarray(nxt[i]), jnp.asarray(pos), jcaches, jcfg, PCTX)
        mine.append(logits)
        theirs.append(jlogits)
    return (mine, caches), (theirs, j_layers(jcaches))


def round_once(fn):
    """A JAX activation computed in f32 and rounded once to its input's
    type, as PyTorch computes bf16 activations (ROADMAP Queue 3, B2)."""
    def act(x, *args, **kw):
        return fn(x.astype(jnp.float32), *args, **kw).astype(x.dtype)
    return act


def j_dispatch_round_once(x_tok, gates, idx, wg, wu, wd, cfg, capacity):
    """The JAX single-shard `_dispatch_combine_local` with its einsum trio
    replaced by the JAX package's `moe_gmm_ref`, which rounds once, as the
    kernels do (ROADMAP Queue 3, B1)."""
    from repro.kernels.moe_gmm.ref import moe_gmm_ref

    E = cfg.moe.num_experts
    T, D = x_tok.shape
    k = idx.shape[1]
    e_flat, g_flat = idx.reshape(-1), gates.reshape(-1)
    t_flat = jnp.repeat(jnp.arange(T), k)
    rank = JM._rank_within_expert(e_flat, E)
    keep = rank < capacity
    slot = jnp.where(keep, e_flat * capacity + rank, E * capacity)
    buf = jnp.zeros((E * capacity + 1, D), x_tok.dtype).at[slot].set(
        x_tok[t_flat])
    h = buf[:-1].reshape(E, capacity, D)
    out = moe_gmm_ref(h, wg.astype(h.dtype), wu.astype(h.dtype),
                      wd.astype(h.dtype))
    flat = jnp.concatenate([out.reshape(E * capacity, D),
                            jnp.zeros((1, D), out.dtype)])
    y_slots = flat[slot] * (g_flat * keep)[:, None].astype(out.dtype)
    return jnp.zeros((T, D), out.dtype).at[t_flat].add(y_slots)


def hold_forwards(got, want, dtype: str, num_layers: int) -> None:
    (logits, caches), (jlogits, jcaches) = got, want
    assert logits[0].dtype == torch.float32 and logits[0].shape == (2, 256)
    for a, b in zip(logits, jlogits):
        close(a, b, dtype)
    assert len(caches) == len(jcaches) == num_layers
    for c, jc in zip(caches, jcaches):
        assert sorted(c) == sorted(jc)
        for name in c:
            assert tuple(c[name].shape) == tuple(jc[name].shape)
            close(c[name], jc[name], dtype)


# ---------------- golden runs ------------------------------------------------


def _prompts(seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(rng.integers(5, 20))).astype(np.int32)
            for _ in range(REQUESTS)]


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


def run_engine(engine_cls, request_cls, cfg, params, prompts, **kw):
    eng = engine_cls(cfg, params, slots=SLOTS, max_seq=MAX_SEQ, **kw)
    for rid, prompt in enumerate(prompts):
        eng.submit(request_cls(rid=rid, prompt=prompt, max_new_tokens=MAX_NEW))
    done = eng.run_to_completion(max_ticks=200)
    assert len(done) == len(prompts)
    return eng, {r.rid: r.out_tokens for r in done}


def golden_reference(arch: str) -> dict:
    """The JAX package's golden run of `arch` in its layout: config,
    parameters, prompts, greedy tokens and prefill logits."""
    jcfg, _ = cfgs(arch, "float32")
    params = j_params(arch)
    prompts = _prompts()
    eng, toks = run_engine(lambda c, p, **kw: JServeEngine(c, p, PCTX, **kw),
                           JRequest, jcfg, params, prompts)
    out = {"config": np.array(json.dumps(LAYOUTS[arch], sort_keys=True))}
    out.update({f"param/{k}": v for k, v in _flat(params).items()})
    for i, prompt in enumerate(prompts):
        # the engine's compiled forward_prefill, at the shapes it has seen
        logits, _ = eng._prefill(params, {"tokens": jnp.asarray(prompt[None])})
        out[f"prompt/{i}"] = prompt
        out[f"tokens/{i}"] = np.asarray(toks[i], np.int32)
        out[f"logits/{i}"] = np.asarray(logits[0], np.float32)
    return out


def port_from_golden(arch: str, stored: dict):
    """The port's f32 config (reduced, with the stored layout) and the
    stored parameters on the CPU."""
    cfg = reduced_config(get_config(arch)).replace(
        compute_dtype="float32", **json.loads(str(stored["config"])))
    tree = tree_from_flat({k[len("param/"):]: v for k, v in stored.items()
                           if k.startswith("param/")})
    return cfg, params_from_numpy(cfg, tree, device="cpu")


def stored_is_current(arch: str, golden: dict, max_mib: int = 2) -> None:
    path = GOLDENS[arch]
    stored = dict(np.load(path))
    assert sorted(stored) == sorted(golden)
    for key, want in golden.items():
        if key.startswith("logits/"):
            np.testing.assert_allclose(stored[key], want, rtol=1e-6,
                                       atol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(stored[key], want, err_msg=key)
    assert path.stat().st_size < max_mib * 2**20


def write_goldens(archs, reference=None) -> None:
    """Regenerate the stored golden runs (a test file's ``__main__``),
    each from `reference(arch)` (by default `golden_reference`)."""
    for arch in archs:
        data = (reference or golden_reference)(arch)
        path = GOLDENS[arch]
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **data)
        print(f"wrote {path.name}: {len(data)} arrays, "
              f"{path.stat().st_size} bytes", file=sys.stderr)

"""Shared cases of the serving-on-a-mesh tests, and the code each rank
runs.

tests/test_torch_serve_mesh.py runs these cases through the port on
`torch.distributed` worlds of 2 and 4 gloo ranks on the CPU, and through
the JAX package on 4 fake CPU devices in a subprocess, on the meshes
(data 1, model 2), (data 1, model 4) and (data 2, model 2), ranks
row-major.  Imports no JAX, and torch only inside the rank functions, so
that the JAX subprocess can read the cases.
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

MESHES = {"1x2": ((1, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
SEED = 0
DECODE_STEPS = 3
# reduced qwen3-moe with the heads that split 2 / 1 a rank at model 4
QWEN3_HEADS = (("num_heads", 8), ("num_kv_heads", 4))


@dataclasses.dataclass(frozen=True)
class Case:
    """One forward case: `arch` reduced in f32 with `replace`, a prefill
    of `B` rows of `S` tokens padded to `L` cache positions, then
    `DECODE_STEPS` decode steps, on `mesh`; `src` source positions where
    the family reads a cross-attention source (0: the config's image
    tokens)."""
    id: str
    arch: str
    mesh: str
    L: int
    S: int
    B: int = 1
    replace: tuple = ()
    src: int = 0


def _qwen3(mesh: str, L: int, S: int) -> Case:
    return Case(f"qwen3-{mesh}-L{L}-S{S}", "qwen3-moe-30b-a3b", mesh, L, S,
                replace=QWEN3_HEADS if mesh == "1x4" else ())


# a prefill of 12 tokens divides tp 2 and 4 (the all-to-all branch), 13
# neither (the local branch); a cache of 1,024 positions is cut by
# positions over `model`, one of 64 by KV heads (where they divide)
FORWARD_CASES = tuple(
    [_qwen3(m, L, S) for m in ("1x2", "1x4") for L in (1024, 64)
     for S in (12, 13)]
    + [Case("deepseek-1x2-L1024-S12", "deepseek-moe-16b", "1x2", 1024, 12),
       Case("deepseek-1x2-L64-S13", "deepseek-moe-16b", "1x2", 64, 13),
       Case("yi-2x2-L1024-B4", "yi-9b", "2x2", 1024, 13, B=4),
       Case("yi-2x2-L64-B4", "yi-9b", "2x2", 64, 13, B=4),
       # the cross caches of a 1,024-frame source cut by positions too
       Case("seamless-1x2-L1024-src1024", "seamless-m4t-large-v2", "1x2",
            1024, 13, src=1024),
       Case("seamless-1x2-L64-src12", "seamless-m4t-large-v2", "1x2", 64,
            13, src=12),
       Case("llama-vision-1x2-L1024-img1024", "llama-3.2-vision-90b", "1x2",
            1024, 13, replace=(("num_image_tokens", 1024),)),
       Case("llama-vision-1x2-L64", "llama-3.2-vision-90b", "1x2", 64, 13),
       # a local window of 1,024: the ring is cut by positions, and a
       # prefill of 1,100 tokens wraps it
       Case("rgemma-1x2-L2048-W1024", "recurrentgemma-2b", "1x2", 2048, 1100,
            replace=(("hybrid.local_window", 1024),)),
       Case("rgemma-1x2-L64-W1024", "recurrentgemma-2b", "1x2", 64, 13,
            replace=(("hybrid.local_window", 1024),)),
       Case("mamba-1x2-L64", "falcon-mamba-7b", "1x2", 64, 13)])
CASES = {c.id: c for c in FORWARD_CASES}

# the engine cases: (id, arch, mesh, replace, slots, max_seq, prompt
# lengths, new tokens, held to: "jax" the JAX engine on the same mesh,
# "port" the port's one-process engine (the cross archs: the JAX engine
# attends the padded cross cache, ROADMAP Queue 3 R4))
ENGINE_CASES = {
    "qwen3-1x4": ("qwen3-moe-30b-a3b", "1x4", QWEN3_HEADS, 4, 1024,
                  (12, 9, 16, 13, 20, 7), 6, "jax"),
    "yi-1x4": ("yi-9b", "1x4", (), 4, 64, (11, 8, 15, 6, 9), 5, "jax"),
    "seamless-1x2": ("seamless-m4t-large-v2", "1x2", (), 2, 1024,
                     (9, 14, 7), 5, "port"),
    "llama-vision-1x2": ("llama-3.2-vision-90b", "1x2", (), 2, 1024,
                         (9, 14, 7), 5, "port"),
}
# the stored JAX engine run that chip_smoke.py's serve_mesh_golden holds
# the card to
GOLDEN_CASE = "qwen3-1x4"
GOLDEN_FILE = "qwen3_moe_30b_a3b_reduced_serve_mesh_golden.npz"


def replaced(cfg, replace: tuple):
    """`cfg` with `replace`'s fields; "hybrid.local_window" sets a field
    of the hybrid sub-config."""
    kw, hybrid = {}, {}
    for key, value in replace:
        if key.startswith("hybrid."):
            hybrid[key.split(".", 1)[1]] = value
        else:
            kw[key] = value
    if hybrid:
        kw["hybrid"] = dataclasses.replace(cfg.hybrid, **hybrid)
    return cfg.replace(**kw)


def port_config(arch: str, replace: tuple = ()):
    from repro_torch.configs.base import get_config, reduced_config

    return replaced(reduced_config(get_config(arch)).replace(
        compute_dtype="float32"), replace)


def inputs(case: Case, cfg) -> dict:
    """A forward case's seeded inputs: prompt tokens (B, S), the decode
    steps' tokens (steps, B), and the cross source (B, src, D) where the
    family reads one."""
    rng = np.random.default_rng(SEED + 1)
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (case.B, case.S)).astype(np.int32),
           "steps": rng.integers(0, cfg.vocab_size,
                                 (DECODE_STEPS, case.B)).astype(np.int32)}
    if cfg.family == "encdec":
        out["encoder_embeds"] = rng.normal(
            size=(case.B, case.src, cfg.d_model)).astype(np.float32)
    elif cfg.family == "vlm":
        out["image_embeds"] = rng.normal(
            size=(case.B, cfg.num_image_tokens, cfg.d_model)
        ).astype(np.float32)
    return out


def prompts(lens, vocab: int) -> list:
    rng = np.random.default_rng(SEED + 2)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in lens]


def params_key(arch: str, replace: tuple) -> str:
    """The prefix of an arch's parameters in the exchanged files."""
    return f"{arch}{json.dumps(replace)}/param/"


# ---------------- the port, on every rank ------------------------------------


class _Branches:
    """While entered, counts the MoE's expert-parallel collectives
    (`rotor_all_to_all`, `rotor_all_reduce` by mode) and the experts of
    each `moe_gmm` call."""

    def __enter__(self):
        import collections

        from repro_torch.core import collectives
        from repro_torch.models import moe

        self.calls = collections.Counter()
        self._saved = [(collectives, "rotor_all_to_all"),
                       (collectives, "rotor_all_reduce"), (moe, "moe_gmm")]
        self._orig = [getattr(o, a) for o, a in self._saved]
        a2a, ar, gmm = self._orig

        def rotor_all_to_all(*args, **kw):
            self.calls["rotor_all_to_all"] += 1
            return a2a(*args, **kw)

        def rotor_all_reduce(*args, **kw):
            self.calls[f"rotor_all_reduce/{kw.get('mode', 'rs_ag')}"] += 1
            return ar(*args, **kw)

        def moe_gmm(h, *args, **kw):
            self.calls[f"moe_gmm/E{h.shape[0]}"] += 1
            return gmm(h, *args, **kw)

        for (owner, attr), fn in zip(self._saved, (rotor_all_to_all,
                                                   rotor_all_reduce,
                                                   moe_gmm)):
            setattr(owner, attr, fn)
        return self

    def __exit__(self, *exc):
        for (owner, attr), orig in zip(self._saved, self._orig):
            setattr(owner, attr, orig)
        return False


def _np(t) -> np.ndarray:
    """A copy: decode writes the caches in place."""
    return t.detach().float().cpu().numpy().copy()


def _rows(a: np.ndarray, pctx) -> np.ndarray:
    """This rank's rows of a global batch entry
    (`models.sharding.batch_spec`)."""
    from repro_torch.models.sharding import _block, batch_spec

    return a[_block(a.shape, batch_spec("x", a.shape, pctx), pctx.mesh)]


def _forward(case: Case, stored: dict, mesh) -> dict:
    """A forward case on this rank: each step's logits, the cache blocks
    after the prefill and after the last step, the K/V leaves' cuts, and
    the MoE's branches in the prefill and in the decode steps."""
    import torch

    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.convert import params_from_numpy, tree_from_flat
    from repro_torch.models.model import (CROSS_INPUT, forward_decode,
                                          forward_prefill)

    cfg = port_config(case.arch, case.replace)
    pctx = pctx_for_mesh(mesh)
    prefix = params_key(case.arch, case.replace)
    params = params_from_numpy(cfg, tree_from_flat(
        {k[len(prefix):]: v for k, v in stored.items()
         if k.startswith(prefix)}), device="cpu", pctx=pctx)
    data = inputs(case, cfg)
    batch = {"tokens": torch.from_numpy(_rows(data["tokens"], pctx)).long()}
    if cfg.family in CROSS_INPUT:
        name = CROSS_INPUT[cfg.family]
        batch[name] = torch.from_numpy(_rows(data[name], pctx))
    rows = batch["tokens"].shape[0]
    out = {"logits": []}
    with torch.no_grad():
        with _Branches() as prefill:
            logits, caches = forward_prefill(params, batch, cfg,
                                             cache_len=case.L, pctx=pctx)
        out["logits"].append(_np(logits))
        out["prefill_cache"] = [{n: _np(t) for n, t in c.items()}
                                for c in caches]
        with _Branches() as decode:
            for step in range(DECODE_STEPS):
                tok = torch.from_numpy(_rows(data["steps"][step],
                                             pctx)).long()[:, None]
                pos = torch.full((rows,), case.S + step, dtype=torch.long)
                logits, caches = forward_decode(params, tok, pos, caches,
                                                cfg, pctx=pctx)
                out["logits"].append(_np(logits))
    out["cache"] = [{n: _np(t) for n, t in c.items()} for c in caches]
    out["cuts"] = caches.cuts
    out["branches"] = {"prefill": dict(prefill.calls),
                       "decode": dict(decode.calls)}
    return out


def _engine(name: str, stored: dict, mesh) -> dict:
    """An engine case on this rank: the mesh engine's greedy tokens, each
    prefill's and each tick's logits; where the case is held to the
    port's one-process engine, that engine's tokens on whole weights."""
    import torch

    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.convert import params_from_numpy, tree_from_flat
    from repro_torch.serve import engine as E

    arch, _, replace, slots, max_seq, lens, new, held_to = ENGINE_CASES[name]
    cfg = port_config(arch, replace)
    pctx = pctx_for_mesh(mesh)
    prefix = params_key(arch, replace)
    tree = tree_from_flat({k[len(prefix):]: v for k, v in stored.items()
                           if k.startswith(prefix)})
    reqs = prompts(lens, cfg.vocab_size)
    record = {"prefill": [], "tick": []}
    pf, dc = E.forward_prefill, E.forward_decode

    def prefill(*args, **kw):
        out = pf(*args, **kw)
        record["prefill"].append(_np(out[0]))
        return out

    def decode(*args, **kw):
        out = dc(*args, **kw)
        record["tick"].append(_np(out[0]))
        return out

    def serve(params, pctx_):
        eng = E.ServeEngine(cfg, params, pctx_, slots=slots, max_seq=max_seq,
                            device="cpu")
        for rid, prompt in enumerate(reqs):
            eng.submit(E.Request(rid=rid, prompt=prompt, max_new_tokens=new))
        done = eng.run_to_completion(max_ticks=200)
        return {r.rid: r.out_tokens for r in done}

    E.forward_prefill, E.forward_decode = prefill, decode
    try:
        tokens = serve(params_from_numpy(cfg, tree, device="cpu", pctx=pctx),
                       pctx)
    finally:
        E.forward_prefill, E.forward_decode = pf, dc
    out = {"tokens": tokens, "prefill_logits": record["prefill"],
           "tick_logits": record["tick"]}
    if held_to == "port":
        out["one_process"] = serve(params_from_numpy(cfg, tree, device="cpu"),
                                   E.single_device_ctx())
    return out


def serve_mesh_rank(world, params_path: str) -> dict:
    """Every forward and engine case whose mesh has this world's ranks,
    on this rank."""
    import torch

    from repro_torch.core.comm import Mesh

    torch.set_num_threads(1)
    stored = dict(np.load(params_path))
    meshes = {name: Mesh(*spec) for name, spec in MESHES.items()
              if int(np.prod(spec[0])) == world.size}
    out = {"coords": {name: dict(m.coords) for name, m in meshes.items()},
           "forward": {}, "engine": {}}
    for case in FORWARD_CASES:
        if case.mesh in meshes:
            out["forward"][case.id] = _forward(case, stored,
                                               meshes[case.mesh])
    for name, spec in ENGINE_CASES.items():
        if spec[1] in meshes:
            out["engine"][name] = _engine(name, stored, meshes[spec[1]])
    return out

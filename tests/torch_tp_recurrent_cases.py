"""Shared cases of the mamba and RG-LRU channel-split tests, and the code
each rank runs.

tests/test_torch_tp_recurrent.py runs these cases through the port on a
`torch.distributed` world of 4 gloo ranks on the CPU, and through the
JAX package on 4 fake CPU devices in a subprocess, on the meshes (data
1, model 4) and (data 2, model 2), ranks row-major.  Imports no JAX, and
torch only inside the rank functions, so that the JAX subprocess can
read the cases.
"""
from __future__ import annotations

import dataclasses

import numpy as np

import torch_fsdp_cases as FC

WORLD = 4
MESHES = {"1x4": ((1, 4), ("data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
ARCHS = ("falcon-mamba-7b", "recurrentgemma-2b")

# (id, arch, mesh, replace) of each loss case, reduced, float32, under
# fsdp_tp: the mixers split by channels (reduced d_inner 128, lru_width
# 64) on (data 2, model 2), where in_proj's rows are also cut over `data`
# (on (data 1, model 4) the stored runs' first step holds the gradients:
# its first moment is (1 - b1) times the clipped gradient); a width that does not divide tp 4 (lru_width 66: no mixer leaf is
# cut over `model`; d_model 67, so d_inner 134: mamba's in_proj (67, 268)
# is cut over `model` and gathered whole on use; the former at its two
# RG-LRU layers); and qwen3-moe's expert-parallel all-to-all branch with
# the config's gelu and relu
LOSS_CASES = (
    ("mamba-2x2", "falcon-mamba-7b", "2x2", ()),
    ("rgemma-2x2", "recurrentgemma-2b", "2x2", ()),
    ("rgemma-lru66-1x4", "recurrentgemma-2b", "1x4",
     (("hybrid.lru_width", 66), ("num_layers", 2))),
    ("mamba-d67-1x4", "falcon-mamba-7b", "1x4", (("d_model", 67),)),
    ("qwen3-gelu-1x4", "qwen3-moe-30b-a3b", "1x4", (("act", "gelu"),)),
    ("qwen3-relu-1x4", "qwen3-moe-30b-a3b", "1x4", (("act", "relu"),)),
)
LOSS = {c[0]: c for c in LOSS_CASES}
LOSS_BATCH, LOSS_SEQ, LOSS_SEED = 4, 16, 8

# the stored runs (src/repro_torch/data/<arch>_reduced_tp_golden.npz), at
# (data 1, model 4) under fsdp_tp: `make_train_step` from the port's
# seed-0 draws at the launcher's settings (AdamW lr 1e-4, and 1e-5 for
# recurrentgemma, whose gates amplify f32 noise: ROADMAP Queue 3, B5),
# and `ServeEngine` on those weights: 6 requests of two lengths, odd and
# even, through 4 slots (each length one prefill compile of the JAX
# engine)
GOLDEN_SEED = 0
GOLDEN_MESH = "1x4"
GOLDEN_STEPS = 3
GOLDEN_DATA = dict(seq=16, batch=8, seed=0)
KINDS = FC.KINDS
SERVE = dict(slots=4, max_seq=64, new=4, lens=(9, 12, 12, 9, 9, 12))


def golden_opt(arch: str) -> dict:
    lr = 1e-5 if arch == "recurrentgemma-2b" else 1e-4
    return dict(lr=lr, warmup_steps=5, total_steps=GOLDEN_STEPS)


def golden_file(arch: str) -> str:
    return f"{arch.replace('-', '_').replace('.', '')}_reduced_tp_golden.npz"


# the forward cases: `forward_prefill` of B rows of S tokens into caches
# of L positions, then DECODE_STEPS decode steps, on (data 1, model 4)
FWD_B, FWD_S, FWD_L, DECODE_STEPS = 2, 13, 64, 3


def replaced(cfg, replace: tuple):
    """`cfg` with `replace`'s fields; "hybrid.<f>" sets a field of the
    hybrid sub-config."""
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
    return replaced(FC.port_config(arch), replace)


def loss_tokens(vocab: int) -> tuple:
    """A loss case's global batch: (tokens, targets), int32."""
    rng = np.random.default_rng(LOSS_SEED)
    shape = (LOSS_BATCH, LOSS_SEQ)
    return (rng.integers(0, vocab, shape).astype(np.int32),
            rng.integers(0, vocab, shape).astype(np.int32))


def forward_inputs(vocab: int) -> dict:
    """A forward case's prompt tokens (B, S) and decode tokens (steps, B)."""
    rng = np.random.default_rng(LOSS_SEED + 1)
    return {"tokens": rng.integers(0, vocab, (FWD_B, FWD_S)).astype(np.int32),
            "steps": rng.integers(0, vocab, (DECODE_STEPS, FWD_B)
                                  ).astype(np.int32)}


def prompts(vocab: int) -> list:
    rng = np.random.default_rng(LOSS_SEED + 2)
    return [rng.integers(0, vocab, n).astype(np.int32) for n in SERVE["lens"]]


def golden_params(arch: str) -> dict:
    """The stored runs' weights: the port's seed-0 draws of the reduced
    arch's float32 masters on the CPU (the launcher's first state), by
    the JAX package's flat keys."""
    from repro_torch.models.model import init_params

    cfg = port_config(arch)
    params = init_params(cfg, GOLDEN_SEED, device="cpu", masters=True)
    return FC.to_jax_flat({k: FC._np(p) for k, p in params.named_parameters()},
                          cfg)


# ---------------- the port, on every rank ------------------------------------


def census(mesh):
    """chip_smoke.py's `_Census` of this rank on `mesh`."""
    import torch_tp_cases

    return torch_tp_cases.census(mesh)


def _mixer_gathers(count) -> list:
    """The (leaf, axis) pairs of the mamba and RG-LRU mixers a census saw
    gathered on use."""
    return sorted((leaf, axis) for leaf, axis in count.gathered
                  if ".mixer." in leaf or ".rec." in leaf)


def _losses(world, meshes, params_path: str) -> dict:
    """Each loss case: this rank's loss_fn metrics, the summed gradient
    made whole (rank 0 only), its global norm, the leaves that compute
    tensor-parallel, the mixers' (leaf, axis) pairs gathered on use and
    the collectives, by kind and axis."""
    import torch

    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model import loss_fn
    from repro_torch.models.sharding import computes_tp, gather_leaf
    from repro_torch.train.trainer import _grads, shard_batch, sum_grads

    stored = dict(np.load(params_path))
    out = {}
    for cid, arch, mesh_name, replace in LOSS_CASES:
        cfg = port_config(arch, replace)
        mesh = meshes[mesh_name]
        pctx = pctx_for_mesh(mesh)
        params = params_from_numpy(cfg, FC._tree(stored, f"{cid}/param/"),
                                   device="cpu", masters=True, pctx=pctx)
        toks, tgts = loss_tokens(cfg.vocab_size)
        batch = shard_batch({"tokens": torch.from_numpy(toks).long(),
                             "targets": torch.from_numpy(tgts).long()}, pctx)
        with census(mesh) as count:
            total, metrics = loss_fn(params, batch, cfg, pctx)
            grads, gnorm = sum_grads(_grads(params, total), cfg, pctx)
        whole = {k: FC._np(gather_leaf(k, g, cfg, pctx))
                 for k, g in grads.items()}
        row = {"metrics": {k: float(v.detach()) for k, v in metrics.items()},
               "gnorm": float(gnorm),
               "tp": sorted(k for k, _ in params.named_parameters()
                            if computes_tp(k, cfg, pctx)),
               "mixer_gathers": _mixer_gathers(count),
               "calls": dict(count.calls)}
        if world.rank == 0:
            row["grads"] = whole
        out[cid] = row
    return out


def golden_steps(world, arch: str, mesh, params_path: str) -> dict:
    """The stored run's steps of `arch` through the port's
    `make_train_step` under fsdp_tp on this rank of `mesh`: per step the
    metrics, this rank's blocks of the parameters and both moments, and
    `held` of the parameters; the first step's collectives and the
    mixers' gathers (`census`)."""
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    stored = dict(np.load(params_path))
    cfg = port_config(arch)
    pctx = pctx_for_mesh(mesh)
    params = params_from_numpy(cfg, FC._tree(stored, f"golden/{arch}/"),
                               device=world.device, masters=True, pctx=pctx)
    state = init_train_state(cfg, params)
    step = make_train_step(cfg, pctx, AdamWConfig(**golden_opt(arch)))
    src = SyntheticLM(cfg.vocab_size, GOLDEN_DATA["seq"],
                      GOLDEN_DATA["batch"], seed=GOLDEN_DATA["seed"])
    rows, first = [], {}
    for i, batch in zip(range(GOLDEN_STEPS),
                        device_batches(src, 0, world.device)):
        with census(mesh) as count:
            state, m = step(state, batch)
        if i == 0:
            first = {"calls": dict(count.calls),
                     "mixer_gathers": _mixer_gathers(count)}
        p = state["params"]
        rows.append({
            "metrics": {k: float(v) for k, v in m.items()},
            "blocks": {"param": {k: FC._np(v) for k, v in p.named_parameters()},
                       "m": {k: FC._np(v) for k, v in state["opt"]["m"].items()},
                       "v": {k: FC._np(v)
                             for k, v in state["opt"]["v"].items()}},
            "held": FC.held(p, cfg, pctx)})
    return {"rows": rows, **first}


def _np(t) -> np.ndarray:
    """A copy: decode writes the caches in place."""
    return t.detach().float().cpu().numpy().copy()


def forward(world, arch: str, mesh, params_path: str) -> dict:
    """`forward_prefill` and `DECODE_STEPS` `forward_decode` steps of the
    stored weights of `arch` on this rank of `mesh`: each step's logits,
    the cache blocks after the prefill and after the last step, and the
    last tick's mixer gathers and collectives (`census`)."""
    import torch

    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model import forward_decode, forward_prefill

    stored = dict(np.load(params_path))
    cfg = port_config(arch)
    pctx = pctx_for_mesh(mesh)
    params = params_from_numpy(cfg, FC._tree(stored, f"golden/{arch}/"),
                               device="cpu", pctx=pctx)
    data = forward_inputs(cfg.vocab_size)
    out = {"logits": []}
    with torch.no_grad():
        logits, caches = forward_prefill(
            params, {"tokens": torch.from_numpy(data["tokens"]).long()}, cfg,
            cache_len=FWD_L, pctx=pctx)
        out["logits"].append(_np(logits))
        out["prefill_cache"] = [{n: _np(t) for n, t in c.items()}
                                for c in caches]
        for s in range(DECODE_STEPS):
            tok = torch.from_numpy(data["steps"][s]).long()[:, None]
            pos = torch.full((FWD_B,), FWD_S + s, dtype=torch.long)
            with census(mesh) as count:
                logits, caches = forward_decode(params, tok, pos, caches, cfg,
                                                pctx=pctx)
            out["logits"].append(_np(logits))
    out["cache"] = [{n: _np(t) for n, t in c.items()} for c in caches]
    out["tick"] = {"calls": dict(count.calls),
                   "mixer_gathers": _mixer_gathers(count)}
    return out


def engine(world, arch: str, mesh, params_path: str) -> dict:
    """`ServeEngine` on the stored weights of `arch` on this rank of
    `mesh`, `SERVE`'s requests: the greedy tokens, each prefill's and each
    tick's logits."""
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.serve import engine as E

    stored = dict(np.load(params_path))
    cfg = port_config(arch)
    pctx = pctx_for_mesh(mesh)
    params = params_from_numpy(cfg, FC._tree(stored, f"golden/{arch}/"),
                               device="cpu", pctx=pctx)
    record = {"prefill": [], "tick": []}
    pf, dc = E.forward_prefill, E.forward_decode

    def prefill(*args, **kw):
        got = pf(*args, **kw)
        record["prefill"].append(_np(got[0]))
        return got

    def decode(*args, **kw):
        got = dc(*args, **kw)
        record["tick"].append(_np(got[0]))
        return got

    E.forward_prefill, E.forward_decode = prefill, decode
    try:
        eng = E.ServeEngine(cfg, params, pctx, slots=SERVE["slots"],
                            max_seq=SERVE["max_seq"], device="cpu")
        for rid, prompt in enumerate(prompts(cfg.vocab_size)):
            eng.submit(E.Request(rid=rid, prompt=prompt,
                                 max_new_tokens=SERVE["new"]))
        done = eng.run_to_completion(max_ticks=200)
    finally:
        E.forward_prefill, E.forward_decode = pf, dc
    return {"tokens": {r.rid: r.out_tokens for r in done},
            "prefill_logits": np.concatenate(record["prefill"]),
            "tick_logits": np.stack(record["tick"]),
            "cache_shapes": [{n: tuple(t.shape) for n, t in c.items()}
                             for c in eng.cache]}


def round_trip(meshes) -> dict:
    """`shard_params` then `gather_params` of each arch's whole tree
    (seed 0) at this rank's coordinates of each mesh, and
    `train.checkpoint.shard_cut` of the whole arrays: whether every leaf
    came back with its bits, and whether the checkpoint's cut of each
    whole array is the block `shard_params` kept (mamba's in_proj as the
    rank's x and z columns)."""
    import torch

    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.model import init_params
    from repro_torch.models.sharding import gather_params, shard_params
    from repro_torch.train.checkpoint import shard_cut

    out = {}
    for arch in ARCHS:
        cfg = port_config(arch)
        for name, mesh in meshes.items():
            pctx = pctx_for_mesh(mesh)
            params = init_params(cfg, 0, device="cpu", masters=True)
            whole = {k: p.detach().clone()
                     for k, p in params.named_parameters()}
            shard_params(params, cfg, pctx)
            cut = shard_cut(cfg, pctx)
            held = {k: p.detach().clone()
                    for k, p in params.named_parameters()}
            restored = all(torch.equal(
                torch.from_numpy(whole[k].numpy()[cut(
                    "params/" + k.replace(".", "/"), tuple(whole[k].shape))]),
                held[k]) for k in whole)
            gather_params(params, cfg, pctx)
            after = dict(params.named_parameters())
            out[(arch, name)] = {
                "restored": restored,
                "equal": sorted(after) == sorted(whole) and all(
                    torch.equal(after[k].detach(), v)
                    for k, v in whole.items())}
    return out


def tp_recurrent_rank(world, params_path: str) -> dict:
    """Everything the channel-split tests hold on this rank."""
    import torch

    from repro_torch.core.comm import Mesh

    torch.set_num_threads(1)
    meshes = {name: Mesh(*spec) for name, spec in MESHES.items()}
    gm = meshes[GOLDEN_MESH]
    return {"coords": {n: dict(m.coords) for n, m in meshes.items()},
            "losses": _losses(world, meshes, params_path),
            "steps": {arch: golden_steps(world, arch, gm, params_path)
                      for arch in ARCHS},
            "forward": {arch: forward(world, arch, gm, params_path)
                        for arch in ARCHS},
            "engine": {arch: engine(world, arch, gm, params_path)
                       for arch in ARCHS},
            "round_trip": round_trip(meshes)}

"""Shared cases of the tensor-parallel compute tests, and the code each
rank runs.

tests/test_torch_tp.py runs these cases through the port on a
`torch.distributed` world of 4 gloo ranks on the CPU, and through the
JAX package on 4 fake CPU devices in a subprocess, on the meshes (data
2, model 2) and (data 1, model 4), ranks row-major.  Imports no JAX, and
torch only inside the rank functions, so that the JAX subprocess can
read the cases.
"""
from __future__ import annotations

import numpy as np

import torch_fsdp_cases as FC

WORLD = 4
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "1x4": ((1, 4), ("data", "model"))}

# (arch, layout, mesh) of each loss case, reduced, float32: attention by
# heads (4 / 2 on two model ranks; on four, yi-9b's 2 KV heads do not
# split and its attention gathers whole), the dense FFN, deepseek's shared
# experts and first dense layer, seamless's encoder, cross-attention and
# plain FFN with its output bias, llama-vision's cross layers, the
# embeddings and heads (tied or not) by vocab
LOSS_CASES = (("qwen1.5-110b", "fsdp_tp", "2x2"),
              ("deepseek-moe-16b", "fsdp_tp", "2x2"),
              ("seamless-m4t-large-v2", "fsdp_tp", "2x2"),
              ("llama-3.2-vision-90b", "tp_only", "2x2"),
              ("yi-9b", "fsdp_tp", "1x4"))
LOSS_BATCH, LOSS_SEQ, LOSS_SEED, SRC_LEN = 4, 16, 6, 12
# constant-initialised leaves drawn from the seed beside
# tests/torch_arch_parity.PERTURBED: the plain FFN's biases, so that an
# output bias added on every model rank shows
PERTURBED = ("b_in", "b_out")

# the stored training run: reduced qwen1.5-110b (QKV bias, untied head)
# in float32 from the port's seed-0 draws at the launcher's settings (as
# tests/torch_fsdp_cases.py's `LAUNCH`, at this arch), `make_train_step`
# at (data 2, model 2) under fsdp_tp; the same run under tp_only is held
# to the JAX package's without being stored
GOLDEN_ARCH = "qwen1.5-110b"
GOLDEN_SEED = FC.GOLDEN_SEED
GOLDEN_OPT = FC.GOLDEN_OPT
GOLDEN_DATA = FC.GOLDEN_DATA
GOLDEN_STEPS = FC.GOLDEN_STEPS
GOLDEN_MESH = "2x2"
STEP_LAYOUTS = ("fsdp_tp", "tp_only")
KINDS = FC.KINDS

# the structural case: one tp_only step of reduced smollm-360m at (data 2,
# model 2), its collectives counted
STRUCT_ARCH = "smollm-360m"

port_config = FC.port_config
to_jax_flat = FC.to_jax_flat


def loss_batch(cfg) -> dict:
    """The global batch of a loss case: tokens and targets (int32) and
    the cross-attention's source where the family reads one (float32
    encoder frames of `SRC_LEN`, or the config's image embeddings)."""
    rng = np.random.default_rng(LOSS_SEED)
    shape = (LOSS_BATCH, LOSS_SEQ)
    out = {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}
    if cfg.family == "encdec":
        out["encoder_embeds"] = rng.normal(
            size=(LOSS_BATCH, SRC_LEN, cfg.d_model)).astype(np.float32)
    elif cfg.family == "vlm":
        out["image_embeds"] = rng.normal(
            size=(LOSS_BATCH, cfg.num_image_tokens, cfg.d_model)
        ).astype(np.float32)
    return out


def golden_params() -> dict:
    """The stored run's initial parameters: the port's seed-0 draws of
    reduced qwen1.5-110b's float32 masters on the CPU (the launcher's
    first state), by the JAX package's flat keys."""
    from repro_torch.models.model import init_params

    cfg = port_config(GOLDEN_ARCH)
    params = init_params(cfg, GOLDEN_SEED, device="cpu", masters=True)
    return to_jax_flat({k: FC._np(p) for k, p in params.named_parameters()},
                       cfg)


# ---------------- the port, on every rank ------------------------------------


def census(mesh):
    """chip_smoke.py's `_Census` of this rank's collectives on `mesh`, the
    leaves gathered on use over each axis and the flash calls by heads
    (the card's tp_full phase counts with it)."""
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from chip_smoke import _Census

    return _Census(mesh.shape)


def _batch(arrays: dict, pctx) -> dict:
    import torch

    from repro_torch.train.trainer import shard_batch

    return shard_batch({k: (torch.from_numpy(v).long() if v.dtype.kind == "i"
                            else torch.from_numpy(v))
                        for k, v in arrays.items()}, pctx)


def _losses(world, meshes, params_path: str) -> dict:
    """Each loss case: this rank's loss_fn metrics, the summed gradient
    made whole (rank 0 only), its global norm, the leaves that compute
    tensor-parallel, and the (leaf, axis) pairs gathered on use."""
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model import loss_fn
    from repro_torch.models.sharding import computes_tp, gather_leaf
    from repro_torch.train.trainer import _grads, sum_grads

    stored = dict(np.load(params_path))
    out = {}
    for arch, layout, mesh_name in LOSS_CASES:
        cfg = port_config(arch)
        mesh = meshes[mesh_name]
        pctx = pctx_for_mesh(mesh, layout=layout)
        params = params_from_numpy(cfg, FC._tree(stored, f"{arch}/param/"),
                                   device="cpu", masters=True, pctx=pctx)
        batch = _batch(loss_batch(cfg), pctx)
        with census(mesh) as count:
            total, metrics = loss_fn(params, batch, cfg, pctx)
            grads, gnorm = sum_grads(_grads(params, total), cfg, pctx)
        whole = {k: FC._np(gather_leaf(k, g, cfg, pctx))
                 for k, g in grads.items()}
        row = {"metrics": {k: float(v.detach()) for k, v in metrics.items()},
               "gnorm": float(gnorm),
               "tp": sorted(k for k, _ in params.named_parameters()
                            if computes_tp(k, cfg, pctx)),
               "gathered": sorted(count.gathered)}
        if world.rank == 0:
            row["grads"] = whole
        out[(arch, layout, mesh_name)] = row
    return out


def golden_steps(world, path: str, mesh, layout: str) -> dict:
    """The stored run's steps through the port's `make_train_step` under
    `layout` on this rank: per step the metrics, this rank's blocks of
    the parameters and both moments, and `held` of the parameters."""
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    stored = dict(np.load(path))
    cfg = port_config(GOLDEN_ARCH)
    pctx = pctx_for_mesh(mesh, layout=layout)
    params = params_from_numpy(cfg, FC._tree(stored, "param/"),
                               device=world.device, masters=True, pctx=pctx)
    state = init_train_state(cfg, params)
    step = make_train_step(cfg, pctx, AdamWConfig(**GOLDEN_OPT))
    src = SyntheticLM(cfg.vocab_size, GOLDEN_DATA["seq"],
                      GOLDEN_DATA["batch"], seed=GOLDEN_DATA["seed"])
    rows = []
    for _, batch in zip(range(GOLDEN_STEPS),
                        device_batches(src, 0, world.device)):
        state, m = step(state, batch)
        p = state["params"]
        rows.append({
            "metrics": {k: float(v) for k, v in m.items()},
            "blocks": {"param": {k: FC._np(v)
                                 for k, v in p.named_parameters()},
                       "m": {k: FC._np(v) for k, v in state["opt"]["m"].items()},
                       "v": {k: FC._np(v)
                             for k, v in state["opt"]["v"].items()}},
            "held": FC.held(p, cfg, pctx)})
    return {"rows": rows}


def _structure(world, mesh) -> dict:
    """One tp_only step of reduced smollm-360m from seed 0 on this rank,
    its collectives counted (`census`), `Mesh.sent_bytes` across it, the
    leaves that compute tensor-parallel and every leaf's shape."""
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.launch.mesh import pctx_for_mesh
    from repro_torch.models.model import init_params
    from repro_torch.models.sharding import computes_tp
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    cfg = port_config(STRUCT_ARCH)
    pctx = pctx_for_mesh(mesh, layout="tp_only")
    state = init_train_state(cfg, init_params(cfg, 0, device="cpu",
                                              masters=True, pctx=pctx))
    step = make_train_step(cfg, pctx, AdamWConfig(**GOLDEN_OPT))
    batch = next(device_batches(SyntheticLM(
        cfg.vocab_size, GOLDEN_DATA["seq"], GOLDEN_DATA["batch"], seed=0),
        0, "cpu"))
    sent = mesh.sent_bytes
    with census(mesh) as count:
        step(state, batch)
    params = state["params"]
    return {"calls": dict(count.calls), "payload": dict(count.payload),
            "gathered": sorted(count.gathered), "heads": dict(count.heads),
            "sent_bytes": mesh.sent_bytes - sent,
            "tp": sorted(k for k, _ in params.named_parameters()
                         if computes_tp(k, cfg, pctx)),
            "shapes": {k: tuple(p.shape) for k, p in params.named_parameters()}}


def tp_rank(world, params_path: str, golden_path: str) -> dict:
    """Everything the tensor-parallel tests hold on this rank."""
    import torch

    from repro_torch.core.comm import Mesh

    torch.set_num_threads(1)
    meshes = {name: Mesh(*spec) for name, spec in MESHES.items()}
    mesh = meshes[GOLDEN_MESH]
    return {"coords": dict(mesh.coords),
            "losses": _losses(world, meshes, params_path),
            "steps": {layout: golden_steps(world, golden_path, mesh, layout)
                      for layout in STEP_LAYOUTS},
            "structure": _structure(world, mesh)}

"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --reduced --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --steps 12 \
        --batch 8 --seq 4096 --ckpt-dir build/ckpt
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
        --reduced --steps 3 [--compress-grads]
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
        --reduced --trainer gspmd --tp 2 --steps 3 [--arch qwen3-moe-30b-a3b]

Port of `repro.launch.train` with its flags, plus ``--device`` (the card
by default) and ``--no-reduced``.  As the JAX launcher, it trains the
full config unless given ``--reduced`` (`configs.base.reduced_config`).
Parameters are trainable float32 masters drawn from ``--seed`` (the JAX
package's distributions, not its bits), trained on `SyntheticLM`'s
stream with AdamW (warmup of max(steps // 20, 5) steps, cosine decay
over ``--steps``).

Under torchrun (or in a world already joined) every rank runs this
function: `core.comm.init_world` joins the world and ``--mesh host``
lays its ranks out as (world / tp, tp) over (data, model).
``--trainer opera-dp`` (the default, as the JAX launcher's) runs
`train.opera_dp` over it, each rank on its data shard's rows, the model
ranks as replicas, with ``--compress-grads`` its int8 gradient sync.
``--trainer gspmd`` runs `train.trainer.make_train_step` on the mesh at
any ``--tp``: every rank holds its blocks of each leaf and of both
moments, placed as the JAX launcher places them (`models.sharding`,
``fsdp_tp``: each matrix over `model` on its parallel dim and over
`data` on the other, so ``--tp 1`` cuts every matrix over the data
ranks), gathers them on use and gets each gradient reduce-scattered;
with ``--tp`` above 1 attention splits by heads, the FFNs by width, the
mamba and RG-LRU mixers by channels and the embedding and head by vocab
over the model ranks where they divide
(`models.sharding.computes_tp`; those leaves are gathered over `data`
alone), and each MoE layer's experts are split over the model ranks and
reached through `rotor_all_to_all`.  On
one process without a world the mesh is one rank, and both trainers run
the single-process step (opera-dp without ``--compress-grads``).
``--tp`` that does not divide the world raises a ValueError; ``--mesh
pod`` / ``multipod`` on a world of another size than 256 / 512 ranks
raises (ROADMAP Queue 1 item 7c).

Rank 0 prints the loss floor, each logged step's loss, gradient norm
and lr, and ``loss a -> b`` at the end, as the JAX launcher does, and
saves the checkpoints: the whole state, the sharded leaves and their
moments gathered from every rank (`train.checkpoint.whole_state`); a
``--resume`` at the same ``--tp`` gives each rank its blocks back.  The
replicas are the same; with ``--compress-grads`` rank 0 saves its own
gradient error, as the JAX launcher saves device 0's.  `main` returns
the run: per-step losses, gradient norms, lrs and host seconds (each
step ends in a read of its loss), each step's bytes sent and host
seconds on the wire by this rank, the seconds parameter init took, and
the world's backend.  `on_step(step, state, metrics)`, if given, is
called after each step, outside its time.
"""
from __future__ import annotations

import argparse
import math
import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, list_archs, reduced_config
from repro_torch.core.comm import init_world
from repro_torch.data.pipeline import SyntheticLM, device_batches
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     pctx_for_mesh)
from repro_torch.models.model import init_params, param_shapes
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.checkpoint import Checkpointer, shard_cut, whole_state
from repro_torch.train.opera_dp import (init_opera_dp_state,
                                        make_opera_dp_train_step)
from repro_torch.train.trainer import init_train_state, make_train_step

ITEM_7C = ("the production meshes' GSPMD trainer (its rotor pod branch, "
           "grad_sync) is ROADMAP Queue 1 item 7c")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, on_step: Optional[Callable] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list_archs())
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=False)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default="host", choices=["host", "pod", "multipod"])
    ap.add_argument("--tp", type=int, default=1)
    ap.add_argument("--trainer", default="opera-dp",
                    choices=["opera-dp", "gspmd"])
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        world = init_world(args.device)
        device, rank, backend = world.device, world.rank, world.backend
        size = world.size
    else:
        device, rank, backend = resolve_device(args.device), 0, None
        size = 1
    if args.mesh == "host":
        if args.tp < 1 or size % args.tp:
            raise ValueError(f"--tp {args.tp} does not divide the world's "
                             f"{size} rank(s) into model rows")
        mesh = make_host_mesh(model=args.tp)
    else:
        try:
            mesh = make_production_mesh(multi_pod=args.mesh == "multipod")
        except ValueError as e:
            raise NotImplementedError(
                f"--mesh {args.mesh}: {e}; {ITEM_7C}") from e
    pctx = pctx_for_mesh(mesh)
    say = print if rank == 0 else (lambda *a, **k: None)
    # f32 matmuls in full f32, as the JAX package's dots
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 5))
    # the GSPMD trainer keeps this rank's block of each sharded leaf
    sharded = args.trainer == "gspmd"

    _sync(device)
    t0 = time.perf_counter()
    if args.trainer == "opera-dp":
        params = init_params(cfg, args.seed, device=device, masters=True)
        state = init_opera_dp_state(params, compress=args.compress_grads)
        step_fn = make_opera_dp_train_step(cfg, pctx, opt,
                                           compress=args.compress_grads)
    else:
        params = init_params(cfg, args.seed, device=device, masters=True,
                             pctx=pctx)
        state = init_train_state(cfg, params)
        step_fn = make_train_step(cfg, pctx, opt)
    _sync(device)
    init_s = time.perf_counter() - t0

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state, start_step = ckpt.restore(
            state, cut=shard_cut(cfg, pctx) if sharded else None)
        say(f"[train] resumed from step {start_step}")

    def save(step: int, blocking: bool = False) -> None:
        whole = whole_state(state, cfg, pctx) if sharded else state
        if rank == 0:   # every rank gathers; one writes
            ckpt.save(step, whole, blocking=blocking)

    src = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    batches = device_batches(src, start_step, device)
    floor = src.conditional_entropy()
    n_params = sum(math.prod(s) for s in param_shapes(cfg).values())
    say(f"[train] {cfg.name} ({n_params:,} params), device {device}, "
        f"mesh {mesh.shape}, trainer={args.trainer}, floor={floor:.3f} "
        "nats", flush=True)
    run = dict(losses=[], grad_norms=[], lrs=[], step_s=[], sent_bytes=[],
               wire_s=[], init_s=init_s, params=n_params, floor=floor,
               start_step=start_step, backend=backend)
    t_start = time.perf_counter()
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        sent, wire = mesh.sent_bytes, mesh.wire_s
        batch = next(batches)
        state, metrics = step_fn(state, batch)
        run["losses"].append(float(metrics["loss"]))   # waits for the step
        run["step_s"].append(time.perf_counter() - t0)
        run["sent_bytes"].append(mesh.sent_bytes - sent)
        run["wire_s"].append(mesh.wire_s - wire)
        run["grad_norms"].append(float(metrics["grad_norm"]))
        run["lrs"].append(float(metrics["lr"]))
        if on_step is not None:
            on_step(step, state, metrics)
        if step % args.log_every == 0 or step == args.steps - 1:
            say(
                f"[train] step {step:5d} loss {run['losses'][-1]:.4f} "
                f"gnorm {run['grad_norms'][-1]:.3f} "
                f"lr {run['lrs'][-1]:.2e} "
                f"({(time.perf_counter() - t_start):.1f}s)",
                flush=True,
            )
        if ckpt and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
    if ckpt:
        save(args.steps, blocking=True)
    losses = run["losses"]
    if losses:
        say(f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
            f"(floor {floor:.3f})")
    return run


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()

"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --no-reduced \
        --steps 12 --batch 8 --seq 4096 --ckpt-dir build/ckpt
    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
        --steps 3 [--compress-grads]

Port of `repro.launch.train` with its flags, plus ``--device`` (the card
by default) and ``--reduced`` / ``--no-reduced`` as `launch.serve` has
them (reduced by default, so the CPU runs stay small; ``--no-reduced``
is full width).  Parameters are trainable float32 masters drawn from
``--seed`` (the JAX package's distributions, not its bits), trained on
`SyntheticLM`'s stream with AdamW (warmup of max(steps // 20, 5) steps,
cosine decay over ``--steps``).

Under torchrun (or in a world already joined) every rank runs this
function: `core.comm.init_world` joins the world, ``--mesh host`` lays
its ranks out as (data, model), and ``--trainer opera-dp`` (the default,
as the JAX launcher's) runs `train.opera_dp` over it, each rank on its
shard of the global batch, with ``--compress-grads`` its int8 gradient
sync.  On one process without a world the mesh is one rank, and
opera-dp without ``--compress-grads`` runs
`train.trainer.make_train_step`, as ``--trainer gspmd`` does.  ``--tp``
above 1, ``--trainer gspmd`` on a world above one rank and ``--mesh
pod`` / ``multipod`` on a world of another size than 256 / 512 ranks
raise (ROADMAP Queue 1 item 7b).

Rank 0 prints the loss floor, each logged step's loss, gradient norm
and lr, and ``loss a -> b`` at the end, as the JAX launcher does, and
saves the checkpoints (the replicas are the same; with
``--compress-grads`` its own gradient error, as the JAX launcher saves
device 0's).  `main` returns the run: per-step losses, gradient norms,
lrs and host seconds (each step ends in a read of its loss), each
step's bytes sent and host seconds on the wire by this rank, the
seconds parameter init took, and the world's backend.  `on_step(step,
state, metrics)`, if given, is called after each step, outside its
time.
"""
from __future__ import annotations

import argparse
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
from repro_torch.models.model import init_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.opera_dp import (init_opera_dp_state,
                                        make_opera_dp_train_step)
from repro_torch.train.trainer import init_train_state, make_train_step

ITEM_7B = ("needs the ParallelContext through the model, sharded weights "
           "and the GSPMD trainer's rotor pod branch (ROADMAP Queue 1 item "
           "7b)")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None, on_step: Optional[Callable] = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list_archs())
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
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
    if args.tp != 1:
        raise NotImplementedError(f"--tp {args.tp} {ITEM_7B}")

    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) > 1:
        world = init_world(args.device)
        device, rank, backend = world.device, world.rank, world.backend
        if args.trainer == "gspmd" and world.size > 1:
            raise NotImplementedError(
                f"--trainer gspmd on {world.size} ranks {ITEM_7B}")
    else:
        device, rank, backend = resolve_device(args.device), 0, None
    if args.mesh == "host":
        mesh = make_host_mesh(model=args.tp)
    else:
        try:
            mesh = make_production_mesh(multi_pod=args.mesh == "multipod")
        except ValueError as e:
            raise NotImplementedError(
                f"--mesh {args.mesh}: {e} (ROADMAP Queue 1 item 7b)") from e
    pctx = pctx_for_mesh(mesh)
    say = print if rank == 0 else (lambda *a, **k: None)
    # f32 matmuls in full f32, as the JAX package's dots
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 5))

    _sync(device)
    t0 = time.perf_counter()
    params = init_params(cfg, args.seed, device=device, masters=True)
    if args.trainer == "opera-dp":
        state = init_opera_dp_state(params, compress=args.compress_grads)
        step_fn = make_opera_dp_train_step(cfg, pctx, opt,
                                           compress=args.compress_grads)
    else:
        state = init_train_state(cfg, params)
        step_fn = make_train_step(cfg, opt)
    _sync(device)
    init_s = time.perf_counter() - t0

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state, start_step = ckpt.restore(state)
        say(f"[train] resumed from step {start_step}")
    saves = ckpt if rank == 0 else None

    src = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    batches = device_batches(src, start_step, device)
    floor = src.conditional_entropy()
    n_params = sum(p.numel() for p in params.parameters())
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
        if saves and (step + 1) % args.ckpt_every == 0:
            saves.save(step + 1, state)
    if saves:
        saves.save(args.steps, state, blocking=True)
    losses = run["losses"]
    if losses:
        say(f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
            f"(floor {floor:.3f})")
    return run


if __name__ == "__main__":
    main()
    if dist.is_initialized():
        dist.destroy_process_group()

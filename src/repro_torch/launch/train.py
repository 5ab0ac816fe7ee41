"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 3
    PYTHONPATH=src python -m repro_torch.launch.train --no-reduced \
        --steps 12 --batch 8 --seq 4096 --ckpt-dir build/ckpt

Port of `repro.launch.train` with its flags, plus ``--device`` (the card
by default) and ``--reduced`` / ``--no-reduced`` as `launch.serve` has
them (reduced by default, so the CPU runs stay small; ``--no-reduced``
is full width).  Parameters are trainable float32 masters drawn from
``--seed`` (the JAX package's distributions, not its bits), trained on
`SyntheticLM`'s stream with AdamW (warmup of max(steps // 20, 5) steps,
cosine decay over ``--steps``).  ``--trainer`` takes both of the JAX
package's names: on one process they give the same update
(tests/test_trainer_serve.py:49-73), `train.trainer.make_train_step`'s.
The mesh, tensor parallelism and compressed gradient sync need the rotor
collectives and a process group (ROADMAP Queue 1 item 7): ``--mesh pod``
or ``multipod``, ``--tp`` above 1 and ``--compress-grads`` raise.

`main` prints the loss floor, each logged step's loss, gradient norm and
lr, and ``loss a -> b`` at the end, as the JAX launcher does, and
returns the run: per-step losses, gradient norms, lrs and host seconds
(each step ends in a read of its loss), and the seconds parameter init
took.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, list_archs, reduced_config
from repro_torch.data.pipeline import SyntheticLM, device_batches
from repro_torch.models.model import init_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.checkpoint import Checkpointer
from repro_torch.train.trainer import init_train_state, make_train_step

ITEM_7 = "needs the rotor collectives and a process group (ROADMAP Queue 1 " \
         "item 7)"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> dict:
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
    if args.mesh != "host":
        raise NotImplementedError(f"--mesh {args.mesh} {ITEM_7}")
    if args.tp != 1:
        raise NotImplementedError(f"--tp {args.tp} {ITEM_7}")
    if args.compress_grads:
        raise NotImplementedError(f"--compress-grads {ITEM_7}")

    device = resolve_device(args.device)
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
    state = init_train_state(cfg, params)
    _sync(device)
    init_s = time.perf_counter() - t0
    step_fn = make_train_step(cfg, opt)

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        state, start_step = ckpt.restore(state)
        print(f"[train] resumed from step {start_step}")

    src = SyntheticLM(cfg.vocab_size, args.seq, args.batch, seed=args.seed)
    batches = device_batches(src, start_step, device)
    floor = src.conditional_entropy()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"[train] {cfg.name} ({n_params:,} params), device {device}, "
          f"trainer={args.trainer}, floor={floor:.3f} nats", flush=True)
    run = dict(losses=[], grad_norms=[], lrs=[], step_s=[], init_s=init_s,
               params=n_params, floor=floor, start_step=start_step)
    t_start = time.perf_counter()
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()
        batch = next(batches)
        state, metrics = step_fn(state, batch)
        run["losses"].append(float(metrics["loss"]))   # waits for the step
        run["step_s"].append(time.perf_counter() - t0)
        run["grad_norms"].append(float(metrics["grad_norm"]))
        run["lrs"].append(float(metrics["lr"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(
                f"[train] step {step:5d} loss {run['losses'][-1]:.4f} "
                f"gnorm {run['grad_norms'][-1]:.3f} "
                f"lr {run['lrs'][-1]:.2e} "
                f"({(time.perf_counter() - t_start):.1f}s)",
                flush=True,
            )
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, state)
    if ckpt:
        ckpt.save(args.steps, state, blocking=True)
    losses = run["losses"]
    if losses:
        print(f"[train] done: loss {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"(floor {floor:.3f})")
    return run


if __name__ == "__main__":
    main()

"""Serving launcher: continuous-batching engine over a ported arch.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \
        --arch recurrentgemma-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --no-reduced \
        --requests 8 --slots 4 --max-new 16 --max-seq 1024

Port of `repro.launch.serve` with its flags, plus ``--device`` (the card
by default) and a ``--reduced`` that can be turned off: the JAX flag is
``store_true`` with ``default=True``, so it never reaches full width;
here ``--no-reduced`` does.  Parameters are random, from ``--seed``.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import get_config, list_archs, reduced_config
from repro_torch.models.model import init_params
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m",
                    choices=list_archs())
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    # f32 matmuls in full f32, as the JAX package's dots
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    params = init_params(cfg, args.seed, device=device)
    eng = ServeEngine(cfg, params, slots=args.slots, max_seq=args.max_seq,
                      device=device)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    for rid in range(args.requests):
        eng.submit(Request(
            rid=rid,
            prompt=rng.integers(
                0, cfg.vocab_size, int(rng.integers(4, 16))
            ).astype(np.int32),
            max_new_tokens=args.max_new,
        ))
    done = eng.run_to_completion()
    dt = time.time() - t0
    toks = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {cfg.name} on {device}: {len(done)} requests, {toks} "
          f"tokens, {dt:.1f}s ({toks/dt:.1f} tok/s)")
    for r in done[:4]:
        print(f"  req {r.rid}: {r.prompt[:6].tolist()}... -> {r.out_tokens}")


if __name__ == "__main__":
    main()

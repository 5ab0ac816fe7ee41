"""U1: does falcon-mamba's full-width loss rise at lr 1e-3 in the JAX
package too?  A check on the CPU, run once by hand (not a Tier-1 test):

    JAX_PLATFORMS=cpu PYTHONPATH=src python tests/torch_u1_lr_check.py \
        [--layers 2] [--seq 128] [--steps 10] [--lr 1e-3] [--out FILE]

Both packages' train steps (the JAX package's `make_train_step`, the
port's `train.trainer.make_train_step`) from one set of weights: the JAX
package's `init_params` of falcon-mamba-7b at full width (d_model 4096,
d_inner 8192, vocab 65,024) cut to `--layers` layers, f32 masters and
bf16 compute as the config has them, carried into the port with
`params_from_numpy`; `SyntheticLM` batches of B 1 (seed 0); AdamW at
`--lr` with the launcher's warmup (max(steps // 20, 5) steps).  Each
package runs in a process of its own, one after the other (each holds
~12 GB of masters, gradients and moments), and prints each step's loss,
gradient norm and lr; the script prints both trajectories and their
largest relative difference as one JSON line, also written to FILE.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ARCH = "falcon-mamba-7b"


def _jax_params(layers: int, seed: int):
    import jax

    from repro.configs import get_config as j_get_config
    from repro.models.model import init_params as j_init_params

    jcfg = j_get_config(ARCH).replace(num_layers=layers)
    return jcfg, j_init_params(jcfg, jax.random.key(seed))


def run_jax(args) -> list:
    import jax
    import jax.numpy as jnp

    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.optim.adamw import AdamWConfig as JAdamWConfig
    from repro.train.trainer import init_train_state, make_train_step
    from torch_arch_parity import PCTX

    jcfg, params = _jax_params(args.layers, args.seed)
    step = jax.jit(make_train_step(jcfg, PCTX, JAdamWConfig(**_opt(args))))
    state = init_train_state(jcfg, params)
    src = JSyntheticLM(jcfg.vocab_size, args.seq, 1, seed=0)
    rows = []
    for i in range(args.steps):
        t0 = time.perf_counter()
        state, m = step(state, jax.tree.map(jnp.asarray, src.batch_at(i)))
        rows.append(_row(m, t0))
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return rows


def run_torch(args) -> list:
    import jax
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLM, device_batches
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.parallel import single_device_ctx
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import init_train_state, make_train_step

    cfg = get_config(ARCH).replace(num_layers=args.layers)
    _, jparams = _jax_params(args.layers, args.seed)
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                               device="cpu", masters=True)
    del jparams
    state = init_train_state(cfg, params)
    step = make_train_step(cfg, single_device_ctx(),
                           AdamWConfig(**_opt(args)))
    batches = device_batches(SyntheticLM(cfg.vocab_size, args.seq, 1, seed=0),
                             0, "cpu")
    rows = []
    for _ in range(args.steps):
        t0 = time.perf_counter()
        state, m = step(state, next(batches))
        rows.append(_row(m, t0))
        print(json.dumps(rows[-1]), file=sys.stderr, flush=True)
    return rows


def _opt(args) -> dict:
    return dict(lr=args.lr, total_steps=args.steps,
                warmup_steps=max(args.steps // 20, 5))


def _row(m, t0) -> dict:
    return dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                lr=float(m["lr"]), seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pkg", choices=("both", "jax", "torch"), default="both")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path)
    args = ap.parse_args(argv)
    if args.pkg != "both":
        rows = (run_jax if args.pkg == "jax" else run_torch)(args)
        print(json.dumps(rows))
        return 0
    here = Path(__file__).resolve()
    runs = {}
    for pkg in ("jax", "torch"):
        proc = subprocess.run(
            [sys.executable, str(here), "--pkg", pkg,
             *(f"--{k}={getattr(args, k)}"
               for k in ("layers", "seq", "steps", "lr", "seed"))],
            stdout=subprocess.PIPE, text=True, check=True,
            env={**os.environ, "PYTHONPATH": os.pathsep.join(
                [str(here.parents[1] / "src"), str(here.parent)])})
        runs[pkg] = json.loads(proc.stdout.strip().splitlines()[-1])
    rel = {k: max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                  for a, b in zip(runs["torch"], runs["jax"]))
           for k in ("loss", "grad_norm", "lr")}
    out = dict(arch=ARCH, layers=args.layers, seq=args.seq, batch=1,
               steps=args.steps, opt=_opt(args), seed=args.seed,
               max_rel_diff=rel,
               **{f"{pkg}_{k}": [r[k] for r in rows] for pkg, rows in
                  runs.items() for k in ("loss", "grad_norm", "lr")})
    line = json.dumps(out)
    print(line)
    if args.out:
        args.out.write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

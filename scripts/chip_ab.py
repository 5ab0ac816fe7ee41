#!/usr/bin/env python3
"""Run chip_smoke.py phases of two checkouts in turns on one card.

    python3 scripts/chip_ab.py --parent DIR [--turns PCCP] [--out FILE]
                               PHASE [PHASE ...]

Compares two versions of the port within one call on one card, as the
measurements in PERF.md ask: DIR is another checkout of the repository
(unpacked from ``git archive``, say, into a directory that .gitignore
lists), "C" the checkout this script lies in.  For each letter of
`--turns` (default PCCP: parent, change, change, parent) each PHASE runs
in a fresh process from that checkout's own chip_smoke.py, which builds
that checkout's kernels into its own build/.  A PHASE is a chip_smoke.py
phase by the name it prints: ``mamba_scan_bwd`` calls
``phase_mamba_scan_bwd()``, ``train_full`` ``phase_train_full(root)``
with the checkout's root, ``opera_dp_full`` with a train_full run that
has no losses, and a name of ``ARCH_TRAIN_RUNS``
(``train_full_falcon_mamba``) runs ``phase_train_arch_full`` with its
spec.  PHASEs joined by "+" (``opera_dp_full+train_full_rgemma``) run
in order in one process, as chip_smoke.py runs its phases, to show what
an earlier phase leaves to a later one.  Each phase's JSON line goes to
stdout and to FILE (default
chiprun_out/chip_ab.jsonl) with the turn and the checkout added; the card's
name and power limit are printed first and last.  Exits non-zero when a
phase fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# run inside a checkout: call the phase, print its line last
CHILD = """
import inspect, json, sys
from pathlib import Path
import torch
import chip_smoke as c
torch.backends.cuda.matmul.allow_tf32 = False
runs = {spec[0]: spec for spec in getattr(c, "ARCH_TRAIN_RUNS", [])}
# a phase's arguments: the checkout's root, or train_full's run (whose
# losses opera_dp_full prints beside its own: none here)
given = {"root": Path.cwd(), "train_full": {"losses": []}}
for name in sys.argv[1].split("+"):
    if name in runs:
        out = c.phase_train_arch_full(*runs[name])
    else:
        fn = getattr(c, "phase_" + name)
        out = fn(*(given[p] for p in inspect.signature(fn).parameters))
    print("CHIP_AB " + json.dumps(out), flush=True)
"""


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--turns", default="PCCP")
    ap.add_argument("--out", type=Path,
                    default=ROOT / "chiprun_out" / "chip_ab.jsonl")
    ap.add_argument("phases", nargs="+")
    args = ap.parse_args(argv)
    trees = {"P": args.parent.resolve(), "C": ROOT}
    if set(args.turns) - set(trees):
        ap.error("--turns takes P and C")
    for tree in trees.values():
        if not (tree / "chip_smoke.py").exists():
            ap.error(f"no chip_smoke.py in {tree}")
    args.out.parent.mkdir(parents=True, exist_ok=True)
    print(card(), flush=True)
    failed = 0
    with args.out.open("a") as log:
        for turn, letter in enumerate(args.turns):
            tree = trees[letter]
            for phase in args.phases:
                proc = subprocess.run(
                    [sys.executable, "-c", CHILD, phase], cwd=tree,
                    capture_output=True, text=True,
                    env={**os.environ, "PYTHONPATH": str(tree / "src")})
                lines = [ln for ln in proc.stdout.splitlines()
                         if ln.startswith("CHIP_AB ")]
                if proc.returncode or not lines:
                    failed += 1
                    print(f"turn {turn} {letter} {phase} failed "
                          f"({proc.returncode}):\n{proc.stderr[-4000:]}",
                          flush=True)
                    continue
                for k, line in enumerate(lines):
                    row = dict(turn=turn, tree="parent" if letter == "P"
                               else "change", chain=phase, link=k,
                               **json.loads(line[8:]))
                    log.write(json.dumps(row) + "\n")
                    print(json.dumps(row), flush=True)
    print(card(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

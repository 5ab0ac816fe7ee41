#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Imports nothing of JAX or of the JAX package.  Builds the Hopper kernels
from the sources in this checkout, then runs, each phase printing one
JSON line and any failure raising:

1. kernel: the `rotor_slice` CUDA kernel against its plain PyTorch
   version on the card, vlb on and off, at k8-n16-g1, k12-n108-g1,
   k12-n108-g2 and k64-n1024-g4 (B = 16, and B = 1 at k12-n108-g1 as
   Fig. 8 runs it; random non-negative state with a zero diagonal); state atol 1e-5, totals rtol 1e-5.  Times the
   kernel and the plain version with CUDA events beside the byte bound,
   and the kernel's own device time from the profiler's trace.
2. fig08: Fig. 8 (OPERA_648, 100 KB all-to-all shuffle, no VLB, 40
   cycles) through `simulate_rotor_bulk_torch` with the dense and the
   sparse engine, on the JAX package's seed-0 topology stored in
   src/repro_torch/data/, held to the JAX package's stored stats at
   rtol 1e-4.
3. sweep: `sweep.run_design` at k64-n1024-g4, the largest Appendix-B
   point (lifted topology, sparse engine), over 4 workloads x 2 loads x
   2 seeds = 16 scenarios.  Every row must drain and conserve bytes, and
   the kernel must have launched once per slice.
4. crossover: per-slice time of the dense and the sparse engine across
   the Appendix-B grid at B = 16.

Then the kernel table line, the card's name and power limit, and the
device line.  Exits non-zero, printing no result, without a CUDA card or
outside a checkout of the repository.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
SWEEP_CYCLES = 3   # every row drains within 2 cycles (512 slices)


def _emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def _cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def _device_ms(fn, names, reps: int = 10):
    """Device time per call of the kernels whose names contain one of
    `names`, from the profiler's CUDA trace: the card's own time, without
    the host's launch overhead.  None when the trace holds no such
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0.0)
             for e in prof.key_averages() if any(n in e.key for n in names))
    return us / reps / 1e3 if us > 0 else None


def _bound_ms(bsz: int, n: int, u: int) -> tuple:
    """Least time for one slice step: own and relay read once and written
    once, plus dst and the totals, over the memory rate; against the
    float32 operations at most u slots per element can need (the time of
    the operations stays below that of the bytes)."""
    nbytes = 16 * bsz * n * n + 4 * n * u + 8 * bsz
    ops = bsz * n * n * (6 + 2 * u)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _topology(dp):
    from repro_torch.core.topology import (
        build_lifted_opera_topology,
        build_opera_topology,
    )
    from repro_torch.netsim.sweep import LIFTED_TOPO_RACKS

    cfg = dp.to_config()
    build = (build_lifted_opera_topology if cfg.num_racks > LIFTED_TOPO_RACKS
             else build_opera_topology)
    return build(cfg.num_racks, cfg.u, seed=dp.topo_seed, groups=cfg.groups)


def phase_build() -> dict:
    from repro_torch.kernels import library_path
    from repro_torch.kernels.rotor_slice import kernel

    t0 = time.perf_counter()
    kernel.library()
    log = library_path("rotor_slice", [kernel.SOURCE]).with_suffix(".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "Used" in ln or "spill" in ln] if log.exists() else []
    return dict(phase="build", seconds=time.perf_counter() - t0, ptxas=ptxas)


def phase_kernel(cases) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.rotor_slice.kernel import rotor_slice_fwd
    from repro_torch.kernels.rotor_slice.ref import rotor_slice_ref

    rows = []
    for name, topo, bsz in cases:
        n, u = topo.num_racks, topo.num_switches
        dst = torch.as_tensor(topo.matching_index_tensor()[1], device="cuda")
        rng = np.random.default_rng(n)
        own = rng.uniform(0.0, 2.0, (bsz, n, n)).astype(np.float32)
        relay = rng.uniform(0.0, 1.0, (bsz, n, n)).astype(np.float32)
        for a in (own, relay):
            a[:, np.arange(n), np.arange(n)] = 0.0
        own = torch.from_numpy(own).cuda()
        relay = torch.from_numpy(relay).cuda()
        for vlb in (False, True):
            got = rotor_slice_fwd(own, relay, dst, vlb)
            ref = rotor_slice_ref(own, relay, dst, vlb)
            torch.cuda.synchronize()
            err = max(float((g - r).abs().max()) for g, r in zip(got[:2], ref[:2]))
            tot = max(float(((g - r).abs() / r.abs().clamp(min=1e-30)).max())
                      for g, r in zip(got[2:], ref[2:]) if float(r.abs().max()) > 0)
            _check(err <= 1e-5, f"{name} vlb={vlb} state err {err}")
            _check(tot <= 1e-5, f"{name} vlb={vlb} totals rel err {tot}")
            again = rotor_slice_fwd(own, relay, dst, vlb)
            _check(all(torch.equal(a, b) for a, b in zip(got, again)),
                   f"{name} vlb={vlb} not deterministic")
            big = n >= 512
            ms = _cuda_ms(lambda: rotor_slice_fwd(own, relay, dst, vlb),
                          reps=20 if big else 200)
            plain_ms = _cuda_ms(lambda: rotor_slice_ref(own, relay, dst, vlb),
                                reps=3 if big else 20, warmup=1)
            device_ms = _device_ms(lambda: rotor_slice_fwd(own, relay, dst, vlb),
                                   ("rotor_rows", "rotor_cols"))
            bound_ms, bound_by = _bound_ms(bsz, n, u)
            rows.append(dict(design=name, B=bsz, N=n, u=u, vlb=vlb,
                             max_abs_err=err, totals_rel_err=tot, ms=ms,
                             device_ms=device_ms, plain_ms=plain_ms,
                             bound_ms=bound_ms, bound_by=bound_by))
        del own, relay
        torch.cuda.empty_cache()
    return dict(phase="kernel", rows=rows)


def phase_fig08(root: Path) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs.opera_paper import OPERA_648
    from repro_torch.core.topology import topology_from_arrays
    from repro_torch.kernels import launch_counts
    from repro_torch.netsim.fluid_torch import simulate_rotor_bulk_torch
    from repro_torch.netsim.workloads import demand_all_to_all

    data = root / "src" / "repro_torch" / "data"
    topo = topology_from_arrays(
        108, 6, np.load(data / "fig08_k12_n108_g1_seed0.npy"), groups=1)
    want = json.loads((data / "fig08_expected.json").read_text())
    demand = demand_all_to_all(108, 6, 100e3)
    cycles = want["max_cycles"]
    out = dict(phase="fig08", expected={k: want[k] for k in (
        "fct_99_ms", "fct_mean_ms", "throughput_gbps", "bandwidth_tax")})
    for engine in ("dense", "sparse"):
        simulate_rotor_bulk_torch(OPERA_648, demand, vlb=False, max_cycles=1,
                                  topo=topo, engine=engine)
        torch.cuda.synchronize()
        launch_counts.clear()
        t0 = time.perf_counter()
        res = simulate_rotor_bulk_torch(
            OPERA_648, demand, vlb=False, max_cycles=cycles, topo=topo,
            engine=engine)
        wall = time.perf_counter() - t0
        launches = launch_counts["rotor_slice"]
        steps = cycles * topo.num_slices
        _check(res.slices_run == want["slices_run"],
               f"fig08 {engine} slices_run {res.slices_run}")
        for k in out["expected"]:
            got = getattr(res, k)
            _check(bool(np.isclose(got, want[k], rtol=1e-4,
                                   atol=1e-4 if k == "bandwidth_tax" else 0.0)),
                   f"fig08 {engine} {k} {got} != {want[k]}")
        _check(launches == (steps if engine == "sparse" else 0),
               f"fig08 {engine} launches {launches}")
        out[engine] = dict(fct_99_ms=res.fct_99_ms, fct_mean_ms=res.fct_mean_ms,
                           throughput_gbps=res.throughput_gbps,
                           bandwidth_tax=res.bandwidth_tax,
                           slices_run=res.slices_run, wall_s=wall,
                           ms_per_slice=wall / steps * 1e3,
                           rotor_slice_launches=launches)
    return out


def phase_sweep(topo) -> dict:
    import numpy as np
    import torch

    from repro_torch.core.schedule import slice_capacity_bytes
    from repro_torch.kernels import launch_counts
    from repro_torch.netsim import sweep
    from repro_torch.netsim.fluid_torch import _run_batch_sparse

    dp = sweep.DesignPoint(k=64, num_racks=1024, groups=4)
    spec = sweep.SweepSpec(designs=(dp,), workloads=sweep.WORKLOADS,
                           loads=(0.1, 0.3), seeds=(0, 1),
                           max_cycles=SWEEP_CYCLES, engine="sparse")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts.clear()
    t0 = time.perf_counter()
    rows, res = sweep.run_design(spec, dp)
    wall = time.perf_counter() - t0
    launches = launch_counts["rotor_slice"]
    peak = torch.cuda.max_memory_allocated()
    steps = SWEEP_CYCLES * topo.num_slices
    _check(res.batch_size == 16, f"batch {res.batch_size}")
    _check(launches == steps, f"launches {launches} != {steps}")
    fin = res.finished_frac[:, -1]
    _check(bool((fin >= 0.99999).all()), f"rows not drained: {fin.tolist()}")
    end = fin * res.total_bytes
    _check(bool(np.allclose(end + res.residual_bytes, res.total_bytes,
                            rtol=1e-5)), "bytes not conserved")
    _check(bool(np.isfinite(res.fct_99_ms).all()), "non-finite fct99")

    # the slice loop alone, on the same inputs already on the card
    cfg = dp.to_config()
    demands = np.stack([sweep.scenario_demand(w, cfg, load, seed)
                        for w in spec.workloads for load in spec.loads
                        for seed in spec.seeds])
    own0 = torch.as_tensor(demands / slice_capacity_bytes(cfg),
                           dtype=torch.float32, device="cuda")
    dst = torch.as_tensor(topo.matching_index_tensor(), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _run_batch_sparse(dst, own0, spec.vlb, SWEEP_CYCLES)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    return dict(
        phase="sweep", design=dp.name, scenarios=res.batch_size,
        max_cycles=SWEEP_CYCLES, slices=steps, run_design_wall_s=wall,
        slice_loop_s=engine_s, ms_per_slice=engine_s / steps * 1e3,
        rotor_slice_launches=launches, peak_bytes=peak,
        slices_run_max=int(res.slices_run.max()),
        finished_frac_min=float(fin.min()),
        fct_99_ms=[r["fct_99_ms"] for r in rows],
        bandwidth_tax=[r["bandwidth_tax"] for r in rows],
        workloads=[f'{r["workload"]}@{r["load"]}/s{r["seed"]}' for r in rows])


def phase_crossover(topos: dict) -> dict:
    import numpy as np
    import torch

    from repro_torch.netsim.fluid_torch import _run_batch, _run_batch_sparse

    bsz, steps = 16, 32
    rows = []
    for name, topo in topos.items():
        n = topo.num_racks
        rng = np.random.default_rng(0)
        own0 = torch.as_tensor(rng.uniform(0, 2, (bsz, n, n)),
                               dtype=torch.float32, device="cuda")
        dst = torch.as_tensor(topo.matching_index_tensor()[:steps], device="cuda")
        adj = torch.as_tensor(
            np.stack([topo.adjacency(t) for t in range(steps)]),
            dtype=torch.float32, device="cuda")
        row = dict(design=name, N=n, B=bsz)
        for engine, run, tensor in (("dense", _run_batch, adj),
                                    ("sparse", _run_batch_sparse, dst)):
            ms = _cuda_ms(lambda: run(tensor, own0, True, 1), reps=3, warmup=1)
            row[f"{engine}_ms_per_slice"] = ms / tensor.shape[0]
        rows.append(row)
        del own0, dst, adj
        torch.cuda.empty_cache()
    return dict(phase="crossover", vlb=True, rows=rows)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    from repro_torch.netsim.sweep import appendix_b_grid

    _emit(phase_build())
    t0 = time.perf_counter()
    topos = {dp.name: _topology(dp) for dp in appendix_b_grid()}
    _emit(dict(phase="topologies", seconds=time.perf_counter() - t0))

    # (design, batch): Fig. 8 runs k12-n108-g1 at B = 1, the sweep k64 at 16
    kern = phase_kernel([(k, topos[k], b) for k, b in (
        ("k8-n16-g1", 16), ("k12-n108-g1", 1), ("k12-n108-g1", 16),
        ("k12-n108-g2", 16), ("k64-n1024-g4", 16))])
    _emit(kern)
    _emit(phase_fig08(root))
    sweep = phase_sweep(topos["k64-n1024-g4"])
    _emit(sweep)
    _emit(phase_crossover(topos))

    main_row = next(r for r in kern["rows"]
                    if r["design"] == "k64-n1024-g4" and r["vlb"])
    _emit({"kernels": [dict(
        name="rotor_slice", route="cuda",
        source="src/repro_torch/kernels/rotor_slice/csrc/rotor_slice.cu",
        replaces="src/repro/kernels/rotor_slice/kernel.py:41",
        launches=sweep["rotor_slice_launches"],
        max_abs_err=max(r["max_abs_err"] for r in kern["rows"]),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=None)]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip(), flush=True)
    _emit({"ok": True, "device": {"platform": "gpu",
                                  "kind": torch.cuda.get_device_name(0),
                                  "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
5. flash_attention: the CUDA kernel against its plain version, f32 and
   bf16, at the sweep of tests/test_kernels.py:21-33 and at the
   qwen3-moe prefill shapes (B 1, Hq 32, Hkv 4, hd 128, causal, S 128 /
   512 / 2048), at f32 2e-5 and bf16 2e-2; times the kernel (events and
   profiler), the plain version and, as a yardstick never on the path,
   `F.scaled_dot_product_attention(is_causal=True, enable_gqa=True)`.
6. moe_gmm: the same at tests/test_kernels.py:89-92 and at E 128, D 2048,
   F 768 with C 4 (a 4-slot decode step) and C 40 (a 512-token prefill);
   no single PyTorch call computes the fused gated FFN, so no library
   time.
7. serve_golden: reduced qwen3-moe in f32 with the JAX package's weights
   (src/repro_torch/data/): prefill logits at atol/rtol 1e-4 and the
   greedy tokens of a 4-request, 2-slot `ServeEngine` run equal to the
   JAX engine's, through both kernels.
8. serve_full: qwen3-moe-30b-a3b at full width and depth (48 layers) in
   bf16, seed-0 random weights on the card: `ServeEngine(slots=4,
   max_seq=1024)` serves 8 requests (prompts of 128-512 tokens, 16 new
   tokens each); every launch of both kernels is counted, then a
   profiled window of decode ticks shows where a tick's time goes.

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
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense
ARCH = "qwen3-moe-30b-a3b"
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
    """One nvcc per kernel source, all started together."""
    from repro_torch.kernels import build_libraries, library_path
    from repro_torch.kernels.flash_attention import kernel as flash
    from repro_torch.kernels.moe_gmm import kernel as gmm
    from repro_torch.kernels.rotor_slice import kernel as rotor

    specs = [("rotor_slice", [rotor.SOURCE]), (flash.NAME, [flash.SOURCE]),
             (gmm.NAME, [gmm.SOURCE])]
    t0 = time.perf_counter()
    build_libraries(specs)
    for mod in (rotor, flash, gmm):
        mod.library()
    out = dict(phase="build", seconds=time.perf_counter() - t0)
    for name, sources in specs:
        log = library_path(name, sources).with_suffix(".log")
        out[f"ptxas_{name}"] = [
            ln.strip() for ln in log.read_text().splitlines()
            if "Used" in ln or "spill" in ln] if log.exists() else []
    return out


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


# ---------------- model kernels and serving (qwen3-moe-30b-a3b) -----------

FLASH_SWEEP = [  # B, Hq, Hkv, Sq, Sk, hd, causal, window (test_kernels.py)
    (1, 2, 2, 64, 64, 32, True, 0), (2, 4, 2, 64, 64, 64, True, 0),
    (1, 8, 1, 32, 32, 32, True, 0), (1, 2, 2, 64, 64, 32, False, 0),
    (1, 2, 1, 64, 64, 32, True, 24), (1, 2, 2, 32, 96, 32, True, 0),
    (1, 3, 1, 48, 48, 16, True, 0),
]
GMM_SWEEP = [(2, 16, 16, 32), (4, 8, 32, 64), (3, 12, 8, 24)]  # E, C, D, F


def _tol(dtype) -> float:
    """tests/test_kernels.py:15-18: atol = rtol."""
    import torch

    return 2e-2 if dtype == torch.bfloat16 else 2e-5


def _held(got, want, dtype, what: str) -> float:
    """Max abs difference; fails beyond atol + rtol * |want|."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    tol = _tol(dtype)
    worst = float((err - tol * w.abs()).max())
    _check(worst <= tol, f"{what}: |diff| {float(err.max())} beyond "
                         f"{tol} + {tol} |want|")
    return float(err.max())


def _randn(shape, gen, dtype, scale=1.0):
    import torch

    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return (x * scale).to(dtype)


def _ops_rate(dtype) -> float:
    import torch

    return BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S


def _bound(nbytes: float, ops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / _ops_rate(dtype) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _dname(dtype) -> str:
    return str(dtype).replace("torch.", "")


def phase_flash_attention() -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        attention_mask,
        flash_attention_ref,
    )

    gen = torch.Generator(device="cuda").manual_seed(0)
    sweep_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for B, Hq, Hkv, Sq, Sk, hd, causal, window in FLASH_SWEEP:
            q = _randn((B, Hq, Sq, hd), gen, dtype)
            k = _randn((B, Hkv, Sk, hd), gen, dtype)
            v = _randn((B, Hkv, Sk, hd), gen, dtype)
            got = flash_attention(q, k, v, causal=causal, window=window)
            want = flash_attention_ref(q, k, v, causal, window)
            sweep_err = max(sweep_err, _held(
                got, want, dtype, f"flash sweep {(B, Hq, Hkv, Sq, Sk, hd)}"))
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        for S in (128, 512, 2048):
            B, Hq, Hkv, hd = 1, 32, 4, 128
            q = _randn((B, Hq, S, hd), gen, dtype)
            k = _randn((B, Hkv, S, hd), gen, dtype)
            v = _randn((B, Hkv, S, hd), gen, dtype)
            qf, kf, vf = (t.reshape(-1, S, hd) for t in (q, k, v))
            got = flash_attention(q, k, v, causal=True)
            want = flash_attention_ref(q, k, v, True, 0)
            err = _held(got, want, dtype, f"flash qwen3 S={S} {dtype}")
            again = flash_attention(q, k, v, causal=True)
            _check(torch.equal(got, again), f"flash S={S} not deterministic")
            reps = 20 if S <= 512 else 5
            ms = _cuda_ms(lambda: flash_attention_fwd(qf, kf, vf, Hq // Hkv,
                                                      True, 0), reps=reps)
            device_ms = _device_ms(
                lambda: flash_attention_fwd(qf, kf, vf, Hq // Hkv, True, 0),
                ("flash_fwd",), reps=reps)
            plain_ms = _cuda_ms(lambda: flash_attention_ref(q, k, v, True, 0),
                                reps=3, warmup=1)
            library_ms = _cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), reps=reps)
            live = int(attention_mask(S, S, True, 0).sum())
            es = q.element_size()
            nbytes = es * (2 * B * Hq * S * hd + 2 * B * Hkv * S * hd)
            ops = 4 * B * Hq * hd * live
            bound_ms, bound_by = _bound(nbytes, ops, dtype)
            rows.append(dict(dtype=_dname(dtype), B=B, Hq=Hq, Hkv=Hkv, S=S,
                             hd=hd, causal=True, max_abs_err=err, ms=ms,
                             device_ms=device_ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms,
                             bound_by=bound_by,
                             tflops=ops / (ms * 1e-3) / 1e12))
            del q, k, v, qf, kf, vf, got, want, again
            torch.cuda.empty_cache()
    return dict(phase="flash_attention", sweep_cases=2 * len(FLASH_SWEEP),
                sweep_max_abs_err=sweep_err, rows=rows)


def phase_moe_gmm() -> dict:
    import torch

    from repro_torch.kernels.moe_gmm.kernel import moe_gmm_fwd
    from repro_torch.kernels.moe_gmm.ops import moe_gmm
    from repro_torch.kernels.moe_gmm.ref import moe_gmm_ref

    gen = torch.Generator(device="cuda").manual_seed(1)
    sweep_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for E, C, D, Fd in GMM_SWEEP:
            h = _randn((E, C, D), gen, dtype)
            w = [_randn(s, gen, dtype, 0.1)
                 for s in ((E, D, Fd), (E, D, Fd), (E, Fd, D))]
            sweep_err = max(sweep_err, _held(
                moe_gmm(h, *w), moe_gmm_ref(h, *w), dtype,
                f"moe_gmm sweep {(E, C, D, Fd)}"))
    rows = []
    E, D, Fd = 128, 2048, 768
    for dtype in (torch.float32, torch.bfloat16):
        # fan-in scaled weights, as the model draws them (dense_init)
        w = [_randn((E, D, Fd), gen, dtype, D**-0.5),
             _randn((E, D, Fd), gen, dtype, D**-0.5),
             _randn((E, Fd, D), gen, dtype, Fd**-0.5)]
        for C in (4, 40):
            h = _randn((E, C, D), gen, dtype)
            got = moe_gmm(h, *w)
            err = _held(got, moe_gmm_ref(h, *w), dtype,
                        f"moe_gmm qwen3 C={C} {dtype}")
            _check(torch.equal(got, moe_gmm(h, *w)),
                   f"moe_gmm C={C} not deterministic")
            ms = _cuda_ms(lambda: moe_gmm_fwd(h, *w), reps=10)
            device_ms = _device_ms(lambda: moe_gmm_fwd(h, *w), ("moe_gmm",),
                                   reps=10)
            plain_ms = _cuda_ms(lambda: moe_gmm_ref(h, *w), reps=3, warmup=1)
            es = h.element_size()
            nbytes = es * (2 * E * C * D + 3 * E * D * Fd)
            ops = 6 * E * C * D * Fd
            bound_ms, bound_by = _bound(nbytes, ops, dtype)
            rows.append(dict(dtype=_dname(dtype), E=E, C=C, D=D, F=Fd,
                             max_abs_err=err, ms=ms, device_ms=device_ms,
                             plain_ms=plain_ms, library_ms=None,
                             bound_ms=bound_ms, bound_by=bound_by,
                             gbytes_per_s=nbytes / (ms * 1e-3) / 1e9))
        del w, h, got
        torch.cuda.empty_cache()
    return dict(phase="moe_gmm", sweep_cases=2 * len(GMM_SWEEP),
                sweep_max_abs_err=sweep_err, rows=rows)


def phase_serve_golden(root: Path) -> dict:
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config, reduced_config
    from repro_torch.kernels import launch_counts
    from repro_torch.models.convert import params_from_numpy, tree_from_flat
    from repro_torch.models.model import forward_prefill
    from repro_torch.serve.engine import Request, ServeEngine

    stored = dict(np.load(root / "src" / "repro_torch" / "data"
                          / "qwen3_moe_reduced_golden.npz"))
    cfg = reduced_config(get_config(ARCH)).replace(compute_dtype="float32")
    params = params_from_numpy(cfg, tree_from_flat(
        {k[len("param/"):]: v for k, v in stored.items()
         if k.startswith("param/")}), device="cuda")
    n = sum(1 for k in stored if k.startswith("prompt/"))
    prompts = [stored[f"prompt/{i}"] for i in range(n)]
    logit_err = 0.0
    with torch.no_grad():
        for i, prompt in enumerate(prompts):
            tokens = torch.as_tensor(prompt[None].astype(np.int64),
                                     device="cuda")
            logits, _ = forward_prefill(params, {"tokens": tokens}, cfg)
            want = torch.as_tensor(stored[f"logits/{i}"], device="cuda")
            err = (logits[0] - want).abs()
            _check(bool((err <= 1e-4 + 1e-4 * want.abs()).all()),
                   f"golden prefill logits {i}: {float(err.max())}")
            logit_err = max(logit_err, float(err.max()))
    eng = ServeEngine(cfg, params, slots=2, max_seq=64, device="cuda")
    for rid, prompt in enumerate(prompts):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=8))
    launch_counts.clear()
    done = eng.run_to_completion(max_ticks=200)
    flash, gmm = launch_counts["flash_attention"], launch_counts["moe_gmm"]
    _check(len(done) == n, f"golden finished {len(done)} of {n}")
    for r in done:
        want = stored[f"tokens/{r.rid}"].tolist()
        _check(r.out_tokens == want,
               f"golden tokens {r.rid}: {r.out_tokens} != {want}")
    L = cfg.num_layers
    _check(flash == L * eng.prefills, f"golden flash launches {flash}")
    _check(gmm == L * (eng.prefills + eng.ticks), f"golden moe launches {gmm}")
    return dict(phase="serve_golden", requests=n, prefills=eng.prefills,
                ticks=eng.ticks, tokens_equal=True,
                prefill_logits_max_abs_err=logit_err,
                flash_attention_launches=flash, moe_gmm_launches=gmm)


def _decode_breakdown(eng, ticks: int) -> dict:
    """Device time by kernel over `ticks` decode ticks (all slots live)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    kern, host = [], []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA:
            us = getattr(e, "device_time_total", 0.0)
            if us > 0:
                kern.append((e.key, us / ticks / 1e3, e.count // ticks))
        else:
            host.append((e.key, e.self_cpu_time_total / ticks / 1e3,
                         e.count / ticks))
    kern.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    device_ms = sum(ms for _, ms, _ in kern)
    waits = {k: c for k, _, c in host
             if "Synchronize" in k or "Memcpy" in k or k == "aten::item"}
    # the profiler slows the host, so wall_ms is no tick time
    return dict(ticks=ticks, profiled_wall_ms_per_tick=wall_ms,
                device_ms_per_tick=device_ms,
                host_ops_per_tick=sum(c for k, _, c in host
                                      if k.startswith("aten::")),
                waits_per_tick=waits,
                top=[dict(kernel=k[:90], ms_per_tick=ms, launches_per_tick=c)
                     for k, ms, c in kern[:14]],
                top_host=[dict(op=k[:60], self_ms_per_tick=ms, calls_per_tick=c)
                          for k, ms, c in host[:12]])


def phase_serve_full() -> dict:
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import launch_counts
    from repro_torch.models.model import count_params, init_params
    from repro_torch.serve.engine import Request, ServeEngine

    cfg = get_config(ARCH)            # full width, full depth, bf16 compute
    slots, max_seq, max_new, n_req = 4, 1024, 16, 8
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in params.parameters())
    _check(n_params == count_params(cfg), f"params {n_params}")
    param_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    eng = ServeEngine(cfg, params, slots=slots, max_seq=max_seq, device="cuda")
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 513, n_req)
    for rid, L in enumerate(lens):
        eng.submit(Request(rid=rid, max_new_tokens=max_new, prompt=rng.integers(
            0, cfg.vocab_size, int(L)).astype(np.int32)))
    launch_counts.clear()
    t0 = time.perf_counter()
    done = eng.run_to_completion(max_ticks=200)
    wall = time.perf_counter() - t0
    flash, gmm = launch_counts["flash_attention"], launch_counts["moe_gmm"]
    peak = torch.cuda.max_memory_allocated()
    L = cfg.num_layers
    _check(len(done) == n_req, f"finished {len(done)} of {n_req}")
    _check(all(len(r.out_tokens) == max_new for r in done), "short outputs")
    _check(all(0 <= t < cfg.vocab_size for r in done for t in r.out_tokens),
           "token out of range")
    _check(flash == L * eng.prefills == L * n_req, f"flash launches {flash}")
    _check(gmm == L * (eng.prefills + eng.ticks), f"moe_gmm launches {gmm}")
    with torch.no_grad():   # logits of the last request's prefill
        from repro_torch.models.model import forward_prefill

        tokens = torch.as_tensor(done[-1].prompt[None].astype(np.int64),
                                 device="cuda")
        logits, _ = forward_prefill(params, {"tokens": tokens}, cfg)
    _check(bool(torch.isfinite(logits).all()), "non-finite logits")
    # a decode tick reads every weight but the embedding (all 128 experts
    # hold capacity rows at C = 4), 4 embedding rows and the whole cache
    embed = params["embed"]
    cache_bytes = sum(t.numel() * t.element_size()
                      for c in eng.cache for t in c.values())
    tick_bytes = (param_bytes - embed.numel() * embed.element_size()
                  + slots * embed.shape[1] * embed.element_size() + cache_bytes)
    out = dict(
        phase="serve_full", arch=cfg.name, layers=L, d_model=cfg.d_model,
        params=n_params, param_bytes=param_bytes, init_s=init_s,
        requests=n_req, prompt_lens=lens.tolist(), new_tokens=max_new,
        slots=slots, max_seq=max_seq, wall_s=wall, prefills=eng.prefills,
        prefill_tokens=eng.prefill_tokens, prefill_s=eng.prefill_s,
        prefill_tokens_per_s=eng.prefill_tokens / eng.prefill_s,
        ticks=eng.ticks, decode_ms_per_tick=eng.decode_s / eng.ticks * 1e3,
        decode_bound_ms=tick_bytes / HBM_BYTES_PER_S * 1e3,
        decode_tick_bytes=tick_bytes, peak_bytes=peak,
        flash_attention_launches=flash, moe_gmm_launches=gmm)
    # where a tick goes: 4 fresh requests, then a profiled window
    for rid in range(slots):
        eng.submit(Request(rid=100 + rid, max_new_tokens=64, prompt=rng.integers(
            0, cfg.vocab_size, 256).astype(np.int32)))
    eng.step()
    out["decode_breakdown"] = bd = _decode_breakdown(eng, ticks=4)
    # the unprofiled ticks above against the profiled device time
    out["idle_share"] = 1.0 - bd["device_ms_per_tick"] / out["decode_ms_per_tick"]
    return out


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

    # plain versions and f32 paths in full f32, as the JAX package's dots
    torch.backends.cuda.matmul.allow_tf32 = False

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
    del topos
    flash = phase_flash_attention()
    _emit(flash)
    gmm = phase_moe_gmm()
    _emit(gmm)
    _emit(phase_serve_golden(root))
    serve = phase_serve_full()
    _emit(serve)

    main_row = next(r for r in kern["rows"]
                    if r["design"] == "k64-n1024-g4" and r["vlb"])
    # the serving path's shapes: bf16, a 512-token prefill, a decode tick
    flash_row = next(r for r in flash["rows"]
                     if r["dtype"] == "bfloat16" and r["S"] == 512)
    gmm_row = next(r for r in gmm["rows"]
                   if r["dtype"] == "bfloat16" and r["C"] == 4)
    kernels = [dict(
        name="rotor_slice", route="cuda",
        source="src/repro_torch/kernels/rotor_slice/csrc/rotor_slice.cu",
        replaces="src/repro/kernels/rotor_slice/kernel.py:41",
        launches=sweep["rotor_slice_launches"],
        max_abs_err=max(r["max_abs_err"] for r in kern["rows"]),
        ms=main_row["ms"], plain_ms=main_row["plain_ms"],
        bound_ms=main_row["bound_ms"], bound_by=main_row["bound_by"],
        library_ms=None)]
    for name, row, phase, replaces in (
            ("flash_attention", flash_row, flash,
             "src/repro/kernels/flash_attention/kernel.py:22"),
            ("moe_gmm", gmm_row, gmm, "src/repro/kernels/moe_gmm/kernel.py:19")):
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/{name}/csrc/{name}.cu",
            replaces=replaces, launches=serve[f"{name}_launches"],
            max_abs_err=max([phase["sweep_max_abs_err"]]
                            + [r["max_abs_err"] for r in phase["rows"]]),
            ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"]))
    _emit({"kernels": kernels})
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

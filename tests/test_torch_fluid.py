"""PyTorch fluid engine against the JAX reference, on the CPU.

The same inputs (numpy, from a seed) go through `repro.netsim.fluid_jax`
and `repro_torch.netsim.fluid_torch`; the topology is built once by the
JAX package and carried across with `topology_from_arrays`, since the
port's own builder may draw another topology from the same seed.
Tolerances are the reference's own (tests/test_netsim_jax.py:59-67,
tests/test_rotor_slice.py): stats rtol 1e-4, trajectory drift 1e-5.

Also checks the stored Fig. 8 topology and stats that `chip_smoke.py`
holds the card to: regenerate them from the JAX package with
``JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_fluid.py``.
"""
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.opera_paper import OPERA_648
from repro.core.schedule import cycle_timing, slice_capacity_bytes
from repro.core.topology import build_opera_topology
from repro.netsim import fluid_jax
from repro.netsim import sweep as jsweep
from repro_torch.configs.opera_paper import OPERA_648 as T_OPERA_648
from repro_torch.core.topology import topology_from_arrays
from repro_torch.netsim import fluid_torch
from repro_torch.netsim import sweep as tsweep
from repro_torch.netsim.workloads import demand_all_to_all

DATA = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "data"
FIG08_TOPO = DATA / "fig08_k12_n108_g1_seed0.npy"
FIG08_STATS = DATA / "fig08_expected.json"
FIG08_CYCLES = 40
STATS = ("fct_99_ms", "fct_mean_ms", "throughput_gbps", "bandwidth_tax")


def _carry(topo):
    """The JAX package's topology as the port's."""
    return topology_from_arrays(topo.num_racks, topo.num_switches,
                                np.asarray(topo.switch_matchings), topo.groups)


def _drift(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1.0)))


def _assert_stats_close(a, b):
    """`a` the JAX RotorBatchResult, `b` the port's: test_netsim_jax's
    tolerances, row by row."""
    np.testing.assert_array_equal(a.slices_run, b.slices_run)
    for name in ("fct_mean_ms", "throughput_gbps", "goodput_bytes",
                 "wire_bytes"):
        np.testing.assert_allclose(getattr(b, name), getattr(a, name),
                                   rtol=1e-4, err_msg=name)
    fin = np.isfinite(a.fct_99_ms)
    np.testing.assert_array_equal(fin, np.isfinite(b.fct_99_ms))
    np.testing.assert_allclose(b.fct_99_ms[fin], a.fct_99_ms[fin], rtol=1e-4)
    np.testing.assert_allclose(b.bandwidth_tax, a.bandwidth_tax, atol=1e-4)
    np.testing.assert_allclose(b.finished_frac, a.finished_frac, atol=1e-5)
    np.testing.assert_allclose(b.residual_bytes, a.residual_bytes,
                               rtol=1e-4, atol=1e-3 * a.total_bytes.max())


class TestDrivers:
    """Raw batch drivers on an overloaded skew batch (the batch of
    tests/test_rotor_slice.py::TestEngineParity): trajectories and
    residuals slice by slice."""

    @pytest.fixture(scope="class")
    def batch(self):
        dp = jsweep.DesignPoint(k=8, num_racks=16, groups=1)
        cfg = dp.to_config()
        topo = build_opera_topology(cfg.num_racks, cfg.u, seed=0)
        cap = slice_capacity_bytes(cfg, cycle_timing(cfg))
        dem = np.stack([jsweep.scenario_demand("skew", cfg, 2.5, s)
                        for s in range(3)])
        return topo, (dem / cap).astype(np.float32)

    @pytest.mark.parametrize("vlb", [False, True])
    @pytest.mark.parametrize("engine", ["dense", "sparse"])
    def test_trajectories_match_jax(self, batch, engine, vlb):
        topo, own0 = batch
        if engine == "dense":
            tensor = topo.matching_tensor()
            ref = fluid_jax._run_batch(jnp.asarray(tensor), jnp.asarray(own0),
                                       vlb, 4)
            got = fluid_torch._run_batch(torch.as_tensor(tensor),
                                         torch.as_tensor(own0), vlb, 4)
        else:
            tensor = topo.matching_index_tensor()
            ref = fluid_jax._run_batch_sparse(
                jnp.asarray(tensor), jnp.asarray(own0), vlb, 4)
            got = fluid_torch._run_batch_sparse(
                torch.as_tensor(tensor), torch.as_tensor(own0), vlb, 4)
        assert np.asarray(ref[2]).max() > 0, "skew batch must not drain"
        for r, g in zip(ref, got):
            assert g.shape == tuple(r.shape)
            assert _drift(r, g.numpy()) < 1e-5


BATCH_DESIGNS = [(8, 16, 1, 20), (8, 16, 2, 20), (12, 108, 1, 4)]


class TestBatchAPI:
    @pytest.mark.parametrize("engine", ["dense", "sparse"])
    @pytest.mark.parametrize("k,n,g,cycles", BATCH_DESIGNS,
                             ids=[f"k{k}-n{n}-g{g}" for k, n, g, _ in BATCH_DESIGNS])
    def test_stats_match_jax(self, k, n, g, cycles, engine):
        dp = jsweep.DesignPoint(k=k, num_racks=n, groups=g)
        cfg = dp.to_config()
        topo = build_opera_topology(n, cfg.u, seed=0, groups=g)
        dem = np.stack([
            jsweep.scenario_demand(w, cfg, load, 1)
            for w, load in (("shuffle", 0.3), ("permutation", 0.3),
                            ("skew", 0.1), ("hotrack", 0.1))])
        ref = fluid_jax.simulate_rotor_bulk_batch(
            cfg, dem, vlb=True, max_cycles=cycles, topo=topo, engine=engine)
        got = fluid_torch.simulate_rotor_bulk_batch(
            tsweep.DesignPoint(k=k, num_racks=n, groups=g).to_config(), dem,
            vlb=True, max_cycles=cycles, topo=_carry(topo), engine=engine,
            device="cpu")
        _assert_stats_close(ref, got)

    def test_run_design_matches_jax(self):
        """At k8-n16 seed 0 the greedy draw never needs the exact
        fallback, so both packages build the same topology and the whole
        sweep row set can be compared."""
        kw = dict(workloads=("shuffle", "permutation", "skew", "hotrack"),
                  loads=(0.1, 0.3), seeds=(0, 1), max_cycles=30)
        jrows, jres = jsweep.run_design(
            jsweep.SweepSpec(designs=(), **kw),
            jsweep.DesignPoint(k=8, num_racks=16))
        trows, tres = tsweep.run_design(
            tsweep.SweepSpec(designs=(), **kw),
            tsweep.DesignPoint(k=8, num_racks=16), device="cpu")
        _assert_stats_close(jres, tres)
        assert [r["workload"] for r in trows] == [r["workload"] for r in jrows]
        np.testing.assert_allclose(
            [r["throughput_frac"] for r in trows],
            [r["throughput_frac"] for r in jrows], rtol=1e-4)
        end = tres.finished_frac[:, -1] * tres.total_bytes
        np.testing.assert_allclose(end + tres.residual_bytes,
                                   tres.total_bytes, rtol=1e-5)
        summary = tsweep.summarize(trows)
        assert len(summary) == 8 and all(s["n"] == 2 for s in summary)

    def test_single_scenario_api(self):
        dp = jsweep.DesignPoint(k=8, num_racks=16)
        topo = build_opera_topology(16, 4, seed=0)
        d = jsweep.scenario_demand("permutation", dp.to_config(), 0.5, 3)
        ref = fluid_jax.simulate_rotor_bulk_jax(
            dp.to_config(), d, max_cycles=20, topo=topo)
        got = fluid_torch.simulate_rotor_bulk_torch(
            tsweep.DesignPoint(k=8, num_racks=16).to_config(), d,
            max_cycles=20, topo=_carry(topo), device="cpu")
        assert got.slices_run == ref.slices_run
        assert np.isclose(got.fct_99_ms, ref.fct_99_ms, rtol=1e-4)
        assert np.isclose(got.bandwidth_tax, ref.bandwidth_tax, atol=1e-4)


class TestDispatch:
    def test_auto_engine_threshold(self):
        assert fluid_torch.resolve_engine("auto", 108) == "dense"
        assert fluid_torch.resolve_engine("auto", 1024) == "sparse"
        with pytest.raises(ValueError):
            fluid_torch.resolve_engine("tiled", 16)

    def test_default_device_is_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is usable")
        cfg = tsweep.DesignPoint(k=8, num_racks=16).to_config()
        with pytest.raises(RuntimeError, match="CUDA"):
            fluid_torch.simulate_rotor_bulk_batch(cfg, np.ones((16, 16)))


# ---------------------------------------------------------------------------
# Fig. 8 data that chip_smoke.py holds the card to
# ---------------------------------------------------------------------------


def fig08_reference():
    """The JAX package's seed-0 k12-n108-g1 topology and its Fig. 8 run
    (100 KB all-to-all shuffle, no VLB, 40 cycles), as stored."""
    topo = build_opera_topology(108, 6, seed=0, groups=1)
    demand = demand_all_to_all(108, 6, 100e3)
    res = fluid_jax.simulate_rotor_bulk_jax(
        OPERA_648, demand, vlb=False, max_cycles=FIG08_CYCLES, topo=topo)
    stats = dict(
        design="k12-n108-g1", topo_seed=0, workload="all_to_all 100e3 B",
        vlb=False, max_cycles=FIG08_CYCLES, slices_run=res.slices_run,
        **{k: float(getattr(res, k)) for k in STATS})
    return np.asarray(topo.switch_matchings).astype(np.int16), stats


class TestFig08Data:
    @pytest.fixture(scope="class")
    def stored(self):
        return np.load(FIG08_TOPO), json.loads(FIG08_STATS.read_text())

    def test_stored_data_is_current(self, stored):
        topo, stats = stored
        want_topo, want_stats = fig08_reference()
        np.testing.assert_array_equal(topo, want_topo)
        assert stats["slices_run"] == want_stats["slices_run"]
        for k in STATS:
            assert np.isclose(stats[k], want_stats[k], rtol=1e-6, atol=1e-9), k

    @pytest.mark.parametrize("engine", ["dense", "sparse"])
    def test_port_reproduces_fig08_on_cpu(self, stored, engine):
        """What chip_smoke.py checks on the card, on the CPU path."""
        arr, stats = stored
        topo = topology_from_arrays(108, 6, arr, groups=1)
        res = fluid_torch.simulate_rotor_bulk_torch(
            T_OPERA_648, demand_all_to_all(108, 6, 100e3), vlb=False,
            max_cycles=FIG08_CYCLES, topo=topo, engine=engine, device="cpu")
        assert res.slices_run == stats["slices_run"]
        for k in STATS:
            assert np.isclose(getattr(res, k), stats[k], rtol=1e-4,
                              atol=1e-4 if k == "bandwidth_tax" else 0.0), k


if __name__ == "__main__":
    arr, stats = fig08_reference()
    DATA.mkdir(parents=True, exist_ok=True)
    np.save(FIG08_TOPO, arr)
    FIG08_STATS.write_text(json.dumps(stats, indent=1) + "\n")
    print(f"wrote {FIG08_TOPO.name} {arr.shape} and {FIG08_STATS.name}: "
          f"{stats}", file=sys.stderr)

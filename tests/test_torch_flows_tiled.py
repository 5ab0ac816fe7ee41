"""PyTorch tiled flow engine against the JAX tiled engine and the port's
dense engine, on the CPU, and the flow-grid data chip_smoke.py holds the
card to.

Tolerances are tests/test_flows_tiled.py's: histograms bitwise, the
streamed p99s within one histogram bin of the dense engine's exact ones,
`backlog_frac` within 1e-5.  The port's tiled engine stages the dense
engine's deficit allowances and sums the per-flow deficit snapshots on
the host as the dense engine does, so its `backlog_frac` and remaining
bytes equal the dense engine's bit for bit, and every result is the same
whatever the window's width (the JAX tiled engine's is not: ROADMAP
Queue 3, R2).

The stored data (src/repro_torch/data/flow_grids_expected.json) is the
JAX package's run of Fig. 9's grid at the paper's 648 hosts
(benchmarks/fig09_websearch.py with num_hosts=648; auto resolves to the
tiled engine) and of Fig. 7's grid as the benchmark runs it
(benchmarks/fig07_datamining.py, on the tiled engine).  Regenerate it
with ``JAX_PLATFORMS=cpu PYTHONPATH=src python
tests/test_torch_flows_tiled.py`` (~2.5 min on a CPU); the staleness test
compares each stored scenario's flow count and byte sum with the JAX
package's `build_scenario`.
"""
import dataclasses
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.netsim import faults as jfaults
from repro.netsim import flows as jflows
from repro.netsim import flows_jax
from repro.netsim import sweep as jsweep
from repro_torch.netsim import faults as tfaults
from repro_torch.netsim import flows as tflows
from repro_torch.netsim import flows_torch
from repro_torch.netsim import sweep as tsweep

ROOT = Path(__file__).resolve().parents[1]
FLOW_GRIDS = ROOT / "src" / "repro_torch" / "data" / "flow_grids_expected.json"

TINY = dict(num_hosts=16, horizon_s=0.12, dt_s=5e-4, tail_s=0.1)
# tests/test_flows_tiled.py's geometry: tile retirement, window growth
# and the multi-chunk loop on test-sized scenarios
TILED_KW = dict(engine="tiled", tile_size=32, window_tiles=1, chunk_steps=16)
GRID = [("opera", "websearch", 0.1, 0), ("opera", "datamining", 0.35, 1),
        ("expander", "websearch", 0.2, 2), ("rotornet", "websearch", 0.15, 3)]
P99S = ("fct_p99_ms_small", "fct_p99_ms_mid", "fct_p99_ms_large")
RESULT_FIELDS = ("fct_p99_ms_small", "fct_p99_ms_mid",
                 "fct_p99_ms_large", "fct_mean_ms", "admitted",
                 "finished_frac", "backlog_frac")

# The grids chip_smoke.py runs: (networks, workloads, loads, seeds,
# build_scenario keywords, the JAX run's engine).
FLOW_GRID_SPECS = {
    # benchmarks/fig09_websearch.py:13-22 at the paper's 648 hosts
    "fig09_h648": dict(networks=("opera", "expander", "clos"),
                       workloads=("websearch",),
                       loads=(0.01, 0.05, 0.10, 0.20, 0.25), seeds=(2, 3),
                       sim_kw=dict(num_hosts=648, horizon_s=0.6, tail_s=0.3),
                       engine="auto"),
    # benchmarks/fig07_datamining.py:17-26, on the tiled engine
    "fig07": dict(networks=("opera", "expander", "clos", "rotornet"),
                  workloads=("datamining",), loads=(0.01, 0.10, 0.25, 0.40),
                  seeds=(1, 2),
                  sim_kw=dict(num_hosts=216, horizon_s=0.8, tail_s=0.4),
                  engine="tiled"),
}


def grid_scenarios(flows, spec):
    """The grid's scenarios in `simulate_grid`'s order."""
    return [(net, wl, load, seed,
             flows.build_scenario(net, wl, load, seed=seed, **spec["sim_kw"]))
            for net, wl, load, seed in itertools.product(
                spec["networks"], spec["workloads"], spec["loads"],
                spec["seeds"])]


def _plain(v):
    return bool(v) if isinstance(v, (bool, np.bool_)) else float(v)


def flow_grids_reference():
    """The JAX package's runs of both grids: each scenario's coordinates,
    flow count, byte sum, every result field and its histogram."""
    out = {}
    for name, spec in FLOW_GRID_SPECS.items():
        scns = grid_scenarios(jflows, spec)
        batch = flows_jax.simulate_flows_batch([s for *_, s in scns],
                                               engine=spec["engine"])
        rows = []
        for (net, wl, load, seed, s), r, h in zip(scns, batch.results,
                                                  batch.hists):
            rows.append(dict(network=net, workload=wl, load=load, seed=seed,
                             flows=s.num_flows, bytes=float(s.sizes.sum()),
                             **{f: _plain(getattr(r, f))
                                for f in RESULT_FIELDS},
                             hist=np.asarray(h).tolist()))
        out[name] = dict(spec, steps=scns[0][-1].steps,
                         peak_window_tiles=batch.peak_window_tiles, rows=rows)
    return out


def within_one_bin(a, b):
    """Equal sentinels (0, inf), or finite p99s within one bin."""
    if a == 0.0 or b == 0.0 or np.isinf(a) or np.isinf(b):
        return a == b
    return abs(np.log2(a / b)) / tflows.FCT_BIN_LOG2_WIDTH <= 1.0 + 1e-9


def assert_tiled_tolerances(got, want, hist_got, hist_want, tag):
    """tests/test_flows_tiled.py:71-91's tolerances, results as objects."""
    assert np.array_equal(hist_got, hist_want), tag
    assert got.admitted == want.admitted, tag
    assert got.finished_frac == want.finished_frac, tag
    assert abs(got.backlog_frac - want.backlog_frac) < 1e-5, tag
    for f in P99S:
        assert within_one_bin(getattr(got, f), getattr(want, f)), (tag, f)


def _scenarios(flows):
    return [flows.build_scenario(net, wl, load, seed=seed, **TINY)
            for net, wl, load, seed in GRID]


def _sched(faults):
    return faults.FailureSchedule(
        num_racks=8, num_switches=2, seed=5,
        events=(faults.FailureEvent("tor", (1,), onset_step=20, detect_lag=10,
                                    recover_step=120),
                faults.FailureEvent("switch", (0,), onset_step=40,
                                    detect_lag=8, recover_step=200)))


def _faulted(faults, flows):
    scns = _scenarios(flows)
    return [faults.apply_flow_faults(s, _sched(faults))
            for s in scns[:2]] + scns[2:]


def _batches(faulted):
    if faulted:
        return _faulted(jfaults, jflows), _faulted(tfaults, tflows)
    return _scenarios(jflows), _scenarios(tflows)


def _tiled(scns, **kw):
    return flows_torch.simulate_flows_batch(scns, device="cpu",
                                            **dict(TILED_KW, **kw))


def _pad(scn, npad=37):
    """tests/test_flows_tiled.py's `_pad`: `npad` never-active flows."""
    pads = dict(
        arr=np.full(npad, scn.horizon_s, scn.arr.dtype),
        sizes=np.zeros(npad, scn.sizes.dtype),
        start_step=np.full(npad, scn.steps + 1, scn.start_step.dtype),
        is_bulk=np.zeros(npad, scn.is_bulk.dtype),
    )
    if scn.has_faults:
        for f in ("blk_start", "blk_end", "frz_start", "frz_end"):
            pads[f] = np.full(npad, tfaults.NEVER, getattr(scn, f).dtype)
    return dataclasses.replace(scn, **{
        f: np.concatenate([getattr(scn, f), v]) for f, v in pads.items()})


class TestAgainstJax:
    @pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
    def test_tiled_matches_jax_tiled(self, faulted):
        """Same histograms (so the same streamed p99s), the same window
        peak, results at the JAX tiled engine's own tolerances."""
        js, ts = _batches(faulted)
        ref = flows_jax.simulate_flows_batch(
            js, engine="tiled", tile_size=32, window_tiles=1, chunk_steps=16)
        got = _tiled(ts)
        assert got.peak_window_tiles == ref.peak_window_tiles > 1
        for s, g, r, gh, rh, grem, rrem in zip(
                js, got.results, ref.results, got.hists, ref.hists,
                got.remaining_bytes, ref.remaining_bytes):
            tag = (s.network, s.workload, s.load)
            assert_tiled_tolerances(g, r, gh, rh, tag)
            for f in P99S:
                assert getattr(g, f) == getattr(r, f), (tag, f)
            assert np.isclose(g.fct_mean_ms, r.fct_mean_ms, rtol=1e-5), tag
            np.testing.assert_allclose(grem, rrem, rtol=1e-5, atol=1.0)

    def test_tiled_state_bytes(self):
        for w, t, b in ((16, 1024, 1), (128, 1024, 30), (1, 32, 4)):
            assert (flows_torch.tiled_state_bytes(w, t, b)
                    == flows_jax.tiled_state_bytes(w, t, b))


class TestAgainstDense:
    @pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
    def test_tiled_matches_dense(self, faulted):
        """tests/test_flows_tiled.py's tolerances hold; by construction
        the port's two engines also give the same `backlog_frac` and
        remaining bytes."""
        _, ts = _batches(faulted)
        dense = flows_torch.simulate_flows_batch(ts, engine="dense",
                                                 device="cpu")
        tiled = _tiled(ts)
        assert dense.peak_window_tiles is None
        for s, d, t, dh, th, drem, trem in zip(
                ts, dense.results, tiled.results, dense.hists, tiled.hists,
                dense.remaining_bytes, tiled.remaining_bytes):
            tag = (s.network, s.workload, s.load)
            assert_tiled_tolerances(t, d, th, dh, tag)
            assert t.backlog_frac == d.backlog_frac, tag
            np.testing.assert_array_equal(trem, drem, err_msg=str(tag))
            assert np.isclose(t.fct_mean_ms, d.fct_mean_ms, rtol=1e-5), tag

    @pytest.mark.parametrize("geometry", [
        dict(tile_size=8, window_tiles=2, chunk_steps=7),
        dict(tile_size=64, window_tiles=4, chunk_steps=64),
        dict(tile_size=1024, window_tiles=1, chunk_steps=128),
    ], ids=["t8-c7", "t64-c64", "t1024-c128"])
    def test_geometry_changes_nothing(self, geometry):
        """Any tile, window and chunk gives the same results, bit for bit."""
        _, ts = _batches(True)
        want = _tiled(ts)
        got = _tiled(ts, **geometry)
        assert got.results == want.results
        for a, b in zip(got.hists, want.hists):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got.remaining_bytes, want.remaining_bytes):
            np.testing.assert_array_equal(a, b)


class TestWindow:
    def test_window_growth_is_invisible(self):
        """R2: a window grown from 1 tile and one that starts at 64 give
        equal results, `backlog_frac` included."""
        _, ts = _batches(False)
        small = _tiled(ts, window_tiles=1)
        ample = _tiled(ts, window_tiles=64)
        assert small.peak_window_tiles > 1
        assert small.peak_window_tiles == ample.peak_window_tiles
        for a, b in zip(small.hists, ample.hists):
            assert np.array_equal(a, b)
        for a, b in zip(small.results, ample.results):
            assert a == b
            assert a.backlog_frac == b.backlog_frac

    @pytest.mark.parametrize("faulted", [False, True], ids=["clean", "faulted"])
    def test_pad_flows_change_nothing(self, faulted):
        _, ts = _batches(faulted)
        a = _tiled(ts)
        b = _tiled([_pad(s) for s in ts])
        for i, s in enumerate(ts):
            assert a.results[i] == b.results[i], (i, s.network, s.workload)
            assert np.array_equal(a.hists[i], b.hists[i])
            np.testing.assert_array_equal(a.remaining_bytes[i],
                                          b.remaining_bytes[i][:s.num_flows])
            assert np.all(b.remaining_bytes[i][s.num_flows:] == 0.0)

    def test_a_row_alone_and_in_a_batch(self):
        """Rows with fewer tiles than the batch's widest keep their own
        window: the same bits alone and beside longer rows."""
        ts = _scenarios(tflows)
        assert len({-(-s.num_flows // 32) for s in ts}) > 1
        batch = _tiled(ts)
        for i, s in enumerate(ts):
            alone = _tiled([s])
            assert alone.results[0] == batch.results[i]
            np.testing.assert_array_equal(alone.hists[0], batch.hists[i])


class TestDispatch:
    def test_auto_resolves_to_tiled_at_65536_flows(self):
        """A 648-host scenario of >= 65,536 flows runs tiled under auto
        (the window's peak says so) and agrees with the dense engine."""
        big = tflows.build_scenario("opera", "websearch", 0.3, num_hosts=648,
                                    horizon_s=0.3, dt_s=5e-3, tail_s=0.0)
        assert big.num_flows >= flows_torch.TILED_AUTO_FLOWS
        assert flows_torch.resolve_flow_engine("auto", big.num_flows) == \
            "tiled"
        auto = flows_torch.simulate_flows_batch([big], device="cpu")
        dense = flows_torch.simulate_flows_batch([big], engine="dense",
                                                 device="cpu")
        assert auto.peak_window_tiles >= 1
        assert auto.results[0].finished_frac > 0
        assert_tiled_tolerances(auto.results[0], dense.results[0],
                                auto.hists[0], dense.hists[0], "auto")
        assert auto.results[0].backlog_frac == dense.results[0].backlog_frac

    def test_trace_is_dense_only(self):
        scn = tflows.build_scenario("opera", "websearch", 0.1, seed=0, **TINY)
        with pytest.raises(ValueError, match="dense-only"):
            flows_torch.simulate_flows_batch([scn], engine="tiled", trace=True,
                                             device="cpu")
        # trace pins auto to dense, whatever the size
        assert flows_torch.simulate_flows_batch(
            [scn], trace=True, device="cpu").traces is not None

    def test_saturation_knee_engine_parity(self):
        """`flows.saturation_load` passes its engine to the tiled engine."""
        kw = dict(ceiling=0.4, coarse_points=4, refine_points=3, seeds=(0,),
                  device="cpu", **TINY)
        dense = tflows.saturation_load("opera", "websearch", engine="dense",
                                       **kw)
        tiled = tflows.saturation_load("opera", "websearch", engine="tiled",
                                       **kw)
        assert (dense.load, dense.beyond_grid) == (tiled.load,
                                                   tiled.beyond_grid)
        assert [r["backlog_frac"] for r in dense.ladder] == \
            [r["backlog_frac"] for r in tiled.ladder]


class TestFlowSweep:
    @pytest.mark.parametrize("engine", ["dense", "tiled"])
    def test_run_flow_sweep_matches_jax(self, engine):
        spec = dict(networks=("opera", "expander"),
                    workloads=("websearch", "datamining"), loads=(0.05, 0.2),
                    seeds=(0, 1), engine=engine)
        ref = jsweep.run_flow_sweep(jsweep.FlowSweepSpec(**spec), **TINY)
        tspec = tsweep.FlowSweepSpec(**spec)
        got = tsweep.run_flow_sweep(tspec, device="cpu", **TINY)
        assert tspec.num_scenarios == jsweep.FlowSweepSpec(
            **spec).num_scenarios == len(got) == 16
        for g, r in zip(got, ref):
            assert list(g) == list(r)
            for k in ("network", "workload", "load", "seed", "admitted",
                      "finished_frac"):
                assert g[k] == r[k], k
            assert abs(g["backlog_frac"] - r["backlog_frac"]) < 1e-5
            for f in P99S:
                assert within_one_bin(g[f], r[f]), f
        for by in (("network", "load"), ("network", "workload")):
            a = tsweep.summarize(got, by=by, stats=("admitted",
                                                    "finished_frac"))
            b = jsweep.summarize(ref, by=by, stats=("admitted",
                                                    "finished_frac"))
            assert a == b


class TestStoredGrids:
    @pytest.fixture(scope="class")
    def stored(self):
        return json.loads(FLOW_GRIDS.read_text())

    @pytest.mark.parametrize("name", sorted(FLOW_GRID_SPECS))
    def test_stored_grid_is_current(self, stored, name):
        """The stored spec is the one above, and each scenario has the
        flow count and byte sum of the JAX package's `build_scenario`
        (the runs are not repeated here)."""
        spec, want = FLOW_GRID_SPECS[name], stored[name]
        for k, v in spec.items():
            got = want[k]
            assert (tuple(got) if isinstance(v, tuple) else got) == v, k
        scns = grid_scenarios(jflows, spec)
        assert want["steps"] == scns[0][-1].steps
        assert len(want["rows"]) == len(scns)
        for (net, wl, load, seed, s), row in zip(scns, want["rows"]):
            assert (row["network"], row["workload"], row["load"],
                    row["seed"]) == (net, wl, load, seed)
            assert row["flows"] == s.num_flows
            assert row["bytes"] == float(s.sizes.sum())
            assert np.asarray(row["hist"]).sum() == round(
                row["finished_frac"] * s.num_flows)

    def test_fig09_is_on_the_tiled_engine(self, stored):
        """At 648 hosts Fig. 9's largest scenarios reach the tiled size,
        so auto ran the JAX tiled engine."""
        rows = stored["fig09_h648"]["rows"]
        assert max(r["flows"] for r in rows) >= flows_torch.TILED_AUTO_FLOWS
        assert stored["fig09_h648"]["peak_window_tiles"] > 0

    def test_port_scenarios_equal_jax(self, stored):
        """The port's `build_scenario` draws the stored grids' scenarios."""
        for name, spec in FLOW_GRID_SPECS.items():
            for (*_, s), row in zip(grid_scenarios(tflows, spec)[::7],
                                    stored[name]["rows"][::7]):
                assert (s.num_flows, float(s.sizes.sum())) == \
                    (row["flows"], row["bytes"])


if __name__ == "__main__":
    expected = flow_grids_reference()
    FLOW_GRIDS.write_text(json.dumps(expected, indent=None) + "\n")
    print(f"wrote {FLOW_GRIDS.name}: " + ", ".join(
        f"{k} {len(v['rows'])} rows" for k, v in expected.items()),
        file=sys.stderr)

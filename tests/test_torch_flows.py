"""PyTorch dense flow engine against the JAX reference, on the CPU.

The copies of the numpy modules (`capacity`, the flow-size half of
`workloads`, the framework-free half of `flows`) must build the JAX
package's scenarios array for array.  The same scenarios then go through
`repro.netsim.flows_jax` and `repro_torch.netsim.flows_torch`, and both
are held to the float64 oracle `flows._oracle_steps` at
tests/test_flows_jax.py's tolerances: trajectories atol
``sizes.max() * 1e-5``; admitted equal, finished_frac atol 1e-6,
backlog_frac atol 1e-4, the p99s and the mean rtol and atol 1e-3.
Completion histograms must equal the JAX engine's bit for bit.  The
faulted cases are tests/test_netsim_faults.py's.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.topology import build_opera_topology
from repro.netsim import capacity as jcapacity
from repro.netsim import faults as jfaults
from repro.netsim import flows as jflows
from repro.netsim import flows_jax
from repro.netsim import workloads as jworkloads
from repro_torch.core.topology import topology_from_arrays
from repro_torch.netsim import capacity as tcapacity
from repro_torch.netsim import faults as tfaults
from repro_torch.netsim import flows as tflows
from repro_torch.netsim import flows_torch
from repro_torch.netsim import workloads as tworkloads

TINY = dict(num_hosts=16, horizon_s=0.12, dt_s=5e-4, tail_s=0.1)
GRID = [(net, wl, load) for net in ("opera", "expander", "clos", "rotornet")
        for wl in ("datamining", "websearch") for load in (0.05, 0.3)]
SCENARIO_ARRAYS = ("arr", "sizes", "start_step", "is_bulk")
SCENARIO_SCALARS = ("network", "workload", "load", "seed", "horizon_s", "dt_s",
                    "tail_s", "num_hosts", "link_gbps", "lat_pool_Bps",
                    "bulk_pool_Bps", "steps", "mid_step", "end_step")
FAULT_FIELDS = ("blk_start", "blk_end", "frz_start", "frz_end", "lat_scale",
                "bulk_scale")
P99S = ("fct_p99_ms_small", "fct_p99_ms_mid", "fct_p99_ms_large")


def _pair(*args, **kw):
    """The same scenario from both packages' `build_scenario`."""
    return (jflows.build_scenario(*args, **kw),
            tflows.build_scenario(*args, **kw))


def _assert_same_scenario(j, t):
    for f in SCENARIO_ARRAYS + FAULT_FIELDS:
        a, b = getattr(j, f), getattr(t, f)
        if a is None:
            assert b is None, f
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    for f in SCENARIO_SCALARS:
        assert getattr(t, f) == getattr(j, f), f


def _assert_close_to(o, r):
    """tests/test_flows_jax.py:55-70: `r` against the oracle's `o`."""
    assert o.admitted == r.admitted
    assert np.isclose(o.finished_frac, r.finished_frac, atol=1e-6)
    assert np.isclose(o.backlog_frac, r.backlog_frac, atol=1e-4)
    for f in P99S + ("fct_mean_ms",):
        a, b = getattr(o, f), getattr(r, f)
        if np.isfinite(a) or np.isfinite(b):
            assert np.isclose(a, b, rtol=1e-3, atol=1e-3), (f, a, b)


def _oracle(scn, trace=False):
    done, rem, rem_mid, rem_end, tr = jflows._oracle_steps(scn, trace=trace)
    return jflows.finalize(scn, done, rem_mid, rem_end), rem, tr


def _grid():
    pairs = [_pair(net, wl, load, seed=3, **TINY) for net, wl, load in GRID]
    return [j for j, _ in pairs], [t for _, t in pairs]


# ---------------------------------------------------------------------------
# copies of the numpy modules
# ---------------------------------------------------------------------------


class TestCopies:
    def test_capacity(self):
        assert tcapacity.summary_648() == jcapacity.summary_648()
        for wl in ("shuffle", "hotrack", "skew", "permutation"):
            for alpha in (1.0, 1.7, 3.2):
                assert (tcapacity.fig12_model(alpha, wl)
                        == jcapacity.fig12_model(alpha, wl))
            assert (tcapacity.crossover_alpha(wl)
                    == jcapacity.crossover_alpha(wl))

    @pytest.mark.parametrize("name", ["websearch", "datamining", "hadoop"])
    def test_flow_sizes(self, name):
        assert tworkloads.mean_flow_size(name) == jworkloads.mean_flow_size(name)
        for cut in (1e5, 15e6):
            assert (tworkloads.byte_fraction_below(name, cut)
                    == jworkloads.byte_fraction_below(name, cut))
        np.testing.assert_array_equal(
            tworkloads.sample_flow_sizes(name, 5000, np.random.default_rng(4)),
            jworkloads.sample_flow_sizes(name, 5000, np.random.default_rng(4)))

    def test_scenarios_equal(self):
        for j, t in zip(*_grid()):
            _assert_same_scenario(j, t)
        for f in ("arrived_mask", "deficit_allowance"):
            np.testing.assert_array_equal(getattr(t, f)(t.mid_step),
                                          getattr(j, f)(j.mid_step))
        j = jflows.build_mixed_scenario(0.05, bulk_load=0.5, num_hosts=16,
                                        horizon_s=0.1, seed=1)
        t = tflows.build_mixed_scenario(0.05, bulk_load=0.5, num_hosts=16,
                                        horizon_s=0.1, seed=1)
        _assert_same_scenario(j, t)
        with pytest.raises(ValueError):
            tflows.build_scenario("torus", "websearch", 0.1, **TINY)

    def test_histogram_helpers(self):
        np.testing.assert_array_equal(tflows.fct_hist_edges(),
                                      jflows.fct_hist_edges())
        rng = np.random.default_rng(0)
        fct = 10.0 ** rng.uniform(-3, 6, 4000)
        sizes = 10.0 ** rng.uniform(2, 9, 4000)
        np.testing.assert_array_equal(tflows.fct_bin(fct), jflows.fct_bin(fct))
        np.testing.assert_array_equal(tflows.fct_class_id(sizes),
                                      jflows.fct_class_id(sizes))
        hist = np.bincount(jflows.fct_bin(fct), minlength=96)
        for q in (50.0, 99.0):
            assert tflows.hist_percentile(hist, q) == \
                jflows.hist_percentile(hist, q)
        ok = rng.uniform(size=4000) < 0.9
        sel = sizes < 1e5
        assert (tflows.percentile_fct(fct, sel, ok)
                == jflows.percentile_fct(fct, sel, ok))
        for n, d in ((0, 0), (10, 0), (10, 3), (10, 10)):
            assert (tflows.percentile_fct_streamed(hist, n, d)
                    == jflows.percentile_fct_streamed(hist, n, d))

    def test_finalize_equal(self):
        """`finalize` and `finalize_streamed` on the oracle's own outputs."""
        jscns, tscns = _grid()
        for j, t in zip(jscns[:6], tscns[:6]):
            done, _, rem_mid, rem_end, _ = jflows._oracle_steps(j)
            assert (dataclasses.asdict(tflows.finalize(t, done, rem_mid, rem_end))
                    == dataclasses.asdict(jflows.finalize(j, done, rem_mid,
                                                          rem_end)))
            ok = done >= 0
            fct = np.where(ok, done * j.dt_s - j.arr, 1.0) * 1e3
            hist = np.zeros((3, 96), np.int64)
            np.add.at(hist, (jflows.fct_class_id(j.sizes)[ok],
                             jflows.fct_bin(fct[ok])), 1)
            s = float(fct[ok].sum())
            assert (dataclasses.asdict(
                tflows.finalize_streamed(t, hist, s, rem_mid, rem_end))
                == dataclasses.asdict(
                    jflows.finalize_streamed(j, hist, s, rem_mid, rem_end)))


# ---------------------------------------------------------------------------
# the dense engine against the oracle and the JAX engine
# ---------------------------------------------------------------------------


class TestParity:
    @pytest.fixture(scope="class")
    def runs(self):
        jscns, tscns = _grid()
        return (jscns, tscns, flows_jax.simulate_flows_batch(jscns, trace=True),
                flows_torch.simulate_flows_batch(tscns, trace=True,
                                                 device="cpu"))

    def test_trajectories_match_oracle(self, runs):
        jscns, _, _, got = runs
        for s, tr in zip(jscns, got.traces):
            _, _, oracle_tr = _oracle(s, trace=True)
            assert oracle_tr.shape == tr.shape
            np.testing.assert_allclose(
                tr, oracle_tr, atol=s.sizes.max() * 1e-5,
                err_msg=f"{s.network}/{s.workload}/{s.load}")

    def test_results_match_oracle(self, runs):
        jscns, _, _, got = runs
        for s, r, rem in zip(jscns, got.results, got.remaining_bytes):
            o, o_rem, _ = _oracle(s)
            _assert_close_to(o, r)
            np.testing.assert_allclose(rem, o_rem, atol=s.sizes.max() * 1e-5)

    def test_results_match_jax(self, runs):
        _, _, ref, got = runs
        for a, b, ha, hb in zip(ref.results, got.results, ref.hists,
                                got.hists):
            _assert_close_to(a, b)
            np.testing.assert_array_equal(hb, ha)
            assert hb.shape == (3, 96) and hb.dtype == np.int64

    def test_mixed_scenario(self):
        j = jflows.build_mixed_scenario(0.05, bulk_load=0.5, num_hosts=16,
                                        horizon_s=0.1, seed=1)
        t = tflows.build_mixed_scenario(0.05, bulk_load=0.5, num_hosts=16,
                                        horizon_s=0.1, seed=1)
        o, o_rem, _ = _oracle(j)
        batch = flows_torch.simulate_flows_batch([t], device="cpu")
        _assert_close_to(o, batch.results[0])
        np.testing.assert_allclose(batch.remaining_bytes[0], o_rem,
                                   atol=j.sizes.max() * 1e-5)
        ref = flows_jax.simulate_flows_batch([j])
        np.testing.assert_array_equal(batch.hists[0], ref.hists[0])

    def test_pad_flows_are_invisible(self):
        """A row's results are the same bits alone and beside longer rows."""
        _, a = _pair("opera", "websearch", 0.08, seed=5, **TINY)
        _, b = _pair("expander", "datamining", 0.3, seed=6, **TINY)
        _, c = _pair("clos", "websearch", 0.2, seed=7, **TINY)
        assert b.num_flows < max(a.num_flows, c.num_flows)
        alone = flows_torch.simulate_flows_batch([b], device="cpu")
        mixed = flows_torch.simulate_flows_batch([a, b, c], device="cpu")
        assert alone.results[0] == mixed.results[1]
        np.testing.assert_array_equal(alone.hists[0], mixed.hists[1])
        np.testing.assert_array_equal(alone.remaining_bytes[0],
                                      mixed.remaining_bytes[1])


# ---------------------------------------------------------------------------
# faults (tests/test_netsim_faults.py:282-360)
# ---------------------------------------------------------------------------


def _fault_draws(faults, topo):
    S = topo.num_slices
    kw = dict(onset_step=S, detect_lag=3)
    return [
        faults.FailureSchedule.draw(topo, seed=5, link_frac=0.15, **kw),
        faults.FailureSchedule.draw(topo, seed=6, tor_frac=0.15,
                                    recover_step=4 * S, **kw),
        faults.FailureSchedule.draw(topo, seed=7, switch_count=1, **kw),
        faults.FailureSchedule.draw(topo, seed=8, link_frac=0.1,
                                    tor_frac=0.12, switch_count=1, **kw),
    ]


def _rebased(sched):
    """The fluid-step timelines moved onto dt ticks: onset 40, recovery
    (where drawn) at 160 of the 440 steps."""
    return dataclasses.replace(sched, events=tuple(
        dataclasses.replace(ev, onset_step=40,
                            recover_step=(160 if ev.recover_step is not None
                                          else None))
        for ev in sched.events))


class TestFaulted:
    @pytest.fixture(scope="class")
    def topos(self):
        jtopo = build_opera_topology(8, 2, seed=0)
        return jtopo, topology_from_arrays(
            8, 2, np.asarray(jtopo.switch_matchings), 1)

    @pytest.fixture(scope="class")
    def scenarios(self, topos):
        jtopo, topo = topos
        jbase, tbase = _pair("opera", "websearch", 0.12, seed=0, **TINY)
        js, ts = [jbase], [tbase]
        for j, t in zip(_fault_draws(jfaults, jtopo),
                        _fault_draws(tfaults, topo)):
            js.append(jfaults.apply_flow_faults(jbase, _rebased(j)))
            ts.append(tfaults.apply_flow_faults(tbase, _rebased(t)))
        for j, t in zip(js, ts):
            _assert_same_scenario(j, t)
        return js, ts

    def test_oracle_and_jax_parity(self, scenarios):
        js, ts = scenarios
        got = flows_torch.simulate_flows_batch(ts, device="cpu")
        ref = flows_jax.simulate_flows_batch(js)
        for s, r, jr, h, jh in zip(js, got.results, ref.results, got.hists,
                                   ref.hists):
            o, _, _ = _oracle(s)
            _assert_close_to(o, r)
            _assert_close_to(jr, r)
            np.testing.assert_array_equal(h, jh)

    def test_trace_parity(self, scenarios):
        js, ts = scenarios
        batch = flows_torch.simulate_flows_batch(ts[:3], trace=True,
                                                 device="cpu")
        for scn, tr in zip(js[:3], batch.traces):
            _, _, oracle_tr = _oracle(scn, trace=True)
            np.testing.assert_allclose(tr, oracle_tr,
                                       atol=scn.sizes.max() * 1e-5)

    def test_projection_windows(self, topos):
        _, topo = topos
        scn = tflows.build_scenario("opera", "websearch", 0.12, seed=0, **TINY)
        sched = tfaults.FailureSchedule.draw(topo, seed=5, tor_frac=0.25,
                                             onset_step=40, detect_lag=5,
                                             recover_step=160)
        f = tfaults.apply_flow_faults(scn, sched)
        assert f.has_faults and f is not scn
        assert (f.blk_start < tfaults.NEVER).any()
        assert (f.frz_start < tfaults.NEVER).any()
        assert (f.lat_scale < 1.0).any()

    def test_frozen_flows_retry_after_recovery(self, topos):
        """Flows frozen behind a dead ToR make progress again after its
        recovery at step 120, and the run keeps most of its completions."""
        _, topo = topos
        scn = tflows.build_scenario("opera", "websearch", 0.12, seed=0, **TINY)
        sched = tfaults.FailureSchedule.draw(topo, seed=5, tor_frac=0.25,
                                             onset_step=40, detect_lag=5,
                                             recover_step=120)
        f = tfaults.apply_flow_faults(scn, sched)
        batch = flows_torch.simulate_flows_batch([f, scn], trace=True,
                                                 device="cpu")
        tr = batch.traces[0]
        frozen = f.frz_start < tfaults.NEVER
        during = tr[119]
        assert (tr[100][frozen] == during[frozen]).all()  # frozen: no service
        resumed = frozen & (during > 0) & (tr[-1] < during)
        assert resumed.any()                 # retry on recovery
        faulted, clean = batch.results
        assert faulted.finished_frac > 0.5 * clean.finished_frac

    def test_fault_free_batch_runs_the_unfaulted_step(self, scenarios):
        """A batch without fault rows stages no fault tensors; its row
        inside a faulted batch (NEVER windows, unit scales) gives the same
        bits."""
        js, ts = scenarios
        _, ops, _ = flows_torch._stage([ts[0]], ts[0].steps,
                                       ts[0].num_flows, torch.float32,
                                       torch.device("cpu"))
        assert not ops.faulted
        clean = flows_torch.simulate_flows_batch([ts[0]], device="cpu")
        faulted = flows_torch.simulate_flows_batch(ts[:2], device="cpu")
        assert clean.results[0] == faulted.results[0]
        np.testing.assert_array_equal(clean.hists[0], faulted.hists[0])
        ref = flows_jax.simulate_flows_batch([js[0]])
        np.testing.assert_array_equal(clean.hists[0], ref.hists[0])


# ---------------------------------------------------------------------------
# grids, ladders and the API's edges
# ---------------------------------------------------------------------------


class TestGrids:
    def test_simulate_grid_matches_jax(self):
        kw = dict(seeds=(0, 1), **TINY)
        args = (("opera", "expander"), ("websearch",), (0.05, 0.2))
        got = flows_torch.simulate_grid(*args, device="cpu", **kw)
        ref = flows_jax.simulate_grid(*args, **kw)
        assert len(got) == 8
        for g, r in zip(got, ref):
            assert list(g) == list(r)
            for k in ("network", "workload", "load", "seed", "admitted"):
                assert g[k] == r[k], k
            _assert_close_to(jflows.FlowSimResult(
                **{f.name: r[f.name] for f in dataclasses.fields(
                    jflows.FlowSimResult)}), tflows.FlowSimResult(
                **{f.name: g[f.name] for f in dataclasses.fields(
                    tflows.FlowSimResult)}))

    def test_saturation_ladder_matches_jax(self):
        loads = (0.04, 0.08, 0.25)
        got = flows_torch.saturation_ladder("opera", "websearch", loads,
                                            seeds=(0, 1), device="cpu", **TINY)
        ref = flows_jax.saturation_ladder("opera", "websearch", loads,
                                          seeds=(0, 1), **TINY)
        assert [r["load"] for r in got] == list(loads)
        for g, r in zip(got, ref):
            assert g["admitted_frac"] == r["admitted_frac"]
            assert np.isclose(g["backlog_frac"], r["backlog_frac"], atol=1e-4)
            assert np.isclose(g["finished_frac"], r["finished_frac"],
                              atol=1e-6)

    def test_saturation_load_matches_jax(self):
        kw = dict(ceiling=0.3, coarse_points=4, refine_points=2,
                  num_hosts=16, horizon_s=0.2, dt_s=5e-4, tail_s=0.1)
        got = tflows.saturation_load("opera", "websearch", device="cpu", **kw)
        ref = jflows.saturation_load("opera", "websearch", **kw)
        assert (got.load, got.beyond_grid) == (ref.load, ref.beyond_grid)
        assert [r["load"] for r in got.ladder] == [r["load"] for r in ref.ladder]
        assert float(got) == got.load


class TestApi:
    def test_engine_resolution(self):
        assert flows_torch.resolve_flow_engine("auto", 65535) == "dense"
        assert flows_torch.resolve_flow_engine("auto", 65536) == "tiled"
        assert flows_torch.resolve_flow_engine("auto", 10**6, trace=True) \
            == "dense"
        with pytest.raises(ValueError):
            flows_torch.resolve_flow_engine("sparse", 16)

    def test_batch_checks(self):
        _, a = _pair("opera", "websearch", 0.1, **TINY)
        _, b = _pair("opera", "websearch", 0.1, **dict(TINY, horizon_s=0.2))
        with pytest.raises(ValueError, match="step count"):
            flows_torch.simulate_flows_batch([a, b], device="cpu")
        with pytest.raises(ValueError, match="TRACE_MAX_ELEMS"):
            flows_torch.simulate_flows_batch([a] * 2000, trace=True,
                                             device="cpu")
        assert flows_torch.simulate_flows_batch([], device="cpu").results == []
        assert flows_torch.dense_state_bytes(1000, 4) == 148000

    def test_default_device_is_cuda(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is usable")
        _, a = _pair("opera", "websearch", 0.1, **TINY)
        with pytest.raises(RuntimeError, match="CUDA"):
            flows_torch.simulate_flows_batch([a])
        with pytest.raises(RuntimeError, match="CUDA"):
            flows_torch.simulate_grid(("opera",), ("websearch",), (0.1,),
                                      **TINY)

"""Fig. 11's fluid and flow columns: the data chip_smoke.py holds the card
to, and the port reproducing it on the CPU.

Fig. 11 (benchmarks/fig11_faults.py) runs the 648-host OPERA network
(k12-n108, `build_opera_topology(108, 6, seed=1,
switch_fault_tolerance=2)`) under ten failure rows at load 0.4 paced
over 12 cycles with a detection lag of 3 (fluid engine), and four flow
scenarios of 28,072 Websearch flows (dense flow engine).  The port may
draw another topology from that seed (ROADMAP T1), so the JAX package's
draw is stored in src/repro_torch/data/ with the JAX package's rows.
Regenerate both with
``JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_fig11.py``.

Tolerances: retention rtol 1e-4 (Fig. 8's stats), blackholed and
residual fractions atol 1e-6; flow results at tests/test_flows_jax.py's
(admitted equal, finished_frac atol 1e-6, backlog_frac atol 1e-4, the
p99s and the mean rtol and atol 1e-3) and histograms bitwise.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core.schedule import cycle_timing, slice_capacity_bytes
from repro.core.topology import build_opera_topology
from repro.netsim import faults as jfaults
from repro.netsim import flows as jflows
from repro.netsim import flows_jax, fluid_jax
from repro.netsim.sweep import DesignPoint as JDesignPoint
from repro_torch.core.topology import topology_from_arrays
from repro_torch.netsim import faults as tfaults
from repro_torch.netsim import flows as tflows
from repro_torch.netsim import flows_torch, fluid_torch
from repro_torch.netsim.sweep import DesignPoint

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "src" / "repro_torch" / "data"
FIG11_TOPO = DATA / "fig11_k12_n108_seed1_sft2.npy"
FIG11_EXPECTED = DATA / "fig11_expected.json"
FIG11_FAST = ROOT / "results" / "benchmarks" / "fig11_faults.json"

# benchmarks/fig11_faults.py's protocol
LOAD, PACED, DETECT_LAG = 0.4, 12, 3
LINK_FRACS = (0.02, 0.04, 0.08)
TOR_FRACS = (0.05, 0.07, 0.12)
SWITCH_COUNTS = (1, 2, 3)
FLOW_SCENARIO = dict(network="opera", workload="websearch", load=0.25,
                     num_hosts=216, horizon_s=0.4, dt_s=2e-4, tail_s=0.2,
                     seed=0)
FLOW_ONSET, FLOW_LAG, FLOW_TOR_RECOVER = 300, 3, 1500
FLOW_FIELDS = ("load", "fct_p99_ms_small", "fct_p99_ms_mid",
               "fct_p99_ms_large", "fct_mean_ms", "admitted",
               "finished_frac", "backlog_frac")


def fluid_schedules(faults, topo):
    """fig11_faults._schedules in full mode: (label, schedule) rows, the
    failure-free baseline first."""
    S = topo.num_slices
    kw = dict(onset_step=2 * S, detect_lag=DETECT_LAG)
    rows = [("baseline", faults.FailureSchedule.empty(topo))]
    rows += [(f"links {f:.2f}", faults.FailureSchedule.draw(
        topo, seed=11, link_frac=f, **kw)) for f in LINK_FRACS]
    rows += [(f"tors {f:.2f}", faults.FailureSchedule.draw(
        topo, seed=13, tor_frac=f, recover_step=(PACED - 2) * S, **kw))
        for f in TOR_FRACS]
    rows += [(f"switches {k}/6", faults.FailureSchedule.draw(
        topo, seed=17, switch_count=k, **kw)) for k in SWITCH_COUNTS]
    return rows


def fluid_demand(cfg, num_rows):
    """Each ordered pair offered LOAD of its u - 1 direct slices a cycle,
    over PACED cycles."""
    cap = slice_capacity_bytes(cfg, cycle_timing(cfg))
    d = np.full((cfg.num_racks, cfg.num_racks),
                LOAD * (cfg.u - 1) * cap * PACED)
    np.fill_diagonal(d, 0.0)
    return np.broadcast_to(d, (num_rows,) + d.shape)


def fluid_rows(res, labels, num_slices):
    """fig11_faults.fluid_retention's columns from a batch result."""
    T = (PACED + 1) * num_slices - 1       # one cycle past the paced window
    base = float(res.finished_frac[0, T])
    return {label: dict(
        retention=float(res.finished_frac[i, T]) / base,
        blackholed_frac=float(res.blackholed_bytes[i] / res.total_bytes[i]),
        residual_frac=float(res.residual_bytes[i] / res.total_bytes[i]))
        for i, label in enumerate(labels)}


def flow_scenarios(faults, flows, topo):
    """fig11_faults.flow_fct_inflation's four scenarios."""
    kw = dict(FLOW_SCENARIO)
    scn = flows.build_scenario(kw.pop("network"), kw.pop("workload"),
                               kw.pop("load"), **kw)
    lag = dict(onset_step=FLOW_ONSET, detect_lag=FLOW_LAG)
    draws = [
        ("clean", None),
        ("links 0.04", faults.FailureSchedule.draw(
            topo, seed=11, link_frac=0.04, **lag)),
        ("tors 0.07", faults.FailureSchedule.draw(
            topo, seed=13, tor_frac=0.07, recover_step=FLOW_TOR_RECOVER,
            **lag)),
        ("switches 2/6", faults.FailureSchedule.draw(
            topo, seed=17, switch_count=2, **lag)),
    ]
    return [(label, scn if s is None else faults.apply_flow_faults(scn, s))
            for label, s in draws]


def flow_rows(batch, labels):
    """Every `FlowSimResult` field (as JSON types) and the (3, 96)
    completion histogram of each scenario."""
    def plain(v):
        return bool(v) if isinstance(v, (bool, np.bool_)) else float(v)

    return {label: dict(**{f: plain(getattr(r, f)) for f in FLOW_FIELDS},
                        hist=h.tolist())
            for label, r, h in zip(labels, batch.results, batch.hists)}


def fig11_reference():
    """The JAX package's topology and its Fig. 11 rows, as stored."""
    topo = build_opera_topology(108, 6, seed=1, switch_fault_tolerance=2)
    cfg = JDesignPoint(k=12, num_racks=108).to_config()
    rows = fluid_schedules(jfaults, topo)
    res = fluid_jax.simulate_rotor_bulk_batch(
        cfg, fluid_demand(cfg, len(rows)), topo=topo, max_cycles=PACED + 2,
        faults=[s for _, s in rows], paced_cycles=PACED)
    scns = flow_scenarios(jfaults, jflows, topo)
    batch = flows_jax.simulate_flows_batch([s for _, s in scns])
    expected = dict(
        design="k12-n108-g1", topo_seed=1, switch_fault_tolerance=2,
        load=LOAD, paced_cycles=PACED, detect_lag=DETECT_LAG,
        max_cycles=PACED + 2, flow_scenario=FLOW_SCENARIO,
        fluid=fluid_rows(res, [label for label, _ in rows], topo.num_slices),
        flows=flow_rows(batch, [label for label, _ in scns]))
    return np.asarray(topo.switch_matchings).astype(np.int16), expected


def _close(a, b, rtol, atol):
    if not (np.isfinite(a) or np.isfinite(b)):
        return a == b
    return bool(np.isclose(a, b, rtol=rtol, atol=atol))


def assert_flow_rows(got, want):
    for label, w in want.items():
        g = got[label]
        assert g["admitted"] == w["admitted"], label
        assert np.isclose(g["finished_frac"], w["finished_frac"], atol=1e-6)
        assert np.isclose(g["backlog_frac"], w["backlog_frac"], atol=1e-4)
        for f in ("fct_p99_ms_small", "fct_p99_ms_mid", "fct_p99_ms_large",
                  "fct_mean_ms"):
            assert _close(g[f], w[f], 1e-3, 1e-3), (label, f, g[f], w[f])
        np.testing.assert_array_equal(g["hist"], w["hist"], err_msg=label)


@pytest.fixture(scope="module")
def stored():
    return np.load(FIG11_TOPO), json.loads(FIG11_EXPECTED.read_text())


@pytest.fixture(scope="module")
def topo(stored):
    return topology_from_arrays(108, 6, stored[0], groups=1)


class TestFig11Data:
    def test_stored_data_is_current(self, stored):
        arr, want = stored
        want_arr, expected = fig11_reference()
        np.testing.assert_array_equal(arr, want_arr)
        for k in ("load", "paced_cycles", "detect_lag", "max_cycles",
                  "flow_scenario"):
            assert want[k] == expected[k], k
        for label, row in expected["fluid"].items():
            for k, v in row.items():
                assert np.isclose(want["fluid"][label][k], v, rtol=1e-6,
                                  atol=1e-12), (label, k)
        for label, row in expected["flows"].items():
            for k, v in row.items():
                if k == "hist":
                    assert want["flows"][label][k] == v, label
                else:
                    assert _close(want["flows"][label][k], v, 1e-6, 1e-12), (
                        label, k)

    def test_stored_rows_match_the_fast_run(self, stored):
        """results/benchmarks/fig11_faults.json holds the --fast rows
        (the same draws in a batch of three)."""
        fast = json.loads(FIG11_FAST.read_text())["fluid"]
        for label, row in fast.items():
            assert np.isclose(stored[1]["fluid"][label]["retention"],
                              row["retention"], rtol=1e-4), label
            for k in ("blackholed_frac", "residual_frac"):
                assert np.isclose(stored[1]["fluid"][label][k], row[k],
                                  atol=1e-6), (label, k)

    def test_paper_checks(self, stored):
        """fig11_faults.py's checks: <= 10 % throughput loss at ~4 % link
        failures and at 2/6 switches; 3/6 degrades visibly."""
        fluid = stored[1]["fluid"]
        assert fluid["links 0.04"]["retention"] >= 0.90
        assert fluid["switches 2/6"]["retention"] >= 0.90
        assert (fluid["switches 3/6"]["retention"]
                < fluid["switches 2/6"]["retention"] - 0.05)
        fl = stored[1]["flows"]
        assert fl["switches 2/6"]["fct_p99_ms_small"] >= \
            fl["clean"]["fct_p99_ms_small"]


class TestPortOnCpu:
    """What chip_smoke.py's fig11 phase checks on the card."""

    @pytest.mark.parametrize("engine", ["dense", "sparse"])
    def test_fluid_rows(self, stored, topo, engine):
        want = stored[1]["fluid"]
        cfg = DesignPoint(k=12, num_racks=108).to_config()
        rows = fluid_schedules(tfaults, topo)
        res = fluid_torch.simulate_rotor_bulk_batch(
            cfg, fluid_demand(cfg, len(rows)), topo=topo,
            max_cycles=PACED + 2, faults=[s for _, s in rows],
            paced_cycles=PACED, engine=engine, device="cpu")
        got = fluid_rows(res, [label for label, _ in rows], topo.num_slices)
        assert list(got) == list(want)
        for label, w in want.items():
            g = got[label]
            assert np.isclose(g["retention"], w["retention"], rtol=1e-4), label
            for k in ("blackholed_frac", "residual_frac"):
                assert np.isclose(g[k], w[k], rtol=0, atol=1e-6), (label, k)
        assert got["baseline"]["blackholed_frac"] == 0.0

    def test_flow_rows(self, stored, topo):
        scns = flow_scenarios(tfaults, tflows, topo)
        assert [s.num_flows for _, s in scns] == [28072] * 4
        batch = flows_torch.simulate_flows_batch([s for _, s in scns],
                                                 device="cpu")
        assert_flow_rows(flow_rows(batch, [label for label, _ in scns]),
                         stored[1]["flows"])


if __name__ == "__main__":
    arr, expected = fig11_reference()
    DATA.mkdir(parents=True, exist_ok=True)
    np.save(FIG11_TOPO, arr)
    FIG11_EXPECTED.write_text(json.dumps(expected, indent=1) + "\n")
    print(f"wrote {FIG11_TOPO.name} {arr.shape} and {FIG11_EXPECTED.name}",
          file=sys.stderr)

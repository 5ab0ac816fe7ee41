"""The port's copies of `core/routing`, `core/expander` and
`core/classify`, and `FailureSchedule.to_failure_set`, against the JAX
package's, on the CPU.

Both packages get the same topology: the 8-rack test topology and
Fig. 11's stored seed-1, switch_fault_tolerance=2 k12-n108 draw
(src/repro_torch/data/, ROADMAP T1), each carried across as arrays.  The
copies are numpy only, so every result must be equal (floats to 1e-12).

src/repro_torch/data/fig11_static_expected.json holds the JAX package's
static cross-check of Fig. 11's full-mode rows
(benchmarks/fig11_faults.py:134-158: stride 4, the nine failure rows)
on that topology, which chip_smoke.py holds the port to.  Regenerate it
with ``JAX_PLATFORMS=cpu PYTHONPATH=src python tests/test_torch_routing.py``.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.core import classify as jclassify
from repro.core import expander as jexpander
from repro.core import routing as jrouting
from repro.core.topology import OperaTopology as JTopology
from repro.core.topology import build_opera_topology
from repro.netsim import faults as jfaults
from repro_torch.core import classify as tclassify
from repro_torch.core import expander as texpander
from repro_torch.core import routing as trouting
from repro_torch.core.topology import topology_from_arrays
from repro_torch.netsim import faults as tfaults

ROOT = Path(__file__).resolve().parents[1]
DATA = ROOT / "src" / "repro_torch" / "data"
FIG11_TOPO = DATA / "fig11_k12_n108_seed1_sft2.npy"
FIG11_STATIC = DATA / "fig11_static_expected.json"
FIG11_FAST = ROOT / "results" / "benchmarks" / "fig11_faults.json"
PACED, DETECT_LAG = 12, 3            # benchmarks/fig11_faults.py:34-36


def fig11_schedules(faults, topo, fast=False):
    """benchmarks/fig11_faults.py's `_schedules`: (label, schedule) rows,
    the failure-free baseline first."""
    S = topo.num_slices
    kw = dict(onset_step=2 * S, detect_lag=DETECT_LAG)
    rows = [("baseline", faults.FailureSchedule.empty(topo))]
    rows += [(f"links {f:.2f}", faults.FailureSchedule.draw(
        topo, seed=11, link_frac=f, **kw))
        for f in ((0.04,) if fast else (0.02, 0.04, 0.08))]
    rows += [(f"tors {f:.2f}", faults.FailureSchedule.draw(
        topo, seed=13, tor_frac=f, recover_step=(PACED - 2) * S, **kw))
        for f in (() if fast else (0.05, 0.07, 0.12))]
    rows += [(f"switches {k}/6", faults.FailureSchedule.draw(
        topo, seed=17, switch_count=k, **kw))
        for k in ((2,) if fast else (1, 2, 3))]
    return rows


def static_cross_check(routing, faults, topo, fast=False):
    """benchmarks/fig11_faults.py's `static_cross_check`, printing aside."""
    rows = fig11_schedules(faults, topo, fast)
    slices = range(0, topo.num_slices, 8 if fast else 4)
    out = {label: routing.connectivity_loss(topo, s.to_failure_set(), slices)
           for label, s in rows if not s.is_empty}
    base = routing.path_stretch(
        topo, faults.FailureSchedule.empty(topo).to_failure_set(),
        list(slices)[:4])
    link = next(s for label, s in rows if label.startswith("links"))
    st = routing.path_stretch(topo, link.to_failure_set(), list(slices)[:4])
    out["stretch"] = dict(baseline_mean_path=base["mean_path"],
                          failed_mean_path=st["mean_path"])
    return out


def _topos(n, u, seed):
    j = build_opera_topology(n, u, seed=seed)
    return j, topology_from_arrays(n, u, np.asarray(j.switch_matchings), 1)


@pytest.fixture(scope="module")
def small():
    return _topos(8, 2, 0)


@pytest.fixture(scope="module")
def fig11():
    arr = np.load(FIG11_TOPO)
    jtopo = JTopology(num_racks=108, num_switches=6, switch_matchings=tuple(
        tuple(m.astype(np.int64) for m in sw) for sw in arr), groups=1)
    return jtopo, topology_from_arrays(108, 6, arr, groups=1)


def _failure_sets(topo):
    """A link, ToR, switch and uplink failure, each alone and together."""
    n = topo.num_racks
    cases = [dict(), dict(links={(0, 1), (2, n - 1)}), dict(tors={3}),
             dict(switches={1}), dict(uplinks={(0, 0), (5, 1)})]
    cases.append({k: v for c in cases for k, v in c.items()})
    return cases


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, float):
        assert np.isclose(a, b, rtol=1e-12, atol=1e-12) or a == b, (a, b)
    else:
        assert a == b, (a, b)


class TestRouting:
    @pytest.mark.parametrize("case", range(6))
    def test_slice_adjacency_and_routes(self, small, case):
        jtopo, ttopo = small
        kw = _failure_sets(ttopo)[case]
        jfs, tfs = jrouting.FailureSet(**kw), trouting.FailureSet(**kw)
        for t in range(ttopo.num_slices):
            a = trouting.slice_adjacency(ttopo, t, tfs)
            np.testing.assert_array_equal(
                a, jrouting.slice_adjacency(jtopo, t, jfs))
            for x, y in zip(trouting.bfs_next_hop(a), jrouting.bfs_next_hop(a)):
                np.testing.assert_array_equal(x, y)
        for r, q in zip(trouting.compute_routes(ttopo, tfs),
                        jrouting.compute_routes(jtopo, jfs)):
            assert r.slice_id == q.slice_id
            assert r.disconnected_pairs == q.disconnected_pairs
            np.testing.assert_array_equal(r.next_hop, q.next_hop)
        _assert_equal(trouting.connectivity_loss(ttopo, tfs),
                      jrouting.connectivity_loss(jtopo, jfs))
        _assert_equal(trouting.path_stretch(ttopo, tfs, [0, 1, 2]),
                      jrouting.path_stretch(jtopo, jfs, [0, 1, 2]))

    def test_failure_set_views(self):
        kw = dict(links={(3, 1), (0, 2)}, tors={5, 2}, switches={1, 0},
                  uplinks={(4, 1), (1, 0)})
        t, j = trouting.FailureSet(**kw), jrouting.FailureSet(**kw)
        for f in ("sorted_links", "sorted_tors", "sorted_switches",
                  "sorted_uplinks"):
            assert getattr(t, f) == getattr(j, f)
        assert t.link_failed(2, 0) and t.uplink_failed(4, 1)

    def test_ruleset_size(self):
        for n in (108, 216, 432, 648, 1200):
            assert trouting.ruleset_size(n) == jrouting.ruleset_size(n)
            assert trouting.ruleset_size(n, 6) == jrouting.ruleset_size(n, 6)


class TestExpander:
    def test_slice_diagnostics(self, small, fig11):
        for jtopo, ttopo in (small, fig11):
            slices = range(0, ttopo.num_slices, 9)
            _assert_equal(texpander.slice_report(ttopo, slices),
                          jexpander.slice_report(jtopo, slices))
            adj = ttopo.adjacency(1)
            np.testing.assert_array_equal(texpander.hop_distances(adj),
                                          jexpander.hop_distances(adj))
            _assert_equal(texpander.path_length_cdf(adj),
                          jexpander.path_length_cdf(adj))
            _assert_equal(texpander.mean_max_path(adj),
                          jexpander.mean_max_path(adj))
            np.testing.assert_array_equal(texpander.degree(adj),
                                          jexpander.degree(adj))

    def test_static_networks(self):
        for d in (1, 6, 7, 12):
            assert texpander.ramanujan_bound(d) == jexpander.ramanujan_bound(d)
        for n in (108, 216, 648):
            assert (texpander.folded_clos_tor_hops(n)
                    == jexpander.folded_clos_tor_hops(n))
        # the port's matching search may draw otherwise at large N (T1);
        # at 16 nodes both packages draw the same graph
        a = texpander.random_regular_expander(16, 3, seed=0)
        np.testing.assert_array_equal(
            a, jexpander.random_regular_expander(16, 3, seed=0))
        assert texpander.spectral_gap(a) == jexpander.spectral_gap(a)
        assert texpander.spectral_gap(np.zeros((4, 4), bool)) == 0.0


class TestClassify:
    def test_classifier(self):
        t, j = tclassify.Classifier(), jclassify.Classifier()
        assert t.bulk_cutoff_bytes == j.bulk_cutoff_bytes
        for size in (0, 10**5, 15 * 2**20 - 1, 15 * 2**20, 10**9):
            assert t.classify(size).value == j.classify(size).value
            assert (t.classify(size, tclassify.TrafficClass.LATENCY).value
                    == "latency")
        assert [c.value for c in tclassify.TrafficClass] == \
            [c.value for c in jclassify.TrafficClass]
        for hops in (0, 1, 2, 3.1):
            assert tclassify.bandwidth_tax(hops) == jclassify.bandwidth_tax(hops)
        assert (tclassify.effective_tax_rate(0.04, 3.1)
                == jclassify.effective_tax_rate(0.04, 3.1))


class TestFig11Static:
    def test_to_failure_set(self, fig11):
        """Every Fig. 11 schedule, full and fast, gives the same failure
        set in both packages."""
        jtopo, ttopo = fig11
        for fast in (False, True):
            for (label, j), (_, t) in zip(
                    fig11_schedules(jfaults, jtopo, fast),
                    fig11_schedules(tfaults, ttopo, fast)):
                a, b = t.to_failure_set(), j.to_failure_set()
                assert dataclasses.asdict(a) == dataclasses.asdict(b), label
                assert isinstance(a, trouting.FailureSet)
        assert tfaults.FailureSchedule.empty(ttopo).to_failure_set() == \
            trouting.FailureSet()

    def test_port_cross_check_equals_stored(self, fig11):
        """What chip_smoke.py's fig11_tiled checks, full and fast."""
        _, ttopo = fig11
        want = json.loads(FIG11_STATIC.read_text())
        _assert_equal(static_cross_check(trouting, tfaults, ttopo),
                      want["full"])
        fast = static_cross_check(trouting, tfaults, ttopo, fast=True)
        _assert_equal(fast, want["fast"])
        # results/benchmarks/fig11_faults.json's static block is the
        # JAX package's --fast run
        stored = json.loads(FIG11_FAST.read_text())["static"]
        _assert_equal(fast, {k: stored[k] for k in fast})

    def test_stored_cross_check_is_current(self, fig11):
        jtopo, _ = fig11
        want = json.loads(FIG11_STATIC.read_text())
        for fast in (False, True):
            _assert_equal(static_cross_check(jrouting, jfaults, jtopo, fast),
                          want["fast" if fast else "full"])


if __name__ == "__main__":
    arr = np.load(FIG11_TOPO)
    topo = JTopology(num_racks=108, num_switches=6, switch_matchings=tuple(
        tuple(m.astype(np.int64) for m in sw) for sw in arr), groups=1)
    expected = dict(
        topology=FIG11_TOPO.name, stride=dict(full=4, fast=8),
        full=static_cross_check(jrouting, jfaults, topo),
        fast=static_cross_check(jrouting, jfaults, topo, fast=True))
    FIG11_STATIC.write_text(json.dumps(expected, indent=1) + "\n")
    print(f"wrote {FIG11_STATIC.name}", file=sys.stderr)

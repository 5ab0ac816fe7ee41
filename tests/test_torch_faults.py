"""Fault injection and paced demand in the PyTorch fluid engines, on the CPU.

The same schedules and demands (numpy, from seeds) go through the JAX
package and the port: `repro_torch.netsim.faults` against
`repro.netsim.faults` bit for bit, the faulted dense and sparse steps
slice by slice against the float64 oracle `fluid.rotor_slice_step_faulted`
(state atol 1e-5, tests/test_netsim_jax.py), and the engines end to end
against the JAX engines and the oracle at tests/test_netsim_faults.py's
tolerances: finished_frac atol 5e-5, blackholed bytes rtol 1e-4 and atol
1 byte against the oracle.  The topology is the JAX package's 8-rack k4
one, carried across with `topology_from_arrays`.

Blackholed bytes are held to the oracle, not to the JAX dense engine,
whose `attempted - delivered` cancels in float32 (ROADMAP R1): at
``detect_lag=0`` the oracle and both port engines give exactly 0.0.
"""
import numpy as np
import pytest
import torch

from repro.core.schedule import cycle_timing, slice_capacity_bytes
from repro.core.topology import build_opera_topology
from repro.netsim import faults as jfaults
from repro.netsim import fluid_jax
from repro.netsim.fluid import (
    rotor_slice_step_faulted,
    simulate_rotor_bulk,
)
from repro.netsim.sweep import DesignPoint as JDesignPoint
from repro.netsim.sweep import scenario_demand
from repro_torch.core.topology import topology_from_arrays
from repro_torch.netsim import faults as tfaults
from repro_torch.netsim import fluid_torch
from repro_torch.netsim.sweep import DesignPoint

ENGINES = ("dense", "sparse")
MASK_FIELDS = ("switch_id", "pair_switch", "up_onset", "up_detect",
               "up_recover", "tor_onset", "tor_detect", "tor_recover")


def _carry(topo):
    return topology_from_arrays(topo.num_racks, topo.num_switches,
                                np.asarray(topo.switch_matchings), topo.groups)


@pytest.fixture(scope="module")
def jtopo():
    return build_opera_topology(8, 2, seed=0)


@pytest.fixture(scope="module")
def topo(jtopo):
    return _carry(jtopo)


@pytest.fixture(scope="module")
def cfg():
    return DesignPoint(k=4, num_racks=8).to_config()


@pytest.fixture(scope="module")
def jcfg():
    return JDesignPoint(k=4, num_racks=8).to_config()


@pytest.fixture(scope="module")
def demand(jcfg):
    cap = slice_capacity_bytes(jcfg, cycle_timing(jcfg))
    d = np.full((jcfg.num_racks, jcfg.num_racks), 1.5 * cap)
    np.fill_diagonal(d, 0.0)
    return d


def _draws(faults, topo):
    """tests/test_netsim_faults.py's four schedule kinds, drawn by
    `faults` (either package's module) on `topo`."""
    S = topo.num_slices
    kw = dict(onset_step=S, detect_lag=3)
    return [
        ("links", faults.FailureSchedule.draw(topo, seed=5, link_frac=0.15,
                                              **kw)),
        ("tors", faults.FailureSchedule.draw(topo, seed=6, tor_frac=0.15,
                                             recover_step=4 * S, **kw)),
        ("switch", faults.FailureSchedule.draw(topo, seed=7, switch_count=1,
                                               **kw)),
        ("mixed", faults.FailureSchedule.draw(topo, seed=8, link_frac=0.1,
                                              tor_frac=0.12, switch_count=1,
                                              **kw)),
    ]


def _as_events(sched):
    return [(e.kind, e.ids, e.onset_step, e.detect_lag, e.recover_step)
            for e in sched.events]


# ---------------------------------------------------------------------------
# the copied schedule module equals the reference's
# ---------------------------------------------------------------------------


class TestScheduleCopy:
    def test_draws_equal(self, jtopo, topo):
        for (label, j), (_, t) in zip(_draws(jfaults, jtopo),
                                      _draws(tfaults, topo)):
            assert _as_events(t) == _as_events(j), label
            assert (t.seed, t.num_racks, t.num_switches) == (
                j.seed, j.num_racks, j.num_switches)

    def test_live_uplinks_and_switch_ids_equal(self, jtopo, topo):
        assert tfaults.live_uplinks(topo) == jfaults.live_uplinks(jtopo)
        np.testing.assert_array_equal(tfaults.switch_id_tensor(topo),
                                      jfaults.switch_id_tensor(jtopo))

    def test_compiled_masks_equal(self, jtopo, topo):
        j = jfaults.compile_fault_masks(
            jtopo, [s for _, s in _draws(jfaults, jtopo)])
        t = tfaults.compile_fault_masks(
            topo, [s for _, s in _draws(tfaults, topo)])
        for f in MASK_FIELDS:
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f), f)
        one = tfaults.compile_fault_masks(topo, _draws(tfaults, topo)[3][1])
        wide = one.broadcast_to(3)
        assert wide.batch_size == 3
        np.testing.assert_array_equal(wide.up_onset[2], one.up_onset[0])
        with pytest.raises(ValueError):
            t.broadcast_to(2)

    def test_step_masks_equal(self, jtopo, topo):
        j = jfaults.compile_fault_masks(
            jtopo, [s for _, s in _draws(jfaults, jtopo)])
        t = tfaults.compile_fault_masks(
            topo, [s for _, s in _draws(tfaults, topo)])
        S = topo.num_slices
        for b in range(4):
            for g in (0, S, S + 2, S + 3, 3 * S + 5, 4 * S, 6 * S):
                for a, c in zip(tfaults.step_masks(t, b, g, g % S),
                                jfaults.step_masks(j, b, g, g % S)):
                    np.testing.assert_array_equal(a, c)

    def test_masked_tensor_equal(self, jtopo, topo):
        for (_, j), (_, t) in zip(_draws(jfaults, jtopo),
                                  _draws(tfaults, topo)):
            np.testing.assert_array_equal(tfaults.masked_tensor(topo, t),
                                          jfaults.masked_tensor(jtopo, j))

    def test_schedule_validation(self, topo):
        with pytest.raises(ValueError):
            tfaults.FailureEvent("cable", (1,), onset_step=0)
        with pytest.raises(ValueError):
            tfaults.FailureEvent("tor", (1,), onset_step=5, recover_step=5)
        with pytest.raises(ValueError):
            tfaults.compile_fault_masks(
                topo, tfaults.FailureSchedule(num_racks=4, num_switches=2))
        empty = tfaults.FailureSchedule.empty(topo)
        assert empty.is_empty and not _draws(tfaults, topo)[0][1].is_empty


# ---------------------------------------------------------------------------
# faulted steps, slice by slice, against the float64 oracle
# ---------------------------------------------------------------------------


def _timelines(masks):
    return tuple(torch.as_tensor(a) for a in (
        masks.up_onset, masks.up_detect, masks.up_recover,
        masks.tor_onset, masks.tor_detect, masks.tor_recover))


class TestFaultedSteps:
    @pytest.mark.parametrize("vlb", [False, True])
    @pytest.mark.parametrize("engine", ENGINES)
    def test_steps_match_oracle(self, topo, engine, vlb):
        """Each row carries its own draw; both sides advance their own
        state from the same start through 4 cycles, which cover the
        blackhole, detected and recovered windows."""
        scheds = [s for _, s in _draws(tfaults, topo)]
        masks = tfaults.compile_fault_masks(topo, scheds)
        B, n, S = len(scheds), topo.num_racks, topo.num_slices
        rng = np.random.default_rng(1)
        own = rng.uniform(0.0, 3.0, (B, n, n))
        relay = rng.uniform(0.0, 1.0, (B, n, n))
        for a in (own, relay):
            a[:, np.arange(n), np.arange(n)] = 0.0
        adj = topo.matching_tensor().astype(np.float64)
        dst = torch.as_tensor(topo.matching_index_tensor())
        sw = torch.as_tensor(masks.switch_id).long()
        pair_sw = torch.as_tensor(masks.pair_switch).long()
        tl = _timelines(masks)
        t_own = torch.as_tensor(own, dtype=torch.float32)
        t_relay = torch.as_tensor(relay, dtype=torch.float32)
        blackholed_any = 0.0
        for g in range(4 * S):
            sl = g % S
            if engine == "dense":
                t_own, t_relay, d, m, bh = fluid_torch._slice_step_faulted(
                    t_own, t_relay, torch.as_tensor(adj[sl], dtype=torch.float32),
                    sw[sl], pair_sw, g, tl, vlb)
            else:
                t_own, t_relay, d, m, bh = (
                    fluid_torch._sparse_slice_step_faulted(
                        t_own, t_relay, dst[sl], pair_sw, g, tl, vlb))
            for b in range(B):
                own[b], relay[b], od, om, obh = rotor_slice_step_faulted(
                    own[b], relay[b], adj[sl],
                    *tfaults.step_masks(masks, b, g, sl), vlb=vlb)
                np.testing.assert_allclose(t_own[b].numpy(), own[b],
                                           atol=1e-5, err_msg=f"own {g} {b}")
                np.testing.assert_allclose(t_relay[b].numpy(), relay[b],
                                           atol=1e-5, err_msg=f"relay {g} {b}")
                assert np.isclose(float(d[b]), od, rtol=1e-5, atol=1e-5)
                assert np.isclose(float(bh[b]), obh, rtol=1e-5, atol=1e-5)
                if vlb:
                    assert np.isclose(float(m[b]), om, rtol=1e-5, atol=1e-5)
                blackholed_any += obh
        assert blackholed_any > 0.0, "the draws must blackhole something"


# ---------------------------------------------------------------------------
# engines end to end against the JAX engines and the oracle
# ---------------------------------------------------------------------------


class TestEngines:
    @pytest.mark.parametrize("engine", ENGINES)
    def test_parity_per_schedule_kind(self, jtopo, topo, jcfg, cfg, demand,
                                      engine):
        jrows = _draws(jfaults, jtopo)
        trows = _draws(tfaults, topo)
        dem = np.broadcast_to(demand, (len(trows),) + demand.shape)
        got = fluid_torch.simulate_rotor_bulk_batch(
            cfg, dem, topo=topo, max_cycles=6, faults=[s for _, s in trows],
            engine=engine, device="cpu")
        ref = fluid_jax.simulate_rotor_bulk_batch(
            jcfg, dem, topo=jtopo, max_cycles=6,
            faults=[s for _, s in jrows], engine=engine)
        np.testing.assert_allclose(got.finished_frac, ref.finished_frac,
                                   atol=5e-5)
        np.testing.assert_array_equal(got.slices_run, ref.slices_run)
        for i, (label, sched) in enumerate(jrows):
            o = simulate_rotor_bulk(jcfg, demand, topo=jtopo, max_cycles=6,
                                    faults=sched)
            T = o.slices_run
            np.testing.assert_allclose(got.finished_frac[i, :T],
                                       o.finished_frac, atol=5e-5,
                                       err_msg=label)
            assert np.isclose(got.blackholed_bytes[i], o.blackholed_bytes,
                              rtol=1e-4, atol=1.0), label
            assert o.blackholed_bytes > 0.0, label

    @pytest.mark.parametrize("engine", ENGINES)
    def test_paced_parity(self, jtopo, topo, jcfg, cfg, demand, engine):
        jsched = jfaults.FailureSchedule.draw(
            jtopo, seed=5, switch_count=1, onset_step=jtopo.num_slices,
            detect_lag=3)
        tsched = tfaults.FailureSchedule.draw(
            topo, seed=5, switch_count=1, onset_step=topo.num_slices,
            detect_lag=3)
        o = simulate_rotor_bulk(jcfg, demand, topo=jtopo, max_cycles=8,
                                faults=jsched, paced_cycles=4)
        got = fluid_torch.simulate_rotor_bulk_batch(
            cfg, demand, topo=topo, max_cycles=8, faults=tsched,
            paced_cycles=4, engine=engine, device="cpu")
        ref = fluid_jax.simulate_rotor_bulk_batch(
            jcfg, demand, topo=jtopo, max_cycles=8, faults=[jsched],
            paced_cycles=4, engine=engine)
        np.testing.assert_allclose(got.finished_frac[0, :o.slices_run],
                                   o.finished_frac, atol=5e-5)
        np.testing.assert_allclose(got.finished_frac, ref.finished_frac,
                                   atol=5e-5)
        assert np.isclose(got.blackholed_bytes[0], o.blackholed_bytes,
                          rtol=1e-4, atol=1.0)

    @pytest.mark.parametrize("engine", ENGINES)
    def test_paced_without_faults(self, jtopo, topo, jcfg, cfg, demand,
                                  engine):
        """Pacing alone runs the faulted program with all-live masks."""
        got = fluid_torch.simulate_rotor_bulk_batch(
            cfg, demand, topo=topo, max_cycles=6, paced_cycles=3,
            engine=engine, device="cpu")
        ref = fluid_jax.simulate_rotor_bulk_batch(
            jcfg, demand, topo=jtopo, max_cycles=6, paced_cycles=3,
            engine=engine)
        np.testing.assert_allclose(got.finished_frac, ref.finished_frac,
                                   atol=5e-5)
        assert float(got.blackholed_bytes[0]) == 0.0

    @pytest.mark.parametrize("vlb", [False, True])
    @pytest.mark.parametrize("g", [1, 2])
    def test_engines_agree_on_k8_n16(self, g, vlb):
        """tests/test_rotor_slice.py's faulted engine parity (a link
        event and a ToR event that both recover), port dense and sparse
        against each other and the JAX engines."""
        jcfg = JDesignPoint(k=8, num_racks=16, groups=g).to_config()
        cfg = DesignPoint(k=8, num_racks=16, groups=g).to_config()
        jtopo = build_opera_topology(16, 4, seed=0, groups=g)
        topo = _carry(jtopo)
        events = [("link", ((1, 0), (5, 1)), 1, 2, 10),
                  ("tor", (3,), 2, 1, 12)]

        def sched(mod):
            return mod.FailureSchedule(
                num_racks=16, num_switches=4, events=tuple(
                    mod.FailureEvent(k, ids, onset_step=o, detect_lag=lag,
                                     recover_step=r)
                    for k, ids, o, lag, r in events))

        dem = np.stack([scenario_demand("permutation", jcfg, 0.5, s)
                        for s in range(2)])
        total = dem.sum((1, 2))
        got = {e: fluid_torch.simulate_rotor_bulk_batch(
            cfg, dem, vlb=vlb, max_cycles=10, topo=topo,
            faults=sched(tfaults), engine=e, device="cpu") for e in ENGINES}
        for e in ENGINES:
            ref = fluid_jax.simulate_rotor_bulk_batch(
                jcfg, dem, vlb=vlb, max_cycles=10, topo=jtopo,
                faults=sched(jfaults), engine=e)
            for f in ("goodput_bytes", "wire_bytes", "residual_bytes"):
                np.testing.assert_allclose(getattr(got[e], f),
                                           getattr(ref, f), rtol=1e-4,
                                           atol=1e-6 * total.max(),
                                           err_msg=f"{e} {f}")
            np.testing.assert_allclose(got[e].blackholed_bytes,
                                       ref.blackholed_bytes,
                                       atol=1e-6 * total.max())
        for f in ("goodput_bytes", "wire_bytes", "residual_bytes"):
            np.testing.assert_allclose(getattr(got["dense"], f),
                                       getattr(got["sparse"], f), rtol=1e-5)
        bh_d, bh_s = got["dense"].blackholed_bytes, got["sparse"].blackholed_bytes
        if vlb:
            assert bh_d.max() > 0, "schedule must blackhole something"
        assert float(np.max(np.abs(bh_d - bh_s) / total)) < 1e-6

    @pytest.mark.parametrize("engine", ENGINES)
    def test_masks_taken_as_given(self, topo, cfg, demand, engine):
        """Compiled `FaultMasks` of one row broadcast over the batch, and
        the same schedule shared by every row, give the same run."""
        sched = _draws(tfaults, topo)[3][1]
        dem = np.stack([demand, 0.5 * demand])
        a = fluid_torch.simulate_rotor_bulk_batch(
            cfg, dem, topo=topo, max_cycles=4, engine=engine, device="cpu",
            faults=tfaults.compile_fault_masks(topo, sched))
        b = fluid_torch.simulate_rotor_bulk_batch(
            cfg, dem, topo=topo, max_cycles=4, engine=engine, device="cpu",
            faults=sched)
        np.testing.assert_array_equal(a.finished_frac, b.finished_frac)
        np.testing.assert_array_equal(a.blackholed_bytes, b.blackholed_bytes)


class TestEmptyBitIdentity:
    @pytest.mark.parametrize("engine", ENGINES)
    def test_empty_schedule_is_faults_none(self, topo, cfg, demand, engine):
        dem = np.stack([demand, 0.3 * demand])
        clean = fluid_torch.simulate_rotor_bulk_batch(
            cfg, dem, topo=topo, max_cycles=6, engine=engine, device="cpu")
        empty = tfaults.FailureSchedule.empty(topo)
        for faults in (empty, [empty, empty]):
            r = fluid_torch.simulate_rotor_bulk_batch(
                cfg, dem, topo=topo, max_cycles=6, engine=engine,
                device="cpu", faults=faults)
            for f in ("finished_frac", "wire_bytes", "goodput_bytes",
                      "residual_bytes", "fct_99_ms", "slices_run"):
                np.testing.assert_array_equal(getattr(r, f),
                                              getattr(clean, f), f)
            assert r.blackholed_bytes is None


class TestBlackholeWindow:
    @pytest.mark.parametrize("engine", ENGINES)
    def test_zero_lag_means_zero_blackhole(self, jtopo, topo, jcfg, cfg,
                                           demand, engine):
        """R1: the oracle gives exactly 0.0 at detect_lag=0, and so do
        both port engines (the JAX dense engine's `attempted -
        delivered` gives -0.0158 here)."""
        jsched = jfaults.FailureSchedule.draw(jtopo, seed=4, link_frac=0.2,
                                              onset_step=2, detect_lag=0)
        o = simulate_rotor_bulk(jcfg, demand, topo=jtopo, max_cycles=6,
                                faults=jsched)
        assert o.blackholed_bytes == 0.0
        sched = tfaults.FailureSchedule.draw(topo, seed=4, link_frac=0.2,
                                             onset_step=2, detect_lag=0)
        for vlb in (True, False):
            r = fluid_torch.simulate_rotor_bulk_batch(
                cfg, demand, vlb=vlb, topo=topo, max_cycles=6, faults=[sched],
                engine=engine, device="cpu")
            assert float(r.blackholed_bytes[0]) == 0.0, vlb

    @pytest.mark.parametrize("engine", ENGINES)
    def test_detection_lag_blackholes_as_the_oracle(self, jtopo, topo, jcfg,
                                                    cfg, demand, engine):
        jsched = jfaults.FailureSchedule.draw(jtopo, seed=4, link_frac=0.2,
                                              onset_step=2, detect_lag=4)
        o = simulate_rotor_bulk(jcfg, demand, topo=jtopo, max_cycles=6,
                                faults=jsched)
        sched = tfaults.FailureSchedule.draw(topo, seed=4, link_frac=0.2,
                                             onset_step=2, detect_lag=4)
        r = fluid_torch.simulate_rotor_bulk_batch(
            cfg, demand, topo=topo, max_cycles=6, faults=sched,
            engine=engine, device="cpu")
        assert o.blackholed_bytes > 0.0
        assert np.isclose(r.blackholed_bytes[0], o.blackholed_bytes,
                          rtol=1e-4, atol=1.0)

    @pytest.mark.parametrize("engine", ENGINES)
    def test_demand_is_conserved(self, topo, cfg, demand, engine):
        """Lost-in-flight bytes re-queue at the source, so delivered plus
        residual accounts for all the demand."""
        sched = tfaults.FailureSchedule.draw(topo, seed=8, link_frac=0.1,
                                             tor_frac=0.12, switch_count=1,
                                             onset_step=2, detect_lag=3)
        r = fluid_torch.simulate_rotor_bulk_batch(
            cfg, demand[None], topo=topo, max_cycles=4, faults=[sched],
            engine=engine, device="cpu")
        total = float(r.total_bytes[0])
        gap = abs(float(r.goodput_bytes[0]) + float(r.residual_bytes[0])
                  - total)
        assert gap < 1e-5 * total
        assert float(r.blackholed_bytes[0]) > 0.0

    def test_two_run_determinism(self, topo, cfg, demand):
        sched = tfaults.FailureSchedule.draw(topo, seed=9, link_frac=0.2,
                                             onset_step=2, detect_lag=2)
        r1, r2 = (fluid_torch.simulate_rotor_bulk_batch(
            cfg, demand[None], topo=topo, max_cycles=6, faults=[sched],
            device="cpu") for _ in range(2))
        assert np.array_equal(r1.finished_frac, r2.finished_frac)
        assert np.array_equal(r1.blackholed_bytes, r2.blackholed_bytes)

    def test_single_scenario_api_carries_blackholed(self, topo, cfg, demand):
        sched = tfaults.FailureSchedule.draw(topo, seed=4, link_frac=0.2,
                                             onset_step=2, detect_lag=4)
        one = fluid_torch.simulate_rotor_bulk_torch(
            cfg, demand, topo=topo, max_cycles=6, faults=sched, device="cpu")
        batch = fluid_torch.simulate_rotor_bulk_batch(
            cfg, demand, topo=topo, max_cycles=6, faults=sched, device="cpu")
        assert one.blackholed_bytes == float(batch.blackholed_bytes[0]) > 0.0


def test_rebased_flow_projection_equal(jtopo, topo):
    """`apply_flow_faults` on the same scenario arrays: equal windows
    and scales (the flow engines' tests use the port's projection)."""
    from repro.netsim.flows import build_scenario as jbuild
    from repro_torch.netsim.flows import build_scenario as tbuild

    kw = dict(num_hosts=16, horizon_s=0.12, dt_s=5e-4, tail_s=0.1, seed=0)
    jscn = jbuild("opera", "websearch", 0.12, **kw)
    tscn = tbuild("opera", "websearch", 0.12, **kw)
    for (_, j), (_, t) in zip(_draws(jfaults, jtopo), _draws(tfaults, topo)):
        jf = jfaults.apply_flow_faults(jscn, j)
        tf = tfaults.apply_flow_faults(tscn, t)
        for f in ("blk_start", "blk_end", "frz_start", "frz_end",
                  "lat_scale", "bulk_scale"):
            np.testing.assert_array_equal(getattr(tf, f), getattr(jf, f), f)
        for a, b in zip(tfaults.flow_fault_arrays(tf, tf.steps),
                        jfaults.flow_fault_arrays(jf, jf.steps)):
            np.testing.assert_array_equal(a, b)
    assert tfaults.apply_flow_faults(
        tscn, tfaults.FailureSchedule.empty(topo)) is tscn


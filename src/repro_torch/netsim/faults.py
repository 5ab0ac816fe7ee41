"""Seeded, time-indexed fault injection for the batched netsim engines.

Copy of `repro.netsim.faults` (numpy only); keep the two in step.  A
`FailureSchedule` is a seeded list of `FailureEvent`s, each failing a
set of physical components at an onset step, becoming *detected*
``detect_lag`` steps later and optionally recovering.
`compile_fault_masks` lowers a batch of schedules onto the physical
uplink grid ``(rack, switch)`` as int32 onset/detect/recover timelines;
the fluid engines rebuild the per-step 0/1 masks from them on the
device by comparisons on the global step (`step_masks` is the numpy
reference of that math).  `apply_flow_faults` projects a schedule onto
a `flows.FlowScenario` as per-flow blackhole/frozen windows and
per-step pool scales.

Mask semantics (fluid and flow engines alike):

* **blackhole window** ``[onset, detect)``: the component is dead but
  senders do not know; bytes committed to it are lost in flight, stay
  queued at the source and count as ``blackholed``;
* **detected window** ``[detect, recover)``: the component is masked
  out of the offered capacity; direct traffic re-queues, VLB spreads
  only over live room, flows behind a failed ToR freeze;
* **recovery** at ``recover_step``: masks lift, frozen traffic retries.

`FailureSchedule.empty()` dispatches to the failure-free engine paths,
so it is bit-identical to running without faults.
`FailureSchedule.to_failure_set` gives the static `core.routing` view of
a schedule for the connectivity and stretch cross-checks.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.topology import OperaTopology

NEVER = np.int32(2**31 - 1)      # onset/recover sentinel: "not in this run"
DEFAULT_DETECT_LAG = 3           # steps (slices) until hello protocol notices

KINDS = ("link", "tor", "switch")


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One failure: a set of same-kind components with a common timeline.

    ``ids`` are ``(rack, switch)`` uplink pairs for kind="link", rack ids
    for kind="tor", switch ids for kind="switch" — always stored sorted
    so iteration order never depends on set hashing.
    """

    kind: str
    ids: Tuple
    onset_step: int
    detect_lag: int = DEFAULT_DETECT_LAG
    recover_step: Optional[int] = None    # None = never recovers

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"kind {self.kind!r} not in {KINDS}")
        object.__setattr__(self, "ids", tuple(sorted(self.ids)))
        if self.recover_step is not None and self.recover_step <= self.onset_step:
            raise ValueError("recover_step must be > onset_step")

    @property
    def detect_step(self) -> int:
        return self.onset_step + self.detect_lag

    @property
    def recover(self) -> int:
        return int(NEVER) if self.recover_step is None else self.recover_step


@dataclasses.dataclass(frozen=True)
class FailureSchedule:
    """A reproducible, time-indexed failure draw for one design point.

    Step units are the consuming engine's steps (topology slices for the
    fluid pair, dt ticks for the flow pair); the schedule itself is
    unit-agnostic.  ``seed`` records the draw for provenance — two
    `draw()` calls with equal arguments produce equal schedules.
    """

    num_racks: int
    num_switches: int
    events: Tuple[FailureEvent, ...] = ()
    seed: Optional[int] = None

    @classmethod
    def empty(cls, topo: OperaTopology) -> "FailureSchedule":
        """The no-failure schedule: compiles to all-live masks and is
        bit-identical to the failure-free engine paths."""
        return cls(num_racks=topo.num_racks, num_switches=topo.num_switches)

    @property
    def is_empty(self) -> bool:
        """True when the schedule carries no events.  The engines use
        this to dispatch to the failure-free program, which is what
        makes `empty()` *bit*-identical to it (the faulted step agrees
        under empty masks only to the last f32 ulp, since it sums in
        another grouping)."""
        return not self.events

    @classmethod
    def draw(
        cls,
        topo: OperaTopology,
        seed: int,
        link_frac: float = 0.0,
        tor_frac: float = 0.0,
        switch_count: int = 0,
        onset_step: int = 0,
        detect_lag: int = DEFAULT_DETECT_LAG,
        recover_step: Optional[int] = None,
    ) -> "FailureSchedule":
        """Seeded draw: `link_frac` of the topology's *realized* uplinks
        (never a non-edge — the Fig. 11 sampler contract), `tor_frac` of
        racks, and the `switch_count` lowest-id rotor switches."""
        rng = np.random.default_rng(seed)
        events: List[FailureEvent] = []
        kw = dict(onset_step=onset_step, detect_lag=detect_lag,
                  recover_step=recover_step)
        if link_frac > 0:
            ups = live_uplinks(topo)
            k = max(1, int(round(link_frac * len(ups))))
            sel = rng.choice(len(ups), size=min(k, len(ups)), replace=False)
            events.append(FailureEvent(
                "link", tuple(ups[i] for i in sorted(sel)), **kw))
        if tor_frac > 0:
            k = max(1, int(round(tor_frac * topo.num_racks)))
            tors = rng.choice(topo.num_racks, size=k, replace=False)
            events.append(FailureEvent("tor", tuple(int(t) for t in tors), **kw))
        if switch_count > 0:
            events.append(FailureEvent(
                "switch", tuple(range(min(switch_count, topo.num_switches))),
                **kw))
        return cls(num_racks=topo.num_racks, num_switches=topo.num_switches,
                   events=tuple(events), seed=seed)

    def to_failure_set(self):
        """Steady-state (all events, time ignored) view for the static
        connectivity/stretch cross-checks in `repro_torch.core.routing`."""
        from repro_torch.core.routing import FailureSet

        fs = FailureSet()
        for ev in self.events:
            if ev.kind == "link":
                fs.uplinks.update((int(r), int(s)) for r, s in ev.ids)
            elif ev.kind == "tor":
                fs.tors.update(int(t) for t in ev.ids)
            else:
                fs.switches.update(int(s) for s in ev.ids)
        return fs


def live_uplinks(topo: OperaTopology) -> List[Tuple[int, int]]:
    """The design's realized physical ``(rack, switch)`` uplinks, sorted.

    An uplink exists iff some matching of switch s gives rack r a
    partner (self-loop-only assignments use no fiber).  For the paper's
    k12-n108 point this is the full N*u = 648 grid."""
    idx = np.arange(topo.num_racks)
    ups = set()
    for s in range(topo.num_switches):
        for p in topo.switch_matchings[s]:
            for r in idx[p != idx]:
                ups.add((int(r), int(s)))
    return sorted(ups)


def switch_id_tensor(topo: OperaTopology) -> np.ndarray:
    """(num_slices, N, N) int32: the switch serving each live edge of
    `matching_tensor()`; the virtual always-alive id ``num_switches``
    marks non-edges.  Symmetric because matchings are involutions —
    design-time state, shared by the oracle and the JAX engine."""
    n, S = topo.num_racks, topo.num_switches
    idx = np.arange(n)
    out = np.full((topo.num_slices, n, n), S, np.int32)
    for t in range(topo.num_slices):
        for s, p in topo.live_matchings(t):
            mask = p != idx
            out[t, idx[mask], p[mask]] = s
    return out


@dataclasses.dataclass
class FaultMasks:
    """Compiled, batched fault timelines over the physical uplink grid.

    ``up_*`` are (B, N, S+1) int32 — column S is the virtual always-alive
    switch non-edges map to; ``tor_*`` are (B, N) int32.  A component is
    physically dead on ``[onset, recover)`` and *known* dead on
    ``[detect, recover)``; `NEVER` means "not in this run"."""

    switch_id: np.ndarray   # (num_slices, N, N) int32, shared per design
    pair_switch: np.ndarray  # (N, N) int32: the ONE switch serving a pair
    up_onset: np.ndarray    # (B, N, S+1)
    up_detect: np.ndarray
    up_recover: np.ndarray
    tor_onset: np.ndarray   # (B, N)
    tor_detect: np.ndarray
    tor_recover: np.ndarray

    @property
    def batch_size(self) -> int:
        return self.up_onset.shape[0]

    def broadcast_to(self, B: int) -> "FaultMasks":
        """Tile a batch-of-one mask set across B scenario rows."""
        if self.batch_size == B:
            return self
        if self.batch_size != 1:
            raise ValueError(
                f"cannot broadcast batch {self.batch_size} to {B}")

        def bc(a):
            return np.ascontiguousarray(
                np.broadcast_to(a, (B,) + a.shape[1:]))

        return FaultMasks(
            switch_id=self.switch_id,
            pair_switch=self.pair_switch,
            up_onset=bc(self.up_onset), up_detect=bc(self.up_detect),
            up_recover=bc(self.up_recover),
            tor_onset=bc(self.tor_onset), tor_detect=bc(self.tor_detect),
            tor_recover=bc(self.tor_recover),
        )


def compile_fault_masks(
    topo: OperaTopology,
    schedules: Union[FailureSchedule, Sequence[FailureSchedule]],
) -> FaultMasks:
    """Lower schedule(s) to the batched component-timeline arrays.

    Switch failures become whole uplink columns (every rack's fiber into
    that switch), so the engines need only one mask mechanism.  Events
    are applied in order; a later event on the same component overwrites
    the earlier timeline (deterministic — ids are stored sorted)."""
    if isinstance(schedules, FailureSchedule):
        schedules = [schedules]
    n, S = topo.num_racks, topo.num_switches
    B = len(schedules)
    up_onset = np.full((B, n, S + 1), NEVER, np.int32)
    up_detect = np.full((B, n, S + 1), NEVER, np.int32)
    up_recover = np.full((B, n, S + 1), NEVER, np.int32)
    tor_onset = np.full((B, n), NEVER, np.int32)
    tor_detect = np.full((B, n), NEVER, np.int32)
    tor_recover = np.full((B, n), NEVER, np.int32)
    for b, sched in enumerate(schedules):
        if sched.num_racks != n or sched.num_switches != S:
            raise ValueError(
                f"schedule geometry ({sched.num_racks}, {sched.num_switches})"
                f" != topology ({n}, {S})")
        for ev in sched.events:
            onset, detect, recover = ev.onset_step, ev.detect_step, ev.recover
            if ev.kind == "link":
                for r, s in ev.ids:
                    up_onset[b, r, s] = onset
                    up_detect[b, r, s] = detect
                    up_recover[b, r, s] = recover
            elif ev.kind == "switch":
                for s in ev.ids:
                    up_onset[b, :, s] = onset
                    up_detect[b, :, s] = detect
                    up_recover[b, :, s] = recover
            else:  # tor
                for r in ev.ids:
                    tor_onset[b, r] = onset
                    tor_detect[b, r] = detect
                    tor_recover[b, r] = recover
    switch_id = switch_id_tensor(topo)
    # Every pair's matchings live on exactly ONE switch (Opera's
    # round-robin assignment), so min over slices recovers it; the
    # virtual id S survives only for never-connected pairs.
    return FaultMasks(
        switch_id=switch_id,
        pair_switch=switch_id.min(axis=0),
        up_onset=up_onset, up_detect=up_detect, up_recover=up_recover,
        tor_onset=tor_onset, tor_detect=tor_detect, tor_recover=tor_recover,
    )


def step_masks(
    masks: FaultMasks, b: int, g: int, sl: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Numpy reference for the per-step mask math (batch row b, global
    step g, topology slice sl).  Returns float 0/1 arrays

      ``(e_real, e_known, tor_real, tor_known, pair_dead_known)``

    where an edge is *real*-dead if either endpoint's serving uplink or
    ToR is physically down, and *known*-dead once detected;
    ``pair_dead_known[m, j]`` flags pairs whose *entire* direct
    capacity (all slices — they share one serving switch) is known
    dead, the condition under which RotorLB forwards non-local traffic
    onward instead of waiting for a circuit that will not come.
    `fluid_torch._slice_step_faulted` implements identical math in
    torch — change the two together."""
    sw = masks.switch_id[sl % masks.switch_id.shape[0]]
    up_f = (g >= masks.up_onset[b]) & (g < masks.up_recover[b])
    up_k = (g >= masks.up_detect[b]) & (g < masks.up_recover[b])
    tor_f = (g >= masks.tor_onset[b]) & (g < masks.tor_recover[b])
    tor_k = (g >= masks.tor_detect[b]) & (g < masks.tor_recover[b])
    i_f = np.take_along_axis(up_f, sw, axis=1)
    i_k = np.take_along_axis(up_k, sw, axis=1)
    e_real = (i_f | i_f.T | tor_f[:, None] | tor_f[None, :]).astype(np.float64)
    e_known = (i_k | i_k.T | tor_k[:, None] | tor_k[None, :]).astype(np.float64)
    p_k = np.take_along_axis(up_k, masks.pair_switch, axis=1)
    pair_dead = (p_k | p_k.T | tor_k[:, None] | tor_k[None, :]).astype(np.float64)
    return (e_real, e_known, tor_f.astype(np.float64),
            tor_k.astype(np.float64), pair_dead)


def masked_tensor(
    topo: OperaTopology,
    schedule: FailureSchedule,
    step: Optional[int] = None,
    tensor: Optional[np.ndarray] = None,
) -> np.ndarray:
    """The post-detection capacity tensor at global step `step` (default:
    every event detected, nothing recovered): the matching tensor with
    known-dead edges and failed ToRs masked out."""
    if step is None:
        step = max((ev.detect_step for ev in schedule.events), default=0)
    masks = compile_fault_masks(topo, schedule)
    ten = (topo.matching_tensor() if tensor is None
           else np.asarray(tensor, np.float32))
    out = np.empty_like(ten)
    for sl in range(ten.shape[0]):
        _, e_known, tor_real, _, _ = step_masks(masks, 0, step, sl)
        out[sl] = (ten[sl] * (1.0 - e_known)
                   * (1.0 - tor_real)[:, None] * (1.0 - tor_real)[None, :])
    return out


# ---------------- flow-level projection -------------------------------------


def apply_flow_faults(scn, schedule: FailureSchedule,
                      assignment_seed: Optional[int] = None):
    """Project a schedule onto a `FlowScenario` (step unit: dt ticks).

    The flow engine has no rack geometry, so the projection assigns each
    flow a seeded (src rack, dst rack) pair plus one uplink choice per
    endpoint, then derives per-flow windows:

    * flows whose path crosses a component during its *blackhole* window
      keep consuming their pool share with zero progress (retransmits
      into the dead circuit) until detection;
    * flows behind a failed ToR are additionally *frozen* from detection
      to recovery — no share, no progress, retry afterwards;
    * detected capacity loss scales both pools by the surviving fabric
      fraction over ``[detect, recover)``.

    Returns a new FlowScenario (dataclasses.replace) with the six fault
    fields populated; an empty schedule returns `scn` unchanged, so the
    engines dispatch it to the original failure-free program and the
    no-op case stays bit-identical."""
    import dataclasses as _dc

    if not schedule.events:
        return scn
    n = scn.num_flows
    steps = scn.steps
    N, S = schedule.num_racks, schedule.num_switches
    seed = (assignment_seed if assignment_seed is not None
            else 1_000_003 * (schedule.seed or 0) + scn.seed + 17)
    rng = np.random.default_rng(seed)
    src = rng.integers(0, N, n)
    dst = (src + 1 + rng.integers(0, max(N - 1, 1), n)) % N
    up_src = rng.integers(0, S, n)   # first-hop uplink draw
    up_dst = rng.integers(0, S, n)   # last-hop downlink draw

    blk_start = np.full(n, NEVER, np.int32)
    blk_end = np.full(n, NEVER, np.int32)
    frz_start = np.full(n, NEVER, np.int32)
    frz_end = np.full(n, NEVER, np.int32)
    lat_scale = np.ones(steps, np.float64)
    bulk_scale = np.ones(steps, np.float64)

    def widen(starts, ends, hit, lo, hi):
        starts[hit] = np.minimum(starts[hit], np.int32(lo))
        ends[hit] = np.where(ends[hit] == NEVER, np.int32(hi),
                             np.maximum(ends[hit], np.int32(hi)))

    n_up = max(N * S, 1)
    for ev in schedule.events:
        onset = ev.onset_step
        detect = min(ev.detect_step, steps)
        recover = min(ev.recover, steps)
        if ev.kind == "tor":
            racks = np.asarray(ev.ids, np.int64)
            hit = np.isin(src, racks) | np.isin(dst, racks)
            cap_frac = len(racks) / max(N, 1)
        elif ev.kind == "switch":
            sws = np.asarray(ev.ids, np.int64)
            hit = np.isin(up_src, sws) | np.isin(up_dst, sws)
            cap_frac = len(sws) / max(S, 1)
        else:  # link: (rack, switch) uplinks
            keys = np.asarray([r * S + s for r, s in ev.ids], np.int64)
            hit = (np.isin(src * S + up_src, keys)
                   | np.isin(dst * S + up_dst, keys))
            cap_frac = len(ev.ids) / n_up
        # blackhole until the hello protocol notices
        widen(blk_start, blk_end, hit, onset, ev.detect_step)
        if ev.kind == "tor":
            # behind a dead ToR: frozen once detected, retry on recovery
            widen(frz_start, frz_end, hit, ev.detect_step, ev.recover)
        # detected capacity loss shrinks both pools until recovery
        if detect < recover:
            lat_scale[detect:recover] *= 1.0 - cap_frac
            bulk_scale[detect:recover] *= 1.0 - cap_frac
    return _dc.replace(
        scn,
        blk_start=blk_start, blk_end=blk_end,
        frz_start=frz_start, frz_end=frz_end,
        lat_scale=lat_scale, bulk_scale=bulk_scale,
    )


def flow_fault_arrays(scn, num_steps: int, order=None, pad_to: int = 0):
    """Staged fault operands for one `FlowScenario`, shared by the
    dense and tiled flow engines: four (n,) int32 per-flow windows and
    two (num_steps,) float32 pool scales.  Fault-free scenarios get
    NEVER-filled windows and unit scales — under the faulted step
    those reduce to the plain recurrence.  `order` reindexes the
    windows for the tiled engine's sorted layout; `pad_to` right-pads
    the windows with NEVER for tile alignment."""
    n = scn.num_flows
    P = max(int(pad_to), n)

    def win(w):
        out = np.full(P, NEVER, np.int32)
        if w is not None:
            out[:n] = w if order is None else w[order]
        return out

    lat_scale = np.ones(num_steps, np.float32)
    bulk_scale = np.ones(num_steps, np.float32)
    if scn.has_faults:
        lat_scale[:] = scn.lat_scale[:num_steps]
        bulk_scale[:] = scn.bulk_scale[:num_steps]
    return (win(scn.blk_start), win(scn.blk_end),
            win(scn.frz_start), win(scn.frz_end), lat_scale, bulk_scale)

"""Fault tolerance & straggler mitigation (the control plane).

Copy of `repro.train.health`, which imports no framework; keep the two
in step (tests/test_torch_train.py holds their decisions equal).

Maps Opera's failure story (§3.6.2) onto the training fleet:

* hello protocol  -> per-worker heartbeats each step; a worker silent for
  `timeout_steps` is declared failed (like a link that misses its hello
  window being marked bad).
* route around    -> the rotor collective schedules are design-time
  functions of the participant set: on failure the controller shrinks the
  mesh (drop the slowest/failed host group), restores the latest elastic
  checkpoint onto the new mesh, and resumes — connectivity is re-derived,
  not repaired in place.
* guard bands     -> straggler policy: a worker whose step time exceeds
  `straggler_factor` x the fleet median for `patience` consecutive steps
  is treated as failed-slow and scheduled for replacement at the next
  checkpoint boundary (synchronous SPMD cannot proceed without it, so the
  mitigation is replace-and-restart, the standard production approach).

In a single process the fleet is simulated; the policy logic
(detection, decision, restart plumbing) is the real, tested code.
"""
from __future__ import annotations

import dataclasses
import time
from collections import defaultdict, deque
from typing import Callable, Dict, List, Optional, Set


@dataclasses.dataclass
class HealthConfig:
    timeout_steps: int = 3          # missed heartbeats before declared dead
    straggler_factor: float = 2.0   # x median step time
    patience: int = 5               # consecutive slow steps
    min_workers: int = 1


class FleetMonitor:
    """Tracks per-worker heartbeats + step durations; decides restarts."""

    def __init__(self, workers: List[str], cfg: HealthConfig = HealthConfig()):
        self.cfg = cfg
        self.workers: Set[str] = set(workers)
        self.last_seen: Dict[str, int] = {w: 0 for w in workers}
        self.durations: Dict[str, deque] = {
            w: deque(maxlen=32) for w in workers
        }
        self.slow_streak: Dict[str, int] = defaultdict(int)
        self.failed: Set[str] = set()

    def heartbeat(self, worker: str, step: int, duration_s: float):
        if worker in self.failed:
            return
        self.last_seen[worker] = step
        self.durations[worker].append(duration_s)

    def median_duration(self) -> float:
        vals = sorted(
            d[-1] for w, d in self.durations.items()
            if d and w not in self.failed
        )
        return vals[len(vals) // 2] if vals else 0.0

    def check(self, step: int) -> Dict[str, List[str]]:
        """Returns {'dead': [...], 'stragglers': [...]} newly detected."""
        dead, slow = [], []
        med = self.median_duration()
        for w in sorted(self.workers - self.failed):
            if step - self.last_seen[w] >= self.cfg.timeout_steps:
                dead.append(w)
                continue
            d = self.durations[w]
            if med > 0 and d and d[-1] > self.cfg.straggler_factor * med:
                self.slow_streak[w] += 1
                if self.slow_streak[w] >= self.cfg.patience:
                    slow.append(w)
            else:
                self.slow_streak[w] = 0
        for w in dead + slow:
            self.failed.add(w)
        return {"dead": dead, "stragglers": slow}

    def healthy(self) -> List[str]:
        return sorted(self.workers - self.failed)


@dataclasses.dataclass
class RestartPlan:
    """What the controller does on failure: shrink + restore + resume."""
    surviving_workers: List[str]
    restore_step: int
    new_mesh_shape: tuple

    @staticmethod
    def from_failure(
        monitor: FleetMonitor,
        latest_ckpt_step: int,
        devices_per_worker: int,
        model_axis: int,
    ) -> "RestartPlan":
        n = len(monitor.healthy())
        # keep the model axis, shrink data-parallel width to what survives
        data = max((n * devices_per_worker) // model_axis, 1)
        return RestartPlan(
            surviving_workers=monitor.healthy(),
            restore_step=latest_ckpt_step,
            new_mesh_shape=(data, model_axis),
        )

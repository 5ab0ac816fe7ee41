"""Per-slice routing (§3.4, §3.6.2, §5.5).

For every topology slice we precompute next-hop tables over the union of
live matchings (the time-varying expander).  Failures (links, ToRs,
circuit switches) are masked out and routes recomputed — the paper's
hello-protocol reconvergence, evaluated in Fig. 11 / Appendix E.

Routing tables are design-time state of size O(N_racks^2) per slice
(Table 1); `ruleset_size()` reproduces the scalability table.

Copy of `repro.core.routing` (numpy only); keep the two in step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.core.topology import OperaTopology


@dataclasses.dataclass
class FailureSet:
    """Failed components.  Links are undirected rack pairs; uplinks are
    physical ``(rack, switch)`` fibers — the sampling unit of the fault
    subsystem (`netsim.faults`), where a dead fiber kills both
    directions of that rack's edge on every matching the switch serves.

    Membership is set-based, but anything that *iterates* in a
    result-affecting order must go through the ``sorted_*`` views so
    results never depend on set hashing.
    """

    links: Set[Tuple[int, int]] = dataclasses.field(default_factory=set)
    tors: Set[int] = dataclasses.field(default_factory=set)
    switches: Set[int] = dataclasses.field(default_factory=set)
    uplinks: Set[Tuple[int, int]] = dataclasses.field(default_factory=set)

    def link_failed(self, a: int, b: int) -> bool:
        return (min(a, b), max(a, b)) in self.links

    def uplink_failed(self, rack: int, switch: int) -> bool:
        return (rack, switch) in self.uplinks

    @property
    def sorted_links(self) -> List[Tuple[int, int]]:
        return sorted(self.links)

    @property
    def sorted_tors(self) -> List[int]:
        return sorted(self.tors)

    @property
    def sorted_switches(self) -> List[int]:
        return sorted(self.switches)

    @property
    def sorted_uplinks(self) -> List[Tuple[int, int]]:
        return sorted(self.uplinks)


def slice_adjacency(
    topo: OperaTopology, t: int, failures: Optional[FailureSet] = None
) -> np.ndarray:
    """Adjacency of slice t with failures applied."""
    n = topo.num_racks
    adj = np.zeros((n, n), dtype=bool)
    idx = np.arange(n)
    for s, p in topo.live_matchings(t):
        if failures and s in failures.switches:
            continue
        mask = p != idx
        if failures and failures.uplinks:
            dead = np.fromiter(
                ((int(r), s) in failures.uplinks for r in idx), bool, n
            )
            mask = mask & ~dead & ~dead[p]
        adj[idx[mask], p[mask]] = True
    if failures:
        for (a, b) in failures.sorted_links:
            adj[a, b] = adj[b, a] = False
        for tor in failures.sorted_tors:
            adj[tor, :] = False
            adj[:, tor] = False
    return adj


def bfs_next_hop(adj: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Vectorized multi-source BFS.

    Returns (dist, next_hop): dist[i,j] = hop count (-1 unreachable),
    next_hop[i,j] = neighbor of i on a shortest i->j path (-1 if none).
    """
    n = adj.shape[0]
    dist = np.full((n, n), -1, dtype=np.int64)
    np.fill_diagonal(dist, 0)
    nxt = np.full((n, n), -1, dtype=np.int64)
    # dist 1 = direct neighbors
    nbrs = [np.nonzero(adj[i])[0] for i in range(n)]
    reach = np.eye(n, dtype=bool)
    dist1 = adj & ~reach
    dist[dist1] = 1
    ii, jj = np.nonzero(dist1)
    nxt[ii, jj] = jj
    reach |= dist1
    frontier = dist1
    h = 1
    while frontier.any():
        h += 1
        # newly reachable: one more hop through any neighbor
        new = (frontier @ adj.T.astype(frontier.dtype)).astype(bool) & ~reach
        # orient as [src, dst]: node j newly reachable from i if some
        # neighbor k of i had dist[i->j] == h-1 ... do it per-source:
        newly_any = False
        for i in range(n):
            cand = ~reach[i]
            if not cand.any():
                continue
            # dsts reachable at h via neighbor k with dist[k, dst] == h-1
            ks = nbrs[i]
            if len(ks) == 0:
                continue
            sub = dist[ks][:, cand] == h - 1
            hit = sub.any(axis=0)
            if not hit.any():
                continue
            newly_any = True
            dst_idx = np.nonzero(cand)[0][hit]
            # pick the first qualifying neighbor (deterministic)
            kpick = ks[np.argmax(sub[:, hit], axis=0)]
            dist[i, dst_idx] = h
            nxt[i, dst_idx] = kpick
            reach[i, dst_idx] = True
        if not newly_any:
            break
        frontier = dist == h
    return dist, nxt


@dataclasses.dataclass
class SliceRoutes:
    slice_id: int
    dist: np.ndarray
    next_hop: np.ndarray

    @property
    def disconnected_pairs(self) -> int:
        n = self.dist.shape[0]
        off = self.dist[~np.eye(n, dtype=bool)]
        return int((off < 0).sum())


def compute_routes(
    topo: OperaTopology,
    failures: Optional[FailureSet] = None,
    slices: Optional[Sequence[int]] = None,
) -> List[SliceRoutes]:
    out = []
    for t in slices if slices is not None else range(topo.num_slices):
        adj = slice_adjacency(topo, t, failures)
        if failures:
            # failed ToRs are not sources/destinations of interest
            pass
        dist, nxt = bfs_next_hop(adj)
        out.append(SliceRoutes(int(t), dist, nxt))
    return out


def connectivity_loss(
    topo: OperaTopology,
    failures: FailureSet,
    slices: Optional[Sequence[int]] = None,
) -> Dict[str, float]:
    """Fig. 11 metrics: worst-slice and integrated-across-slices fraction
    of disconnected (non-failed) ToR pairs."""
    n = topo.num_racks
    alive = np.array([i for i in range(n) if i not in failures.tors])
    na = len(alive)
    total_pairs = na * (na - 1)
    worst = 0
    union_ok = np.zeros((n, n), dtype=bool)  # pair connected in >= 1 slice
    every_ok = None
    for t in slices if slices is not None else range(topo.num_slices):
        adj = slice_adjacency(topo, t, failures)
        from repro_torch.core.expander import hop_distances

        dist = hop_distances(adj)
        sub = dist[np.ix_(alive, alive)]
        ok = sub >= 0
        np.fill_diagonal(ok, True)
        worst = max(worst, int((~ok).sum()))
        full = np.zeros((n, n), dtype=bool)
        full[np.ix_(alive, alive)] = ok
        union_ok |= full
        every_ok = full if every_ok is None else (every_ok & full)
    ever_disc = total_pairs - int(
        union_ok[np.ix_(alive, alive)].sum() - na
    )  # minus diagonal
    return dict(
        worst_slice_disconnected_frac=worst / max(total_pairs, 1),
        any_slice_disconnected_frac=ever_disc / max(total_pairs, 1),
        always_connected_frac=(
            (int(every_ok[np.ix_(alive, alive)].sum()) - na) / max(total_pairs, 1)
            if every_ok is not None
            else 1.0
        ),
    )


def path_stretch(
    topo: OperaTopology, failures: FailureSet, slices: Sequence[int]
) -> Dict[str, float]:
    """Appendix E: average / max finite path length under failures."""
    means, maxes = [], []
    for t in slices:
        adj = slice_adjacency(topo, t, failures)
        from repro_torch.core.expander import mean_max_path

        m, mx, _ = mean_max_path(adj)
        if np.isfinite(m):
            means.append(m)
            maxes.append(mx)
    return dict(
        mean_path=float(np.mean(means)) if means else float("inf"),
        max_path=int(max(maxes)) if maxes else -1,
    )


def ruleset_size(num_racks: int, uplinks: Optional[int] = None) -> int:
    """Table 1: per-ToR forwarding entries.

    N_slices x (N-1) low-latency next-hop rules (one per destination per
    slice) plus N x u bulk rules (which uplink gives the direct circuit,
    per slice).  The published counts back out u = {6, 8, 12, 15, 17, 19}
    for N = {108..1200}, i.e. u ~ N/64 + 4 — the deployment's ToR radix
    growing with scale.  Model matches Table 1 within ~0.5 %.
    """
    u = uplinks if uplinks is not None else int(round(num_racks / 64)) + 4
    return num_racks * (num_racks - 1) + num_racks * u

"""Opera topology generation (§3.3 of the paper).

Copy of the design-time half of `repro.core.topology`, with one change:
where the reference falls back to `networkx.max_weight_matching` for a
perfect matching its greedy draw cannot finish, this module runs its
own exact search (`_max_cardinality_matching`, Edmonds' blossom
algorithm in plain Python).  The random draws are the reference's, but
the fallback may pick another, equally valid matching, so the same seed
may give a different topology than the JAX package gives.  Tests that
hold the two packages against each other carry the reference's
topology across with `topology_from_arrays` instead of rebuilding it.

A complete graph over N racks (self-loops included) is factored into N
disjoint symmetric matchings; matchings are randomly assigned to the u
circuit switches (N/u each) with a random cycling order per switch;
reconfigurations are staggered so that at any slice exactly `groups`
switches are dark and the union of the live matchings is an expander.

Matchings are integer partner vectors `p` of length N with
``p[p[i]] == i`` (involution); ``p[i] == i`` marks a self-loop.
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np

Matching = np.ndarray  # int64[N], involution


# --------------------------------------------------------------------------
# Complete-graph factorization
# --------------------------------------------------------------------------


def sum_matchings(n: int) -> List[Matching]:
    """Factor K_n (with self-loops) into n disjoint symmetric matchings:
    matching m pairs i with (m - i) mod n."""
    i = np.arange(n)
    return [((m - i) % n).astype(np.int64) for m in range(n)]


def conjugate(matchings: Sequence[Matching], perm: np.ndarray) -> List[Matching]:
    """Relabel racks by `perm`; involutions, disjointness and coverage
    are preserved."""
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return [perm[p[inv]] for p in matchings]


def _max_cardinality_matching(avail: np.ndarray) -> np.ndarray:
    """Maximum-cardinality matching of the undirected graph `avail`
    (boolean adjacency; the diagonal is ignored), by Edmonds' blossom
    algorithm.  Deterministic: vertices and neighbours are visited in
    index order.  Returns partner indices, -1 where unmatched."""
    n = avail.shape[0]
    nbrs = [[int(w) for w in np.nonzero(avail[v])[0] if w != v]
            for v in range(n)]
    match = [-1] * n
    # a greedy start leaves only a few vertices for the augmenting search
    for v in range(n):
        if match[v] < 0:
            for w in nbrs[v]:
                if match[w] < 0:
                    match[v], match[w] = w, v
                    break

    def augment(root: int) -> bool:
        parent = [-1] * n
        base = list(range(n))
        used = [False] * n
        used[root] = True
        queue = deque([root])

        def lca(a: int, b: int) -> int:
            seen = [False] * n
            while True:
                a = base[a]
                seen[a] = True
                if match[a] < 0:
                    break
                a = parent[match[a]]
            while True:
                b = base[b]
                if seen[b]:
                    return b
                b = parent[match[b]]

        def mark_path(v: int, b: int, child: int, blossom: List[bool]) -> None:
            while base[v] != b:
                blossom[base[v]] = blossom[base[match[v]]] = True
                parent[v] = child
                child = match[v]
                v = parent[match[v]]

        while queue:
            v = queue.popleft()
            for to in nbrs[v]:
                if base[v] == base[to] or match[v] == to:
                    continue
                if to == root or (match[to] >= 0 and parent[match[to]] >= 0):
                    cur = lca(v, to)
                    blossom = [False] * n
                    mark_path(v, cur, to, blossom)
                    mark_path(to, cur, v, blossom)
                    for i in range(n):
                        if blossom[base[i]]:
                            base[i] = cur
                            if not used[i]:
                                used[i] = True
                                queue.append(i)
                elif parent[to] < 0:
                    parent[to] = v
                    if match[to] < 0:
                        # flip the alternating path root ... v -> to
                        while to >= 0:
                            pv = parent[to]
                            nxt = match[pv]
                            match[to], match[pv] = pv, to
                            to = nxt
                        return True
                    used[match[to]] = True
                    queue.append(match[to])
        return False

    for v in range(n):
        if match[v] < 0:
            augment(v)
    return np.asarray(match, dtype=np.int64)


def _random_perfect_matching(
    avail: np.ndarray, rng: np.random.Generator
) -> Optional[Matching]:
    """Random perfect matching on the graph `avail` (greedy with retries,
    exact blossom search for the sparse tail)."""
    n = avail.shape[0]
    for _ in range(30):
        p = np.full(n, -1, dtype=np.int64)
        ok = True
        for v in rng.permutation(n):
            if p[v] >= 0:
                continue
            cands = np.nonzero(avail[v] & (p < 0))[0]
            cands = cands[cands != v]
            if len(cands) == 0:
                ok = False
                break
            u = int(rng.choice(cands))
            p[v], p[u] = u, v
        if ok:
            return p
    p = _max_cardinality_matching(avail)
    return p if (p >= 0).all() else None


def random_matchings(n: int, seed: int = 0) -> List[Matching]:
    """RANDOM factorization of the all-ones matrix (§3.3): n-1 random
    disjoint perfect matchings of K_n plus the diagonal spread over one
    more.  Odd n falls back to the structured factorization."""
    if n % 2:
        rng = np.random.default_rng(seed)
        return conjugate(sum_matchings(n), rng.permutation(n))
    for attempt in range(20):
        rng = np.random.default_rng(seed * 1009 + attempt)
        avail = ~np.eye(n, dtype=bool)
        out: List[Matching] = []
        failed = False
        for _ in range(n - 1):
            p = _random_perfect_matching(avail, rng)
            if p is None:
                failed = True
                break
            avail[np.arange(n), p] = False
            avail[p, np.arange(n)] = False
            out.append(p)
        if failed:
            continue
        spread = _spread_diagonal(out, rng)
        if spread is not None:
            return spread
        # tiny n (e.g. 4) cannot spread the diagonal: keep an identity slice
        out.append(np.arange(n, dtype=np.int64))
        return out
    raise RuntimeError(f"could not factor K_{n} randomly")


def _spread_diagonal(
    perfect: List[Matching], rng: np.random.Generator
) -> Optional[List[Matching]]:
    """Turn n-1 perfect matchings of K_n into n matchings covering the
    all-ones matrix with the diagonal spread across them: one edge is
    removed from each of n/2 donor matchings, the removed edges forming
    the n-th matching."""
    n = len(perfect[0])
    k = n // 2
    idx = list(range(len(perfect)))
    for _ in range(200):
        rng.shuffle(idx)
        donors = idx[:k]
        covered = np.zeros(n, dtype=bool)
        chosen = []
        ok = True
        for j in donors:
            p = perfect[j]
            free = np.nonzero(~covered & ~covered[p])[0]
            free = free[free < p[free]]  # canonical edge orientation
            if len(free) == 0:
                ok = False
                break
            a = int(rng.choice(free))
            b = int(p[a])
            covered[a] = covered[b] = True
            chosen.append((j, a, b))
        if not ok or not covered.all():
            continue
        out = [m.copy() for m in perfect]
        new = np.arange(n, dtype=np.int64)
        for j, a, b in chosen:
            out[j][a] = a   # donor keeps self-loops at a, b
            out[j][b] = b
            new[a], new[b] = b, a
        out.append(new)
        return out
    return None


def lift_matchings(base: Sequence[Matching], factor: int) -> List[Matching]:
    """Graph lifting (§3.3): grow a factorization of K_n to one of
    K_{n*f}.  Vertex (v, c) -> index v*f + c; base matching m and lift
    phase g pair (v, c) with (partner_m(v), (g - c) mod f)."""
    f = factor
    out: List[Matching] = []
    c = np.arange(f)
    for p in base:
        for g in range(f):
            lifted = np.empty(len(p) * f, dtype=np.int64)
            for v in range(len(p)):
                lifted[v * f + c] = p[v] * f + ((g - c) % f)
            out.append(lifted)
    return out


def verify_factorization(matchings: Sequence[Matching]) -> None:
    """Disjoint symmetric matchings covering the all-ones matrix."""
    n = len(matchings[0])
    if len(matchings) != n:
        raise ValueError(f"need n={n} matchings, got {len(matchings)}")
    cover = np.zeros((n, n), dtype=np.int64)
    for p in matchings:
        if not np.array_equal(p[p], np.arange(n)):
            raise ValueError("matching is not an involution")
        cover[np.arange(n), p] += 1
    if not (cover == 1).all():
        raise ValueError("matchings do not exactly factor the complete graph")


# --------------------------------------------------------------------------
# Switch assignment + slice schedule
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OperaTopology:
    """A fully-instantiated Opera design point.

    switch_matchings[s][j] is the j-th matching in switch s's cycle.
    One cycle = num_slices slices; during slice t the switches in
    `dark_switches(t)` are reconfiguring (their uplinks carry no traffic).
    """

    num_racks: int
    num_switches: int              # u
    switch_matchings: Tuple[Tuple[Matching, ...], ...]
    groups: int = 1                # switches reconfiguring simultaneously

    @property
    def u(self) -> int:
        return self.num_switches

    @property
    def matchings_per_switch(self) -> int:
        return len(self.switch_matchings[0])

    @property
    def num_slices(self) -> int:
        return self.matchings_per_switch * self.num_switches // self.groups

    def dark_switches(self, t: int) -> Tuple[int, ...]:
        """Switches reconfiguring during slice t (staggered, Fig. 3b)."""
        t = t % self.num_slices
        rounds = self.num_switches // self.groups
        g = t % rounds
        return tuple(g * self.groups + i for i in range(self.groups))

    def matching_index(self, s: int, t: int) -> int:
        """Which of switch s's matchings is installed during slice t."""
        t = t % self.num_slices
        rounds = self.num_switches // self.groups
        phase = s // self.groups
        n_reconf = (t - phase) // rounds + 1 if t >= phase else 0
        return n_reconf % self.matchings_per_switch

    def live_matchings(self, t: int) -> List[Tuple[int, Matching]]:
        """(switch, matching) pairs carrying traffic during slice t."""
        dark = set(self.dark_switches(t))
        return [
            (s, self.switch_matchings[s][self.matching_index(s, t)])
            for s in range(self.num_switches)
            if s not in dark
        ]

    def adjacency(self, t: int) -> np.ndarray:
        """Boolean rack-to-rack adjacency of slice t (self-loops dropped)."""
        n = self.num_racks
        adj = np.zeros((n, n), dtype=bool)
        i = np.arange(n)
        for _, p in self.live_matchings(t):
            mask = p != i
            adj[i[mask], p[mask]] = True
        return adj

    def matching_tensor(self) -> np.ndarray:
        """``(num_slices, N, N)`` float32: slice t's live adjacency, the
        dense engine's design-time artifact."""
        return np.stack(
            [self.adjacency(t) for t in range(self.num_slices)]
        ).astype(np.float32)

    def matching_index_tensor(self) -> np.ndarray:
        """``(num_slices, N, u)`` int32: entry ``[t, i, s]`` is the rack
        switch s connects rack i to during slice t, or the sentinel ``N``
        when the slot is dark (switch reconfiguring, or a self-loop).
        Every live matching is an involution, so
        ``dst[dst[i, s], s] == i`` for every non-sentinel entry.  The
        sparse engine and the `rotor_slice` kernel gather over it."""
        n, u = self.num_racks, self.num_switches
        out = np.full((self.num_slices, n, u), n, dtype=np.int32)
        i = np.arange(n)
        for t in range(self.num_slices):
            for s, p in self.live_matchings(t):
                live = p != i
                out[t, i[live], s] = p[live]
        return out


def topology_from_arrays(
    num_racks: int,
    num_switches: int,
    switch_matchings: np.ndarray,
    groups: int = 1,
) -> OperaTopology:
    """Carry a topology across as plain arrays: `switch_matchings` is
    ``(u, N/u, N)`` integer partner vectors (e.g. another builder's
    ``np.asarray(topo.switch_matchings)``).  The factorization is
    checked before the topology is returned."""
    arr = np.asarray(switch_matchings).astype(np.int64)
    if arr.ndim != 3 or arr.shape[0] != num_switches or arr.shape[2] != num_racks:
        raise ValueError(
            f"switch_matchings shape {arr.shape} != "
            f"({num_switches}, {num_racks} // {num_switches}, {num_racks})")
    if num_switches % groups:
        raise ValueError("groups must divide num_switches")
    verify_factorization([m for sw in arr for m in sw])
    return OperaTopology(
        num_racks=num_racks,
        num_switches=num_switches,
        switch_matchings=tuple(tuple(m.copy() for m in sw) for sw in arr),
        groups=groups,
    )


def build_opera_topology(
    num_racks: int,
    num_switches: int,
    seed: int = 0,
    groups: int = 1,
    base_matchings: Optional[Sequence[Matching]] = None,
    verify_slices: bool = True,
    switch_fault_tolerance: int = 0,
) -> OperaTopology:
    """Design-time construction with the paper's generate-and-test loop
    (§3.3): redraw until every topology slice is connected — and, with
    switch_fault_tolerance=k, until connectivity survives any k
    circuit-switch failures in every slice."""
    if num_racks % num_switches != 0:
        raise ValueError("num_racks must be divisible by num_switches (N/u whole)")
    if num_switches % groups != 0:
        raise ValueError("groups must divide num_switches")
    last = None
    for attempt in range(24):
        rng = np.random.default_rng(seed + 7919 * attempt)
        matchings = (
            list(base_matchings)
            if base_matchings is not None
            else random_matchings(num_racks, seed + 7919 * attempt)
        )
        verify_factorization(matchings)
        order = rng.permutation(num_racks)
        per = num_racks // num_switches
        switch_matchings = []
        for s in range(num_switches):
            idx = order[s * per : (s + 1) * per]
            cyc = [matchings[j] for j in idx]
            rng.shuffle(cyc)
            switch_matchings.append(tuple(cyc))
        topo = OperaTopology(
            num_racks=num_racks,
            num_switches=num_switches,
            switch_matchings=tuple(switch_matchings),
            groups=groups,
        )
        last = topo
        if not verify_slices or _slices_robust(topo, switch_fault_tolerance):
            return topo
    return last  # best effort (tests check connectivity explicitly)


def build_lifted_opera_topology(
    num_racks: int,
    num_switches: int,
    seed: int = 0,
    groups: int = 1,
    max_base: int = 128,
    verify_slices: bool = False,
) -> OperaTopology:
    """Large Appendix-B design points via graph lifting (§3.3): the
    smallest lift factor f dividing num_racks whose base num_racks/f is
    even, >= 2*num_switches and <= max_base, then a lift of
    `random_matchings(base)`."""
    base_n = num_racks
    factor = 1
    if num_racks > max_base:
        for f in range(2, num_racks // max(2 * num_switches, 2) + 1):
            if num_racks % f:
                continue
            b = num_racks // f
            if b % 2 == 0 and b >= 2 * num_switches and b <= max_base:
                base_n, factor = b, f
                break
        else:
            raise ValueError(
                f"no lift base for N={num_racks}, u={num_switches} "
                f"with max_base={max_base}")
    base = random_matchings(base_n, seed)
    matchings = lift_matchings(base, factor) if factor > 1 else base
    return build_opera_topology(
        num_racks, num_switches, seed=seed, groups=groups,
        base_matchings=matchings, verify_slices=verify_slices,
    )


def _connected(adj: np.ndarray) -> bool:
    n = adj.shape[0]
    a = adj | np.eye(n, dtype=bool)
    reach = np.zeros(n, dtype=bool)
    reach[0] = True
    while True:
        new = a[reach].any(axis=0) & ~reach
        if not new.any():
            break
        reach |= new
    return bool(reach.all())


def _slices_robust(topo: OperaTopology, fault_tolerance: int) -> bool:
    n = topo.num_racks
    idx = np.arange(n)
    fail_sets = [frozenset()]
    if fault_tolerance:
        fail_sets += [
            frozenset(c)
            for k in range(1, fault_tolerance + 1)
            for c in itertools.combinations(range(topo.num_switches), k)
        ]
    for t in range(topo.num_slices):
        live = topo.live_matchings(t)
        for fs in fail_sets:
            adj = np.zeros((n, n), dtype=bool)
            for s, p in live:
                if s in fs:
                    continue
                mask = p != idx
                adj[idx[mask], p[mask]] = True
            if not _connected(adj):
                return False
    return True


# --------------------------------------------------------------------------
# Collective-schedule view (the rotor collectives, core/collectives.py).
#
# For an N-way mesh axis the rotor schedule is the N-matching factorization
# itself: during "slice" m every shard i exchanges exactly with
# (m - i) mod N.  A rotor collective walks slices 1..N-1 (slice pairing a
# shard with itself moves no bytes), sending each peer's chunk on the one
# slice with a direct circuit -> every byte travels exactly one hop: the
# bulk class of the paper, zero bandwidth tax.
# --------------------------------------------------------------------------


def rotor_schedule(n: int) -> List[List[Tuple[int, int]]]:
    """ppermute perm lists for slices m = 1..n-1 of the sum factorization
    (then slice 0 where it pairs any shard with another).

    Each perm list contains ordered (src, dst) pairs for every shard with a
    partner != itself.  Because matchings are involutions the perm is its
    own inverse — a bidirectional exchange.
    """
    perms: List[List[Tuple[int, int]]] = []
    for m in list(range(1, n)) + [0]:
        p = [(i, (m - i) % n) for i in range(n) if (m - i) % n != i]
        if p:
            perms.append(p)
    return perms


def expander_union(n: int, degree: int, seed: int = 0) -> np.ndarray:
    """Union of `degree` random matchings over n nodes (the 'live now'
    graph a latency-class message can use immediately)."""
    ms = random_matchings(n, seed)[:degree]
    adj = np.zeros((n, n), dtype=bool)
    i = np.arange(n)
    for p in ms:
        mask = p != i
        adj[i[mask], p[mask]] = True
    return adj

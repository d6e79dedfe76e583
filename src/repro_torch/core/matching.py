"""Maximum-weight bipartite matching via the Kuhn–Munkres (Hungarian)
algorithm — the paper's scheduler core (§5), O(|V|³).

`km_match(weights)` maximizes total weight over a (possibly rectangular)
weight matrix; unmatched rows/cols are allowed (padding with zero weight —
an offline workload may stay pending, a GPU may stay unshared, exactly the
paper's semantics where every edge weight = predicted normalized throughput
≥ 0).

Implementation: Jonker–Volgenant shortest-augmenting-path with potentials
(numpy-vectorized inner loop), the standard exact O(n³) form of KM.

Copied from `repro/core/matching.py`: host numpy, the same answers.
"""
from __future__ import annotations

import hashlib
import itertools

import numpy as np

try:  # optional C-implemented backend (declared in the dev extra)
    from scipy.optimize import linear_sum_assignment as _scipy_lsa
except Exception:  # pragma: no cover - exercised only without scipy
    _scipy_lsa = None


def _jv_min_assign(cost: np.ndarray) -> np.ndarray:
    """Minimum-cost assignment of every row to a distinct column on a
    rectangular matrix with n_rows <= n_cols.  Returns col_of_row (n_rows,).
    O(n_rows² · n_cols) — the square case is the classic O(n³) form."""
    n_r, n_c = cost.shape
    assert n_r <= n_c
    INF = np.inf
    u = np.zeros(n_r + 1)
    v = np.zeros(n_c + 1)
    p = np.zeros(n_c + 1, dtype=np.int64)        # p[j] = row matched to col j
    way = np.zeros(n_c + 1, dtype=np.int64)
    # 1-indexed internally; column 0 is virtual
    for i in range(1, n_r + 1):
        p[0] = i
        j0 = 0
        minv = np.full(n_c + 1, INF)
        used = np.zeros(n_c + 1, dtype=bool)
        while True:
            used[j0] = True
            i0 = p[j0]
            # vectorized relaxation over unused columns 1..n_c
            free = ~used[1:]
            cur = cost[i0 - 1, :] - u[i0] - v[1:]
            better = free & (cur < minv[1:])
            minv[1:] = np.where(better, cur, minv[1:])
            way[1:][better] = j0
            # find delta over free columns
            masked = np.where(free, minv[1:], INF)
            j1 = int(np.argmin(masked)) + 1
            delta = masked[j1 - 1]
            # update potentials
            u[p[used]] += delta
            v[used] -= delta
            minv[1:][free] -= delta
            j0 = j1
            if p[j0] == 0:
                break
        # augment along the path
        while j0:
            j1 = way[j0]
            p[j0] = p[j1]
            j0 = j1
    col_of_row = np.zeros(n_r, dtype=np.int64)
    for j in range(1, n_c + 1):
        if p[j] > 0:
            col_of_row[p[j] - 1] = j - 1
    return col_of_row


def km_match(weights: np.ndarray) -> list[tuple[int, int]]:
    """Maximum-weight matching.  weights: (n_online, n_offline), >= 0.
    Returns [(row, col), ...] for matched pairs with weight > 0.

    The rectangular problem is solved natively on its short side (the long
    side is never padded to square — padding buries the solver in identical
    zero-weight dummy columns and turns e.g. a 2000×100 instance into a
    2000³ one).  When scipy is importable its C implementation of the same
    algorithm is used — the pure-numpy JV below is the reference fallback,
    and it degrades badly on the scheduler's tie-heavy shards (only a
    handful of distinct weight columns at paper scale)."""
    w = np.asarray(weights, dtype=np.float64)
    if w.size == 0:
        return []
    if _scipy_lsa is not None:
        ri, ci = _scipy_lsa(w, maximize=True)
        return [(int(r), int(c)) for r, c in zip(ri, ci) if w[r, c] > 0]
    n_r, n_c = w.shape
    transposed = n_r > n_c
    a = w.T if transposed else w
    cost = a.max() - a                           # maximize -> minimize
    col_of_row = _jv_min_assign(cost)
    out = []
    for r in range(a.shape[0]):
        c = int(col_of_row[r])
        if a[r, c] > 0:
            out.append((c, r) if transposed else (r, c))
    return sorted(out) if transposed else out


def matching_weight(weights: np.ndarray, pairs: list[tuple[int, int]]) -> float:
    return float(sum(weights[r, c] for r, c in pairs))


# ---------------------------------------------------------------------------
# Partitioned (sharded) matching for paper-scale clusters
# ---------------------------------------------------------------------------
#
# At n = 20 000 devices a dense KM round is O(n³) and unusable.  The paper
# schedules per cluster partition anyway (§5), so we split the bipartite
# problem into bounded-size shards and solve each exactly.  Two structural
# reductions keep this near-optimal:
#
#   * offline jobs of the same model produce *identical* weight columns, so
#     column counts can be capped at the number of matchable pairs and each
#     shard can be dealt a proportional mix of every column group;
#   * an optimal matching touches at most min(n, m) devices, and (by a simple
#     exchange argument) there is always an optimum inside the union of each
#     column-group's top-min(n, m) devices — everything else is pruned.


def _group_duplicate_columns(weights: np.ndarray,
                             decimals: int = 12) -> tuple[np.ndarray, np.ndarray]:
    """Returns (values (n, u), col_group (m,)) where u is the number of
    distinct columns (rounded to `decimals`)."""
    w = np.round(weights, decimals)
    groups: dict[bytes, int] = {}
    col_group = np.empty(w.shape[1], np.int64)
    firsts: list[int] = []
    for j in range(w.shape[1]):
        key = w[:, j].tobytes()
        g = groups.get(key)
        if g is None:
            g = groups[key] = len(firsts)
            firsts.append(j)
        col_group[j] = g
    return weights[:, firsts].astype(np.float64, copy=True), col_group


def _prune_row_heavy(vals: np.ndarray, rows_s: np.ndarray,
                     grp_s: np.ndarray, row_slack: int) -> np.ndarray:
    """Row-heavy shard pruning shared by the compact and incremental
    matchers: keep per group only the strongest (group count + slack) rows
    — KM pads rectangular problems to the max dimension, so near-square
    shards are critical."""
    keep_mask = np.zeros(rows_s.size, bool)
    for g in np.unique(grp_s):
        kk = min(rows_s.size, int((grp_s == g).sum()) + row_slack)
        col_vals = vals[rows_s, g]
        keep_mask[np.argpartition(-col_vals, kk - 1)[:kk]] = True
    return rows_s[keep_mask]


def _greedy_repair(vals: np.ndarray, col_group: np.ndarray,
                   keep_cols: list[np.ndarray], cand: np.ndarray,
                   out: list[tuple[int, int]], row_used: np.ndarray,
                   col_used: np.ndarray) -> None:
    """Patch rows/columns the shard partition stranded (shared by the
    compact and incremental matchers); appends to ``out`` in place."""
    n = row_used.shape[0]
    free_rows = np.flatnonzero(~row_used & np.isin(np.arange(n), cand))
    if not free_rows.size:
        return
    for cols_g in keep_cols:
        for c in cols_g:
            if col_used[c]:
                continue
            g = col_group[c]
            best = int(np.argmax(vals[free_rows, g]))
            if vals[free_rows[best], g] > 0.0:
                r = int(free_rows[best])
                out.append((r, int(c)))
                row_used[r] = True
                col_used[c] = True
                free_rows = np.delete(free_rows, best)
                if free_rows.size == 0:
                    return
        if free_rows.size == 0:
            return


def sharded_match_compact(values: np.ndarray, col_group: np.ndarray, *,
                          shard_size: int = 256, min_weight: float = 0.0,
                          row_slack: int = 16,
                          greedy_repair: bool = True) -> list[tuple[int, int]]:
    """Sharded maximum-weight matching on the compact form.

    ``values``: (n_rows, u) — weight of pairing row i with any column of
    group g (columns inside a group are identical/interchangeable).
    ``col_group``: (m,) — group id per real column.  Returns real
    (row, col) pairs.  Never materializes the dense (n × m) matrix, so it
    stays cheap at 20k devices × thousands of jobs.
    """
    values = np.asarray(values, np.float64)
    col_group = np.asarray(col_group, np.int64)
    n, u = values.shape
    m = col_group.shape[0]
    if n == 0 or m == 0:
        return []
    vals = values.copy()
    if min_weight > 0.0:
        vals[vals < min_weight] = 0.0
    cap = min(n, m)
    # FIFO column cap per group: at most `cap` columns of a group can match
    keep_cols = [np.flatnonzero(col_group == g)[:cap] for g in range(u)]
    kept = int(sum(len(c) for c in keep_cols))
    # candidate rows: union of per-group top-k (k = matchable pairs)
    k = min(n, kept)
    if n > k:
        cand_mask = np.zeros(n, bool)
        for g in range(u):
            cand_mask[np.argpartition(-vals[:, g], k - 1)[:k]] = True
        cand = np.flatnonzero(cand_mask)
    else:
        cand = np.arange(n)
    size = max(len(cand), kept)
    if size <= shard_size:                       # small enough: one exact KM
        cols = np.sort(np.concatenate(keep_cols))
        pairs = km_match(vals[np.ix_(cand, np.arange(u))][:, col_group[cols]])
        return sorted((int(cand[r]), int(cols[c])) for r, c in pairs)
    n_shards = -(-size // shard_size)
    # deal rows and each group's columns round-robin so every shard sees a
    # proportional device/model mix; rows are stratified by preferred group
    # (then strength) so no shard is starved of devices that favor a model
    pref = np.argmax(vals[cand], axis=1)
    row_order = cand[np.lexsort((-vals[cand].max(axis=1), pref))]
    row_shards = [row_order[s::n_shards] for s in range(n_shards)]
    col_shards: list[list[int]] = [[] for _ in range(n_shards)]
    for g in range(u):
        for j, c in enumerate(keep_cols[g]):
            col_shards[(j + g) % n_shards].append(int(c))
    out: list[tuple[int, int]] = []
    row_used = np.zeros(n, bool)
    col_used = np.zeros(m, bool)
    for s in range(n_shards):
        rows_s, cols_s = row_shards[s], np.asarray(col_shards[s], np.int64)
        if rows_s.size == 0 or cols_s.size == 0:
            continue
        grp_s = col_group[cols_s]
        rows_k = (_prune_row_heavy(vals, rows_s, grp_s, row_slack)
                  if rows_s.size > 2 * cols_s.size else rows_s)
        pairs = km_match(vals[rows_k[:, None], grp_s[None, :]])
        for r, c in pairs:
            out.append((int(rows_k[r]), int(cols_s[c])))
            row_used[rows_k[r]] = True
            col_used[cols_s[c]] = True
    if greedy_repair:
        # shards can strand a few rows/columns; greedily patch the remainder
        _greedy_repair(vals, col_group, keep_cols, cand, out, row_used,
                       col_used)
    return sorted(out)


def sharded_match(weights: np.ndarray, *, shard_size: int = 256,
                  min_weight: float = 0.0, row_slack: int = 16,
                  greedy_repair: bool = True) -> list[tuple[int, int]]:
    """Sharded maximum-weight matching on an explicit weight matrix.

    Equivalent to :func:`km_match` (exact) whenever the problem fits in one
    shard; at larger sizes it partitions into bounded sub-problems and stays
    within ~1 % of the dense optimum on scheduler-shaped instances (few
    distinct column groups).  Weights below ``min_weight`` are pruned to 0.
    """
    w = np.asarray(weights, np.float64)
    if w.size == 0:
        return []
    if min_weight > 0.0:
        w = w.copy()
        w[w < min_weight] = 0.0
    if max(w.shape) <= shard_size:
        return sorted(km_match(w))
    values, col_group = _group_duplicate_columns(w)
    return sharded_match_compact(values, col_group, shard_size=shard_size,
                                 row_slack=row_slack,
                                 greedy_repair=greedy_repair)


# ---------------------------------------------------------------------------
# Incremental (warm-started) sharded matching
# ---------------------------------------------------------------------------


def _stable_row_hash(ids: np.ndarray) -> np.ndarray:
    """Deterministic 64-bit mix (splitmix64 finalizer) of row/device ids —
    the shard deal must depend only on the id, never on round-varying
    values, so that a device keeps its shard across scheduling rounds."""
    x = np.asarray(ids, np.uint64).copy()
    x ^= x >> np.uint64(30)
    x *= np.uint64(0xBF58476D1CE4E5B9)
    x ^= x >> np.uint64(27)
    x *= np.uint64(0x94D049BB133111EB)
    x ^= x >> np.uint64(31)
    return x


class IncrementalMatcher:
    """Warm-started sharded maximum-weight matching, exact by construction.

    The scheduler re-solves the (free devices × pending jobs) matching every
    round even though, in steady state, most of the bipartite problem is
    unchanged: the same devices are free with the same (quantized) weight
    rows, and the backlog's per-model column counts are stable.  This
    matcher persists per-shard solutions across rounds:

    * rows (devices) are dealt to shards by a **stable hash of their id** —
      not by round-varying value orderings — so a device's shard never
      changes while the shard count is stable;
    * each group's columns are dealt round-robin exactly like
      :func:`sharded_match_compact`, and within a shard only the *count*
      per group matters (columns of a group are interchangeable);
    * a shard's sub-problem is keyed by its exact content (row ids, their
      weight rows, the dealt group layout).  A key hit replays the stored
      local solution; a miss solves the shard with exact KM.  Either way
      the result is **identical to a cold solve of the current inputs** —
      the cache can only skip recomputation of an identical sub-problem,
      never change an answer — which is what lets both simulator engines
      (and the warm-vs-cold tests) rely on bitwise-equal assignments.

    When the dirty fraction (key misses / non-empty shards) exceeds
    ``full_solve_dirty_frac`` the round is treated as a full re-solve and
    the cache is rebuilt from scratch; the cache always holds exactly the
    previous round's shards, so memory is bounded by one round.
    """

    def __init__(self, *, shard_size: int = 256, row_slack: int = 16,
                 greedy_repair: bool = True,
                 full_solve_dirty_frac: float = 0.5):
        self.shard_size = shard_size
        self.row_slack = row_slack
        self.greedy_repair = greedy_repair
        self.full_solve_dirty_frac = full_solve_dirty_frac
        self._cache: dict[bytes, list[tuple[int, int]]] = {}
        self._n_shards: int | None = None
        # counters for benchmarks/telemetry
        self.rounds = 0
        self.shards_solved = 0
        self.shards_reused = 0
        self.full_solves = 0

    # ------------------------------------------------------------------ api
    def match(self, values: np.ndarray, col_group: np.ndarray,
              row_ids: np.ndarray, *, shard_size: int | None = None,
              row_slack: int | None = None) -> list[tuple[int, int]]:
        """Maximum-weight matching on the compact form (see
        :func:`sharded_match_compact`); returns real (row, col) pairs.
        ``row_ids`` are stable per-row identities (device ids).  Callers
        with a per-round :class:`SchedulerConfig` pass its
        ``shard_size``/``row_slack`` so policy settings are honored (stale
        cache entries keyed under other settings simply miss)."""
        if shard_size is not None:
            self.shard_size = shard_size
        if row_slack is not None:
            self.row_slack = row_slack
        vals = np.asarray(values, np.float64)
        col_group = np.asarray(col_group, np.int64)
        row_ids = np.asarray(row_ids, np.int64)
        n, u = vals.shape
        m = col_group.shape[0]
        if n == 0 or m == 0:
            return []
        self.rounds += 1
        cap = min(n, m)
        keep_cols = [np.flatnonzero(col_group == g)[:cap] for g in range(u)]
        kept = int(sum(len(c) for c in keep_cols))
        # candidate rows: union of per-group top-k (argpartition is a pure
        # function of the value array, so identical rounds key identically)
        k = min(n, kept)
        if n > k:
            cand_mask = np.zeros(n, bool)
            for g in range(u):
                cand_mask[np.argpartition(-vals[:, g], k - 1)[:k]] = True
            cand = np.flatnonzero(cand_mask)
        else:
            cand = np.arange(n)
        size = max(len(cand), kept)
        if size <= self.shard_size:                 # small: one exact KM
            cols = np.sort(np.concatenate(keep_cols))
            pairs = km_match(vals[np.ix_(cand, np.arange(u))]
                             [:, col_group[cols]])
            return sorted((int(cand[r]), int(cols[c])) for r, c in pairs)
        n_shards = -(-size // self.shard_size)
        if n_shards != self._n_shards:
            self._cache.clear()
            self._n_shards = n_shards
        shard_of = _stable_row_hash(row_ids[cand]) % np.uint64(n_shards)
        col_shards: list[list[int]] = [[] for _ in range(n_shards)]
        for g in range(u):
            for j, c in enumerate(keep_cols[g]):
                col_shards[(j + g) % n_shards].append(int(c))
        # plan every shard first so the dirty fraction is known up front
        plans = []
        n_dirty = 0
        for s in range(n_shards):
            rows_s = cand[shard_of == np.uint64(s)]
            cols_s = np.asarray(col_shards[s], np.int64)
            if rows_s.size == 0 or cols_s.size == 0:
                continue
            grp_s = col_group[cols_s]
            rows_k = (_prune_row_heavy(vals, rows_s, grp_s, self.row_slack)
                      if rows_s.size > 2 * cols_s.size else rows_s)
            key = hashlib.blake2b(
                row_ids[rows_k].tobytes() + b"|" + vals[rows_k].tobytes()
                + b"|" + grp_s.tobytes(), digest_size=16).digest()
            cached = self._cache.get(key)
            if cached is None:
                n_dirty += 1
            plans.append((key, rows_k, cols_s, grp_s, cached))
        if plans and n_dirty / len(plans) > self.full_solve_dirty_frac:
            # mostly-changed round: rebuild from scratch
            self._cache.clear()
            self.full_solves += 1
            plans = [(key, rows_k, cols_s, grp_s, None)
                     for key, rows_k, cols_s, grp_s, _ in plans]
        out: list[tuple[int, int]] = []
        row_used = np.zeros(n, bool)
        col_used = np.zeros(m, bool)
        new_cache: dict[bytes, list[tuple[int, int]]] = {}
        for key, rows_k, cols_s, grp_s, cached in plans:
            if cached is None:
                # local pairs are stored positionally: (row slot, col slot)
                # — the key pins the rows and the group layout, and columns
                # of a group are interchangeable, so replaying positions on
                # this round's column ids reproduces a cold solve exactly
                cached = km_match(vals[rows_k[:, None], grp_s[None, :]])
                self.shards_solved += 1
            else:
                self.shards_reused += 1
            new_cache[key] = cached
            for r, c in cached:
                out.append((int(rows_k[r]), int(cols_s[c])))
                row_used[rows_k[r]] = True
                col_used[cols_s[c]] = True
        self._cache = new_cache
        if self.greedy_repair:
            # shards can strand a few rows/columns; greedily patch the rest
            _greedy_repair(vals, col_group, keep_cols, cand, out, row_used,
                           col_used)
        return sorted(out)

    def stats(self) -> dict:
        return {"rounds": self.rounds, "shards_solved": self.shards_solved,
                "shards_reused": self.shards_reused,
                "full_solves": self.full_solves,
                "cached_shards": len(self._cache)}


def brute_force_match(weights: np.ndarray) -> float:
    """Exponential oracle for tests (n <= ~8): best total weight over all
    injective partial assignments."""
    w = np.asarray(weights, dtype=np.float64)
    n_r, n_c = w.shape
    best = 0.0
    cols = list(range(n_c))
    k = min(n_r, n_c)
    for rows in itertools.combinations(range(n_r), k):
        for perm in itertools.permutations(cols, k):
            s = sum(max(w[r, c], 0.0) for r, c in zip(rows, perm))
            best = max(best, s)
    return best

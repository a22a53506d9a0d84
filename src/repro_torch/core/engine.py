"""Vectorized pod-scale scoring engine (ROADMAP: Perf).

``repro_torch.core.actions.enumerate_actions`` is the pure-Python reference for
the paper's Phase-II decision (§III-C): enumerate feasible joint actions,
score each with Eq. (1), pick the argmin.  At the paper's node scale
(M=4, K=2) it is cheap; at pod scale (M=16, K=4, 17-job windows) its
per-candidate ``score()`` call and first-fit replay dominate decision
time.  This module reimplements both the exact and the beam path as
batched numpy computation:

  * a scheduling window becomes a ``_SpecTable`` of per-(job, mode)
    columns (unit counts, ``e_norm`` deviations, ``t_norm·g`` loads),
  * Eq. (1) scores for whole candidate batches are one vector expression,
  * placement feasibility replays the simulator's domain-spreading
    first-fit on an *integer bitmask* of the free map (shift/AND finds
    every contiguous run), memoized per count-multiset — thousands of
    candidates share a handful of multisets,
  * beam rounds become batched extend → dedupe → score → stable top-k.

The engine is parity-locked against the reference: identical candidate
order, identical argmin action, scores within 1e-9 (tests/test_engine.py
property-checks this over seeded random node states).  ``EcoSched``
consumes it through ``enumerate_scored`` + ``ScoredBatch.best_index`` so
the argmin never materializes Python tuples for the full action space.

At cluster scale the same decision recurs across events; ``DecisionCache``
memoizes spec tables, placement oracles and whole scored batches on
name-free structural keys so repeated decisions cost a dict lookup.
``ScoredBatch.padded_cols`` exposes the candidate matrices the
``kernels/score_reduce`` CUDA kernels reduce on the card, and
``ScoredBatch.device_cols`` keeps them there across cache hits.

Twin of ``repro.core.engine``: enumeration, placement replay and the
cache are carried over unchanged and give bit-identical batches.
"""
from __future__ import annotations

import copy
import itertools
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.actions import _space_estimate
from repro_torch.core.score import score
from repro_torch.core.types import JobSpec, ModeEstimate, NodeView

# Cap on elements per vectorized exact-path chunk; bounds peak memory when
# padded mode grids are much larger than the true action space.
_CHUNK_ELEMS = 2_000_000


def _mask_of(free_map: Sequence[bool]) -> int:
    """Free map as one integer (bit u set = unit u free)."""
    mask = 0
    for u, f in enumerate(free_map):
        if f:
            mask |= 1 << u
    return mask


# Window-shape-independent enumeration skeletons, shared across all spec
# tables: job combinations per (J, s) and padded mode grids per (mm, s).
_COMBO_MEMO: Dict[Tuple[int, int], np.ndarray] = {}
_GRID_MEMO: Dict[Tuple[int, int], np.ndarray] = {}


def _combos_of(J: int, s: int) -> np.ndarray:
    key = (J, s)
    hit = _COMBO_MEMO.get(key)
    if hit is None:
        if len(_COMBO_MEMO) > 256:
            _COMBO_MEMO.clear()
        hit = _COMBO_MEMO[key] = np.array(
            list(itertools.combinations(range(J), s)), dtype=np.int64
        )
    return hit


def _grid_of(mm: int, s: int) -> np.ndarray:
    key = (mm, s)
    hit = _GRID_MEMO.get(key)
    if hit is None:
        if len(_GRID_MEMO) > 256:
            _GRID_MEMO.clear()
        hit = _GRID_MEMO[key] = np.indices((mm,) * s).reshape(s, -1).T
    return hit


class PlacementOracle:
    """Memoized bitmask replay of ``PlacementState.allocate``.

    The free map is one integer (bit u set = unit u free); the feasible
    starts for a g-unit job are the set bits of ``m = mask & mask>>1 &
    ... & mask>>(g-1)``.  Start selection replicates the simulator's
    domain-spreading first-fit exactly: among feasible starts, minimize
    (home-domain occupancy, start) where the home domain is the
    least-occupied domain the range overlaps.  Feasibility of an action
    depends only on its count multiset, so verdicts are memoized per
    descending count tuple.
    """

    def __init__(
        self,
        free_map: Sequence[bool],
        domains: int,
        domain_jobs: Optional[Sequence[int]] = None,
    ):
        self._setup(_mask_of(free_map), len(free_map), domains, domain_jobs)

    @classmethod
    def from_mask(
        cls,
        mask: int,
        units: int,
        domains: int,
        domain_jobs: Optional[Sequence[int]] = None,
    ) -> "PlacementOracle":
        """Construct from an already-computed free-map bitmask (the
        ``DecisionCache`` key form, so cached oracles skip the bit loop)."""
        o = cls.__new__(cls)
        o._setup(mask, units, domains, domain_jobs)
        return o

    def _setup(self, mask, units, domains, domain_jobs):
        self.units = units
        self.domains = domains
        self.mask0 = mask
        self.occ0 = tuple(domain_jobs) if domain_jobs else (0,) * domains
        self._dom = [u * domains // units for u in range(units)]
        self._memo: Dict[Tuple[int, ...], bool] = {}

    def placeable(self, counts_desc: Tuple[int, ...]) -> bool:
        hit = self._memo.get(counts_desc)
        if hit is not None:
            return hit
        mask = self.mask0
        occ = list(self.occ0)
        ok = True
        for g in counts_desc:
            mask = self._alloc(mask, occ, g)
            if mask is None:
                ok = False
                break
        self._memo[counts_desc] = ok
        return ok

    def _alloc(self, mask: int, occ: List[int], g: int) -> Optional[int]:
        m = mask
        for i in range(1, g):
            m &= mask >> i
        if not m:
            return None
        best = None  # ((home occupancy, start), start, home)
        while m:
            s = (m & -m).bit_length() - 1
            d_lo = self._dom[s]
            d_hi = self._dom[s + g - 1]
            home = min(range(d_lo, d_hi + 1), key=lambda d: (occ[d], d))
            key = (occ[home], s)
            if best is None or key < best[0]:
                best = (key, s, home)
            if occ[home] == 0:
                break  # starts ascend: (0, s) is unbeatable
            m &= m - 1
        _, s, home = best
        occ[home] += 1
        return mask & ~(((1 << g) - 1) << s)


class _SpecTable:
    """Column-oriented view of one scheduling window's τ-filtered specs.

    Everything that depends only on the window *structure* — not on the
    node's placement state — lives here, including the exact path's full
    mode-valid candidate enumeration (``candidates``).  The table is what
    ``DecisionCache`` shares across events, so all of it is computed once
    per distinct window structure, not once per event.
    """

    def __init__(self, specs: Sequence[JobSpec]):
        self.specs = list(specs)
        J = len(self.specs)
        n_modes = [len(s.modes) for s in self.specs]
        self.mode_count = np.asarray(n_modes, dtype=np.int64)
        mm = max(n_modes) if J else 0
        self.max_modes = mm
        self.mode_g = np.zeros((J, mm), dtype=np.int64)
        self.mode_f = np.zeros((J, mm), dtype=np.int64)  # DVFS level per mode
        self.mode_dev = np.zeros((J, mm))  # e_norm - 1
        self.mode_load = np.zeros((J, mm))  # t_norm * g (lookahead proxy)
        for j, s in enumerate(self.specs):
            for k, m in enumerate(s.modes):
                self.mode_g[j, k] = m.g
                self.mode_f[j, k] = m.f
                self.mode_dev[j, k] = m.e_norm - 1.0
                self.mode_load[j, k] = m.t_norm * m.g
        # flattened (job, mode) pairs, job-major/mode-minor — the reference
        # path's iteration order
        self.pair_job = np.repeat(np.arange(J, dtype=np.int64), n_modes)
        self.pair_mode = (
            np.concatenate([np.arange(n, dtype=np.int64) for n in n_modes])
            if J
            else np.zeros(0, dtype=np.int64)
        )
        self.pair_g = self.mode_g[self.pair_job, self.pair_mode]
        self.pair_f = self.mode_f[self.pair_job, self.pair_mode]
        self.pair_dev = self.mode_dev[self.pair_job, self.pair_mode]
        self.pair_load = self.mode_load[self.pair_job, self.pair_mode]
        self._cand: Dict[int, Tuple[np.ndarray, ...]] = {}
        self._cap: "OrderedDict[Tuple[int, int], Optional[Tuple]]" = OrderedDict()
        self._est: Dict[Tuple[int, int], int] = {}

    def space_estimate(self, k_avail: int, exact_limit: int) -> int:
        """``actions._space_estimate`` memoized — it walks every job-count
        combination, which is itself non-trivial per event at pod scale."""
        key = (k_avail, exact_limit)
        hit = self._est.get(key)
        if hit is None:
            hit = self._est[key] = _space_estimate(
                [len(s.modes) for s in self.specs], k_avail, exact_limit
            )
        return hit

    def candidates(self, s: int) -> Tuple[np.ndarray, ...]:
        """All mode-valid size-``s`` candidates in reference order, with
        their per-candidate reductions precomputed (memoized per size):

            (job_mat (C, s), mode_mat (C, s), counts (C, s), tot (C,),
             dev_sum (C,), load_max (C,), load_min (C,))

        Only the exact path calls this, so C is bounded by ``exact_limit``
        (``_space_estimate`` counts exactly these rows).  The caller applies
        the state-dependent filters (``tot <= g_free``, placement) — both
        preserve this row order, which is the reference iteration order.
        """
        hit = self._cand.get(s)
        if hit is not None:
            return hit
        J = len(self.specs)
        mm = self.max_modes
        combos = _combos_of(J, s)  # (C, s) in reference order
        # (P, s) padded mode-index grid, last index fastest = product order
        grid = _grid_of(mm, s)
        P = len(grid)
        chunk = max(1, _CHUNK_ELEMS // max(P * s, 1))
        parts: List[Tuple[np.ndarray, np.ndarray]] = []
        for c0 in range(0, len(combos), chunk):
            cs = combos[c0 : c0 + chunk]
            jm = cs[:, None, :]  # (c, 1, s)
            gb = grid[None, :, :]  # (1, P, s)
            valid = (gb < self.mode_count[jm]).all(axis=2)  # (c, P)
            ci, pi = np.nonzero(valid)  # combo-major, product-minor
            if ci.size:
                parts.append((cs[ci], grid[pi]))
        if parts:
            job_mat = np.concatenate([p[0] for p in parts])
            mode_mat = np.concatenate([p[1] for p in parts])
        else:
            job_mat = np.zeros((0, s), dtype=np.int64)
            mode_mat = np.zeros((0, s), dtype=np.int64)
        counts = self.mode_g[job_mat, mode_mat]
        loads = self.mode_load[job_mat, mode_mat]
        out = (
            job_mat,
            mode_mat,
            counts,
            counts.sum(axis=1),
            self.mode_dev[job_mat, mode_mat].sum(axis=1),
            loads.max(axis=1, initial=-np.inf),
            loads.min(axis=1, initial=np.inf),
        )
        self._cand[s] = out
        return out

    def capacity(self, s: int, g_free: int) -> Optional[Tuple]:
        """``candidates(s)`` filtered to ``tot <= g_free``, with the count
        multisets pre-extracted for the placement oracle (memoized per
        (s, g_free) — g_free only takes node-fill values, so the layer is
        small).  Returns None when nothing fits, else

            (job_mat, mode_mat, counts, tot, dev_sum, load_max, load_min,
             multisets, inverse)

        where ``multisets[k]`` is the k-th distinct descending count tuple
        and ``inverse`` maps rows to multisets — a decision needs only one
        (memoized) oracle verdict per multiset, not per row.
        """
        key = (s, g_free)
        if key in self._cap:
            self._cap.move_to_end(key)
            return self._cap[key]
        job_mat, mode_mat, counts, tot, dev_sum, lmax, lmin = self.candidates(s)
        fit = tot <= g_free
        if not fit.any():
            entry = None
        else:
            job_mat, mode_mat, counts = job_mat[fit], mode_mat[fit], counts[fit]
            counts_desc = -np.sort(-counts, axis=1)
            # injective multiset code: base just above the largest count
            base = int(self.pair_g.max()) + 1 if len(self.pair_g) else 1
            weights = base ** np.arange(counts_desc.shape[1], dtype=np.int64)
            codes = counts_desc @ weights
            _, first, inv = np.unique(codes, return_index=True, return_inverse=True)
            multisets = [
                tuple(int(x) for x in counts_desc[i]) for i in first
            ]
            entry = (
                job_mat, mode_mat, counts, tot[fit], dev_sum[fit],
                lmax[fit], lmin[fit], multisets, inv,
            )
        self._cap[key] = entry
        if len(self._cap) > 64:
            self._cap.popitem(last=False)
        return entry


class DecisionCache:
    """Cross-event reuse for the repeated-decision hot path.

    Cluster-scale sweeps make the *same* decision over and over: consecutive
    scheduling events share windows, free maps recur as jobs cycle, and
    instances of one application carry identical Phase-I mode structures.
    Three LRU layers exploit that, all keyed on **structural** identity (job
    names stripped — the scored action space depends on names only through
    window position):

      * ``table``    — window structure -> ``_SpecTable``,
      * ``oracle``   — (units, domains, free-mask, occupancy) ->
                       ``PlacementOracle``; its count-multiset memo persists
                       across events instead of being rebuilt per invocation,
      * ``decision`` — (order-canonical window structure, free-mask,
                       occupancy, scoring params) -> (``ScoredBatch``,
                       producer permutation); a hit skips enumeration,
                       placement replay and scoring outright and rebinds
                       the batch to the current specs — the keys sort the
                       window's tokens (stably), so permuted waiting
                       windows share one entry.  A
                       permuted hit re-orders the stored rows into the
                       consumer window's reference order first (row order
                       carries the tie-break; see ``_reorder_hit``).

    Caching is *pure*: a hit returns arrays bit-identical to a rebuild
    (locked in tests/test_decision_cache.py), so schedules and energies are
    unchanged.  Every key is name-free, so one instance may be shared by
    many policies on identically-shaped nodes: fleet peers then
    serve each other's first-sight enumerations — at fleet scale a private
    cache never warms, because each node only ever sees a handful of jobs.
    Sharing changes hit rates, never schedules.
    """

    def __init__(
        self,
        max_tables: int = 512,
        max_oracles: int = 4096,
        max_decisions: int = 8192,
        max_structs: int = 100_000,
        max_launches: int = 65_536,
        max_frontiers: int = 16_384,
    ):
        self.max_tables = max_tables
        self.max_oracles = max_oracles
        self.max_decisions = max_decisions
        self.max_structs = max_structs
        self.max_launches = max_launches
        self.max_frontiers = max_frontiers
        # bumped whenever the token tables reset; anything keyed on tokens
        # (here and in EcoSched's launch memo) must be dropped with them
        self.epoch = 0
        self._tables: "OrderedDict[Tuple, _SpecTable]" = OrderedDict()
        self._oracles: "OrderedDict[Tuple, PlacementOracle]" = OrderedDict()
        self._decisions: "OrderedDict[Tuple, ScoredBatch]" = OrderedDict()
        # launch-level layers (EcoSched's memo, relocated here so fleet
        # peers sharing one cache serve each other's *decisions*, not just
        # each other's enumerations — a single node rarely repeats a
        # decision state, but 256 identically-shaped nodes repeat each
        # other's constantly):
        #   * _launches  — raw (order-sensitive) decision state -> final
        #     ((window position, g, f), ...) launch pairs; exact replay.
        #   * _frontiers — canonical (token-sorted) decision state -> the
        #     full argmin tie frontier in canonical-slot form; a permuted
        #     consumer re-breaks the tie in its own enumeration order
        #     (see ecosched._replay_frontier), which is exactly what its
        #     cold argmin would do.
        self._launches: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        self._frontiers: "OrderedDict[Tuple, Tuple]" = OrderedDict()
        # structure interning: each distinct per-job mode structure gets a
        # small int token, so window keys are tuples of ints (fast to hash
        # in the per-event hot path) instead of nested float tuples.  The
        # token table pins its specs so id() stays unique while cached.
        self._spec_tokens: Dict[int, Tuple[JobSpec, int]] = {}
        self._struct_ids: Dict[Tuple, int] = {}
        self.table_hits = self.table_misses = 0
        self.oracle_hits = self.oracle_misses = 0
        self.decision_hits = self.decision_misses = 0

    @staticmethod
    def structure_of(spec: JobSpec) -> Tuple:
        """Name-free mode structure: the (g, f, t_norm, e_norm) tuples —
        everything Eq. (1) scoring and placement can observe of a job.
        ``f`` distinguishes same-count modes at different DVFS levels; it
        is constant 0 on single-frequency specs, so interning behavior
        there is unchanged."""
        return tuple((m.g, m.f, m.t_norm, m.e_norm) for m in spec.modes)

    def spec_token(self, spec: JobSpec) -> int:
        entry = self._spec_tokens.get(id(spec))
        if entry is not None and entry[0] is spec:
            return entry[1]
        if len(self._spec_tokens) >= self.max_structs:
            self._reset_structures()  # bounds noisy-model per-instance growth
        struct = self.structure_of(spec)
        tok = self._struct_ids.setdefault(struct, len(self._struct_ids))
        self._spec_tokens[id(spec)] = (spec, tok)
        return tok

    def _reset_structures(self) -> None:
        """Drop the token tables and every token-keyed store.  Tokens are
        only unique within one epoch, so reusing a stale token-keyed entry
        after a reset could alias two different windows."""
        self._spec_tokens.clear()
        self._struct_ids.clear()
        self._tables.clear()
        self._decisions.clear()
        self._launches.clear()
        self._frontiers.clear()
        self.epoch += 1

    def window_key(self, specs: Sequence[JobSpec]) -> Tuple:
        """Name-free window structure as a tuple of interned tokens."""
        return tuple(self.spec_token(s) for s in specs)

    @staticmethod
    def canonical_order(wkey: Tuple) -> Optional[Tuple[int, ...]]:
        """Stable permutation sorting the window's tokens, or ``None`` when
        the window is already canonical (the overwhelmingly common case —
        repeats of the same window).  Keying decisions on the *sorted*
        tokens lets permuted waiting windows (same jobs, different queue
        order) hit the same cache entry.  A same-order hit shares the
        stored arrays outright; a *permuted* hit re-orders the stored rows
        into the current window's reference enumeration order and re-runs
        the (cheap, vectorized) row reductions in that order — row order
        is load-bearing, because exact score ties break to the earliest
        row, and normalized best modes tie by construction.  Replaying the
        producer's row order verbatim diverged from a cold enumeration on
        exactly those ties.  Stability matters: equal tokens keep their
        relative window order on both sides, so the position bijection
        between producer and consumer windows is well-defined."""
        if all(wkey[i] <= wkey[i + 1] for i in range(len(wkey) - 1)):
            return None
        return tuple(sorted(range(len(wkey)), key=wkey.__getitem__))

    def _get(self, store: OrderedDict, key):
        hit = store.get(key)
        if hit is not None:
            store.move_to_end(key)
        return hit

    def _put(self, store: OrderedDict, key, value, cap: int) -> None:
        store[key] = value
        if len(store) > cap:
            store.popitem(last=False)

    def table(self, key: Tuple, specs: Sequence[JobSpec]) -> Tuple["_SpecTable", bool]:
        """Returns (table, warm): ``warm`` is False on first sight of this
        window structure — callers then prefer the streaming enumeration,
        so one-shot structures never pay for reusable materialization."""
        t = self._get(self._tables, key)
        if t is None:
            self.table_misses += 1
            t = _SpecTable(specs)
            self._put(self._tables, key, t, self.max_tables)
            return t, False
        self.table_hits += 1
        return t, True

    def oracle(
        self, mask: int, units: int, domains: int, occ: Tuple[int, ...]
    ) -> PlacementOracle:
        key = (units, domains, mask, occ)
        o = self._get(self._oracles, key)
        if o is None:
            self.oracle_misses += 1
            o = PlacementOracle.from_mask(mask, units, domains, occ)
            self._put(self._oracles, key, o, self.max_oracles)
        else:
            self.oracle_hits += 1
        return o

    def decision(
        self, key: Tuple
    ) -> Optional[Tuple["ScoredBatch", Optional[Tuple[int, ...]]]]:
        """Stored entries are ``(batch, producer_order)`` pairs — the
        canonical-key permutation the batch was built under (``None`` for
        an already-canonical window); ``enumerate_scored`` needs it to map
        stored row positions onto a permuted hit's window."""
        b = self._get(self._decisions, key)
        if b is None:
            self.decision_misses += 1
        else:
            self.decision_hits += 1
        return b

    def store_decision(
        self,
        key: Tuple,
        entry: Tuple["ScoredBatch", Optional[Tuple[int, ...]]],
    ) -> None:
        self._put(self._decisions, key, entry, self.max_decisions)

    def launch(self, key: Tuple) -> Optional[Tuple]:
        """Raw-key launch replay: the final pair tuple for an exact repeat
        of a decision state (token order included), or None."""
        return self._get(self._launches, key)

    def store_launch(self, key: Tuple, pairs: Tuple) -> None:
        self._put(self._launches, key, pairs, self.max_launches)

    def frontier(self, key: Tuple) -> Optional[Tuple]:
        """Canonical-key tie frontier for a permuted repeat, or None."""
        return self._get(self._frontiers, key)

    def store_frontier(self, key: Tuple, cands: Tuple) -> None:
        self._put(self._frontiers, key, cands, self.max_frontiers)

    def stats(self) -> Dict[str, float]:
        def rate(h, m):
            return h / (h + m) if h + m else 0.0

        return {
            "table_hits": self.table_hits,
            "table_misses": self.table_misses,
            "table_hit_rate": rate(self.table_hits, self.table_misses),
            "oracle_hits": self.oracle_hits,
            "oracle_misses": self.oracle_misses,
            "oracle_hit_rate": rate(self.oracle_hits, self.oracle_misses),
            "decision_hits": self.decision_hits,
            "decision_misses": self.decision_misses,
            "decision_hit_rate": rate(self.decision_hits, self.decision_misses),
            "tables": len(self._tables),
            "oracles": len(self._oracles),
            "decisions": len(self._decisions),
            "launches": len(self._launches),
            "frontiers": len(self._frontiers),
        }


# One enumeration block: actions of a single size s as column arrays.
# (scores, total_g, spread, job_mat (B, s), mode_mat (B, s))
_Block = Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]


class ScoredBatch:
    """Array-backed scored action set; rows follow the reference order."""

    def __init__(
        self,
        specs: Sequence[JobSpec],
        blocks: List[_Block],
        table: Optional[_SpecTable] = None,
    ):
        self.specs = list(specs)
        self._blocks = blocks
        self._table = table
        # exact-path batches carry the reference row order and can be
        # re-ordered onto a permuted window; beam batches cannot (beam
        # pruning is itself window-order dependent)
        self.exact = True
        self._padded: Optional[Tuple[np.ndarray, ...]] = None
        self._padded_f: Optional[np.ndarray] = None
        # device copies of the padded planes, keyed (device, with_f); the
        # dict itself is shared by every ``rebind`` clone, so a cache hit
        # reuses the upload of the batch it was bound from
        self._device_memo: Dict[Tuple[str, bool], Dict[str, torch.Tensor]] = {}
        self._best_memo: Dict[Tuple[float, bool], Optional[int]] = {}
        self._spread: Optional[np.ndarray] = None
        self._n_jobs: Optional[np.ndarray] = None
        self.scores = np.concatenate([b[0] for b in blocks])
        self.total_g = np.concatenate([b[1] for b in blocks])
        self._starts = np.cumsum([0] + [len(b[0]) for b in blocks])

    def __len__(self) -> int:
        return len(self.scores)

    @property
    def spread(self) -> np.ndarray:
        """Per-candidate load spread (lookahead penalty term); lazy — only
        lookahead-enabled policies ever touch it."""
        if self._spread is None:
            self._spread = np.concatenate([b[2] for b in self._blocks])
        return self._spread

    @property
    def n_jobs(self) -> np.ndarray:
        """Per-candidate action size; lazy — the common path only checks
        row 0 (the empty action is always the first row)."""
        if self._n_jobs is None:
            self._n_jobs = np.concatenate(
                [
                    np.full(len(b[0]), b[3].shape[1], dtype=np.int64)
                    for b in self._blocks
                ]
            )
        return self._n_jobs

    def rebind(self, specs: Sequence[JobSpec]) -> "ScoredBatch":
        """Shallow copy bound to a new window with the identical per-job mode
        structure (names may differ) — a ``DecisionCache`` hit reuses every
        array, only ``action()`` reconstruction sees the new names."""
        clone = copy.copy(self)
        clone.specs = list(specs)
        return clone

    def padded_cols(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Per-candidate slot columns ``(dev, g, n)`` for the score-reduce
        kernels: ``dev``/``g`` are (B, S) float32 padded with
        zeros past each action's size, ``n`` is the action size.  Memoized —
        decision-cache hits reuse the padded arrays too (``rebind`` shares
        them)."""
        if self._padded is None:
            B = len(self.scores)
            S = max((b[3].shape[1] for b in self._blocks), default=0) or 1
            dev = np.zeros((B, S), dtype=np.float32)
            g = np.zeros((B, S), dtype=np.float32)
            for start, blk in zip(self._starts, self._blocks):
                _, _, _, job_mat, mode_mat = blk
                s = job_mat.shape[1]
                if s == 0:
                    continue
                rows = slice(start, start + len(blk[0]))
                dev[rows, :s] = self._table.mode_dev[job_mat, mode_mat]
                g[rows, :s] = self._table.mode_g[job_mat, mode_mat]
            self._padded = (dev, g, self.n_jobs.astype(np.float32))
        return self._padded

    def padded_f(self) -> np.ndarray:
        """Per-candidate slot frequency levels, (B, S) float32 zero-padded —
        the kernel backend's frequency axis.  Kept separate from
        ``padded_cols`` (same memoize-through-``rebind`` behavior) so the
        single-frequency fast path never materializes an all-zero plane
        twice."""
        if self._padded_f is None:
            B = len(self.scores)
            S = max((b[3].shape[1] for b in self._blocks), default=0) or 1
            fcol = np.zeros((B, S), dtype=np.float32)
            for start, blk in zip(self._starts, self._blocks):
                _, _, _, job_mat, mode_mat = blk
                s = job_mat.shape[1]
                if s == 0:
                    continue
                rows = slice(start, start + len(blk[0]))
                fcol[rows, :s] = self._table.mode_f[job_mat, mode_mat]
            self._padded_f = fcol
        return self._padded_f

    def device_cols(self, device, with_f: bool = False) -> Dict[str, torch.Tensor]:
        """The kernel inputs as float32 tensors on ``device``: ``dev``/``g``
        (and ``f`` when ``with_f``) (B, S) from ``padded_cols``/
        ``padded_f``, ``n`` (B,), and ``nonempty`` (B,) = 1.0 where
        ``n > 0`` (the idle-node guard's mask).  All are views of one
        buffer uploaded in one copy, memoized per (device, with_f) and
        shared through ``rebind``."""
        key = (str(device), bool(with_f))
        hit = self._device_memo.get(key)
        if hit is None:
            dev, g, n = self.padded_cols()
            B, S = dev.shape
            planes = [dev, g] + ([self.padded_f()] if with_f else [])
            host = np.concatenate(
                [p.ravel() for p in planes] + [n, (n > 0).astype(np.float32)]
            )
            buf = torch.from_numpy(host).to(device)
            at = len(planes) * B * S
            hit = dict(
                dev=buf[:B * S].view(B, S),
                g=buf[B * S:2 * B * S].view(B, S),
                f=buf[2 * B * S:at].view(B, S) if with_f else None,
                n=buf[at:at + B],
                nonempty=buf[at + B:at + 2 * B],
            )
            self._device_memo[key] = hit
        return hit

    def action(self, i: int) -> Tuple[Tuple[JobSpec, ModeEstimate], ...]:
        b = int(np.searchsorted(self._starts, i, side="right")) - 1
        row = i - self._starts[b]
        _, _, _, job_mat, mode_mat = self._blocks[b]
        return tuple(
            (self.specs[j], self.specs[j].modes[k])
            for j, k in zip(job_mat[row], mode_mat[row])
        )

    def row_pairs(self, i: int) -> Tuple[Tuple[int, int], ...]:
        """Name-free form of ``action(i)``: (window position, mode index)
        pairs — what the launch-memo layers store and replay."""
        b = int(np.searchsorted(self._starts, i, side="right")) - 1
        row = i - self._starts[b]
        _, _, _, job_mat, mode_mat = self._blocks[b]
        return tuple(
            (int(j), int(k)) for j, k in zip(job_mat[row], mode_mat[row])
        )

    def to_list(self):
        """Reference-format [(score, action), ...] — for parity tests."""
        return [(float(self.scores[i]), self.action(i)) for i in range(len(self))]

    def best_index(
        self, scores: Optional[np.ndarray] = None, *, nonempty: bool = False
    ) -> Optional[int]:
        """Argmin under the policy's tie-break: lowest score, then largest
        total unit count, then earliest generation order — exactly what a
        stable sort by (score, -total_g) over the reference list picks."""
        sc = self.scores if scores is None else scores
        idxs = np.flatnonzero(self.n_jobs > 0) if nonempty else np.arange(len(sc))
        if idxs.size == 0:
            return None
        sub = sc[idxs]
        tie = idxs[sub == sub.min()]
        return int(tie[np.argmax(self.total_g[tie])])

    def best_cached(
        self, lookahead: float = 0.0, *, nonempty: bool = False
    ) -> Optional[int]:
        """``best_index`` memoized per (lookahead, nonempty): the winner is a
        pure function of the batch arrays, so decision-cache hits (which
        share the memo through ``rebind``) skip the argmin too."""
        key = (lookahead, nonempty)
        if key not in self._best_memo:
            sc = (
                self.scores + lookahead * self.spread
                if lookahead
                else None
            )
            self._best_memo[key] = self.best_index(sc, nonempty=nonempty)
        return self._best_memo[key]


def enumerate_scored(
    specs: Sequence[JobSpec],
    view: NodeView,
    free_map: List[bool],
    *,
    lam: float,
    lam_f: float = 0.0,
    exact_limit: int = 50_000,
    beam: int = 64,
    cache: Optional[DecisionCache] = None,
) -> ScoredBatch:
    """Vectorized twin of ``actions.enumerate_actions`` (same feasible set,
    same scores, same row order).  With ``cache``, repeated decisions —
    same window structure on the same placement state — return the cached
    ``ScoredBatch`` without enumerating anything."""
    specs = list(specs)
    k_avail = view.domains - view.occupied_domains
    g_free = view.free_units
    # degraded nodes (fault plane) score over alive capacity; M is part of
    # the decision key below, so healthy and degraded states never collide
    M = view.alive_units
    if k_avail <= 0 or not specs:
        return ScoredBatch(
            specs,
            [_empty_block(score((), g_free=g_free, M=M, lam=lam, lam_f=lam_f))],
        )
    dkey = None
    order = None
    warm = False
    if cache is not None:
        wkey = cache.window_key(specs)
        mask = _mask_of(free_map)
        occ = tuple(view.domain_jobs) if view.domain_jobs else (0,) * view.domains
        # order-canonical decision key: permuted windows share one entry
        order = cache.canonical_order(wkey)
        ckey = wkey if order is None else tuple(wkey[i] for i in order)
        dkey = (ckey, mask, occ, g_free, M, lam, lam_f, exact_limit, beam)
        hit = cache.decision(dkey)
        if hit is not None:
            batch, st_order = hit
            if st_order == order:
                return batch.rebind(specs)
            reordered = _reorder_hit(
                batch, specs, st_order, order, cache, wkey,
                g_free=g_free, M=M, lam=lam, lam_f=lam_f,
            )
            if reordered is not None:
                return reordered
            # beam batch on a permuted window: fall through to a fresh
            # enumeration (beam row order is window-order dependent)
        table, warm = cache.table(wkey, specs)
        oracle = cache.oracle(mask, len(free_map), view.domains, occ)
    else:
        table = _SpecTable(specs)
        oracle = PlacementOracle(free_map, view.domains, view.domain_jobs)
    empty = _empty_block(score((), g_free=g_free, M=M, lam=lam, lam_f=lam_f))
    est = table.space_estimate(k_avail, exact_limit)
    if est <= exact_limit:
        blocks = _exact_blocks(
            table, oracle, k_avail, g_free, M, lam, lam_f=lam_f, reuse=warm
        )
    else:
        blocks = _beam_blocks(
            table, oracle, k_avail, g_free, M, lam, beam, lam_f=lam_f
        )
    batch = ScoredBatch(specs, [empty] + blocks, table=table)
    batch.exact = est <= exact_limit
    if dkey is not None:
        cache.store_decision(dkey, (batch, order))
    return batch


def _reorder_hit(
    batch: "ScoredBatch",
    specs: Sequence[JobSpec],
    st_order: Optional[Tuple[int, ...]],
    order: Optional[Tuple[int, ...]],
    cache: DecisionCache,
    wkey: Tuple,
    *,
    g_free: int,
    M: int,
    lam: float,
    lam_f: float,
) -> Optional["ScoredBatch"]:
    """Bind a cached batch built from a *permutation* of this window:
    remap its rows into this window's reference enumeration order and
    recompute the row reductions in that order.

    Row order is semantic — exact score ties break to the earliest row,
    and the reference order is a pure function of window order (size-s
    rows sort lexicographically by (ascending position tuple, mode
    tuple)).  Replaying the producer's rows verbatim resolved ties in the
    *producer's* window order, which diverged from a cold enumeration
    whenever two structures tied exactly (normalized best modes all score
    dev=0, so cross-app ties are structural, not accidental).  The
    reductions are also re-run here so float sums accumulate in this
    window's slot order — everything downstream is bit-identical to a
    fresh enumeration, at the cost of one gather per block.

    Canonical slot ``c`` holds the stored window's position
    ``st_order[c]`` and this window's position ``order[c]`` — both carry
    the same token, so the position bijection is pure.  Returns None for
    beam batches, whose row set itself depends on window order."""
    if not batch.exact:
        return None
    J = len(specs)
    cur = order if order is not None else tuple(range(J))
    st = st_order if st_order is not None else tuple(range(J))
    pi = np.empty(J, dtype=np.int64)
    for c in range(J):
        pi[st[c]] = cur[c]
    table, _ = cache.table(wkey, specs)
    blocks: List[_Block] = []
    for blk in batch._blocks:
        scores, tot, spread, job_mat, mode_mat = blk
        s = job_mat.shape[1]
        if s == 0:
            blocks.append(blk)  # the empty action: state-only, order-free
            continue
        cpos = pi[job_mat]
        within = np.argsort(cpos, axis=1, kind="stable")
        cpos = np.take_along_axis(cpos, within, axis=1)
        cmode = np.take_along_axis(mode_mat, within, axis=1)
        # reference order = lex by (position tuple, mode tuple), most
        # significant first; np.lexsort takes least-significant first
        keys = tuple(cmode[:, k] for k in range(s - 1, -1, -1)) + tuple(
            cpos[:, k] for k in range(s - 1, -1, -1)
        )
        perm = np.lexsort(keys)
        job_mat = cpos[perm]
        mode_mat = cmode[perm]
        dev = table.mode_dev[job_mat, mode_mat]
        tot2 = table.mode_g[job_mat, mode_mat].sum(axis=1)
        sc = dev.sum(axis=1) / s + lam * ((g_free - tot2) / M)
        if lam_f:
            sc = sc + lam_f * (
                table.mode_f[job_mat, mode_mat].sum(axis=1) / s
            )
        loads = table.mode_load[job_mat, mode_mat]
        spread2 = _spread(loads.max(axis=1), loads.min(axis=1), s)
        blocks.append((sc, tot2, spread2, job_mat, mode_mat))
    return ScoredBatch(specs, blocks, table=table)


def _empty_block(empty_score: float) -> _Block:
    return (
        np.array([empty_score]),
        np.zeros(1, dtype=np.int64),
        np.zeros(1),
        np.zeros((1, 0), dtype=np.int64),
        np.zeros((1, 0), dtype=np.int64),
    )


def _placeable_rows(oracle: PlacementOracle, counts: np.ndarray) -> np.ndarray:
    """Feasibility mask for a (B, s) count matrix.

    Feasibility depends only on the count *multiset*, so rows are encoded
    as one base-(units+1) integer each and the oracle runs once per
    distinct code — thousands of candidates share a handful of multisets.
    """
    counts_desc = -np.sort(-counts, axis=1)
    base = oracle.units + 1
    weights = base ** np.arange(counts_desc.shape[1], dtype=np.int64)
    codes = counts_desc @ weights
    uniq, first, inv = np.unique(codes, return_index=True, return_inverse=True)
    uok = np.fromiter(
        (
            oracle.placeable(tuple(int(g) for g in counts_desc[i]))
            for i in first
        ),
        dtype=bool,
        count=len(first),
    )
    return uok[inv]


def _spread(lmax: np.ndarray, lmin: np.ndarray, size: int) -> np.ndarray:
    """Completion-alignment proxy (EcoSched lookahead): load spread."""
    if size < 2:
        return np.zeros(len(lmax))
    return (lmax - lmin) / np.maximum(lmax, 1e-9)


def _exact_blocks(
    table: _SpecTable,
    oracle: PlacementOracle,
    k_avail: int,
    g_free: int,
    M: int,
    lam: float,
    *,
    lam_f: float = 0.0,
    reuse: bool = False,
) -> List[_Block]:
    """Exact path.  ``reuse=False`` (one-shot tables) streams the candidate
    grid chunk-by-chunk with the capacity filter applied inline — nothing
    larger than a chunk materializes.  ``reuse=True`` (cached tables)
    slices the table's memoized full enumeration instead: on a table-cache
    hit the combinatorial construction is gone and per event only the
    capacity mask, the (memoized) placement verdicts and two vector
    expressions remain.  Both produce the identical block row order."""
    if reuse:
        return _exact_blocks_cached(
            table, oracle, k_avail, g_free, M, lam, lam_f=lam_f
        )
    J = len(table.specs)
    mm = table.max_modes
    out: List[_Block] = []
    for s in range(1, min(k_avail, J) + 1):
        combos = np.array(
            list(itertools.combinations(range(J), s)), dtype=np.int64
        )  # (C, s) in reference order
        # (P, s) padded mode-index grid, last index fastest = product order
        grid = np.indices((mm,) * s).reshape(s, -1).T
        P = len(grid)
        chunk = max(1, _CHUNK_ELEMS // max(P * s, 1))
        parts: List[Tuple[np.ndarray, ...]] = []
        for c0 in range(0, len(combos), chunk):
            cs = combos[c0 : c0 + chunk]
            jm = cs[:, None, :]  # (c, 1, s)
            gb = grid[None, :, :]  # (1, P, s)
            valid = (gb < table.mode_count[jm]).all(axis=2)  # (c, P)
            g = table.mode_g[jm, gb]  # (c, P, s)
            tot = g.sum(axis=2)
            ok = valid & (tot <= g_free)
            ci, pi = np.nonzero(ok)  # row-major == combo-major, product-minor
            if ci.size == 0:
                continue
            parts.append((cs[ci], grid[pi], g[ci, pi]))
        if not parts:
            continue
        job_mat = np.concatenate([p[0] for p in parts])
        mode_mat = np.concatenate([p[1] for p in parts])
        counts = np.concatenate([p[2] for p in parts])
        keep = _placeable_rows(oracle, counts)
        if not keep.any():
            continue
        job_mat, mode_mat, counts = job_mat[keep], mode_mat[keep], counts[keep]
        dev = table.mode_dev[job_mat, mode_mat]
        loads = table.mode_load[job_mat, mode_mat]
        tot = counts.sum(axis=1)
        scores = dev.sum(axis=1) / s + lam * ((g_free - tot) / M)
        if lam_f:
            scores = scores + lam_f * (
                table.mode_f[job_mat, mode_mat].sum(axis=1) / s
            )
        spread = _spread(loads.max(axis=1), loads.min(axis=1), s)
        out.append((scores, tot, spread, job_mat, mode_mat))
    return out


def _exact_blocks_cached(
    table: _SpecTable,
    oracle: PlacementOracle,
    k_avail: int,
    g_free: int,
    M: int,
    lam: float,
    *,
    lam_f: float = 0.0,
) -> List[_Block]:
    J = len(table.specs)
    out: List[_Block] = []
    for s in range(1, min(k_avail, J) + 1):
        cap = table.capacity(s, g_free)
        if cap is None:
            continue
        job_mat, mode_mat, counts, tot, dev_sum, lmax, lmin, multisets, inv = cap
        uok = np.fromiter(
            (oracle.placeable(ms) for ms in multisets),
            dtype=bool,
            count=len(multisets),
        )
        keep = uok[inv]
        if not keep.any():
            continue
        job_mat, mode_mat = job_mat[keep], mode_mat[keep]
        tot_k = tot[keep]
        scores = dev_sum[keep] / s + lam * ((g_free - tot_k) / M)
        if lam_f:
            scores = scores + lam_f * (
                table.mode_f[job_mat, mode_mat].sum(axis=1) / s
            )
        spread = _spread(lmax[keep], lmin[keep], s)
        out.append((scores, tot_k, spread, job_mat, mode_mat))
    return out


def _beam_blocks(
    table: _SpecTable,
    oracle: PlacementOracle,
    k_avail: int,
    g_free: int,
    M: int,
    lam: float,
    beam: int,
    *,
    lam_f: float = 0.0,
) -> List[_Block]:
    J = len(table.specs)
    out: List[_Block] = []
    # A partial action's identity is its {(job, g, f)} set.  Encode each
    # member as (job·(maxg+1)+g)·(maxf+1)+f and the whole set as a base-B
    # little-endian integer over members in ascending order — order-free
    # and injective, so set equality becomes int64 equality and the dedupe
    # vectorizes.  Single-frequency windows have maxf = 0, collapsing the
    # member code and base to the historical job·(maxg+1)+g encoding.
    maxg = int(table.pair_g.max()) if len(table.pair_g) else 0
    maxf = int(table.pair_f.max()) if len(table.pair_f) else 0
    B = J * (maxg + 1) * (maxf + 1) + 1
    if float(B) ** k_avail >= 2**62:  # never at pod scale (17·17 base, K=4)
        raise OverflowError(
            f"action-set key space {B}^{k_avail} overflows int64; "
            "use the pure-Python reference path for windows this large"
        )
    pair_code = (
        table.pair_job * (maxg + 1) + table.pair_g
    ) * (maxf + 1) + table.pair_f
    # frontier = the single empty partial
    f_jobs = np.zeros((1, 0), dtype=np.int64)
    f_modes = np.zeros((1, 0), dtype=np.int64)
    f_counts = np.zeros((1, 0), dtype=np.int64)  # rows sorted descending
    f_codes = np.zeros((1, 0), dtype=np.int64)  # member codes, ascending
    f_dev = np.zeros(1)  # running Σ(e_norm-1) in extension order
    f_g = np.zeros(1, dtype=np.int64)
    f_fs = np.zeros(1, dtype=np.int64)  # running Σ frequency level
    f_lmax = np.full(1, -np.inf)
    f_lmin = np.full(1, np.inf)
    f_used = np.zeros((1, J), dtype=bool)
    for size in range(1, k_avail + 1):
        used = f_used[:, table.pair_job]  # (F, P)
        new_g = f_g[:, None] + table.pair_g[None, :]
        ok = ~used & (new_g <= g_free)
        fi, pi = np.nonzero(ok)  # frontier-major == reference iteration order
        if fi.size == 0:
            break
        # dedupe by {(job, g)} set, keep-first in iteration order: the same
        # action reached through different extension orders must occupy one
        # beam slot, not many.  Key = parent digits with the new member
        # code inserted at its sorted position.
        codes = f_codes[fi]  # (N, size-1), ascending member codes
        add = pair_code[pi]
        w = B ** np.arange(size - 1, dtype=np.int64)
        less = codes < add[:, None]
        low = (codes * w * less).sum(axis=1)
        high = (codes * w * ~less).sum(axis=1) * B
        keys = low + add * B ** less.sum(axis=1) + high
        _, first = np.unique(keys, return_index=True)
        kept = np.sort(first)  # back to generation order
        fi, pi = fi[kept], pi[kept]
        counts = np.concatenate([f_counts[fi], table.pair_g[pi][:, None]], axis=1)
        keep = _placeable_rows(oracle, counts)
        if not keep.any():
            break
        fi, pi, counts = fi[keep], pi[keep], counts[keep]
        pj, pg = table.pair_job, table.pair_g
        scores = (f_dev[fi] + table.pair_dev[pi]) / size + lam * (
            (g_free - (f_g[fi] + pg[pi])) / M
        )
        if lam_f:
            scores = scores + lam_f * ((f_fs[fi] + table.pair_f[pi]) / size)
        # stable top-k by score: ties keep generation order, like the
        # reference's stable list sort
        sel = np.argsort(scores, kind="stable")[:beam]
        fsel, psel = fi[sel], pi[sel]
        f_jobs = np.concatenate([f_jobs[fsel], pj[psel][:, None]], axis=1)
        f_modes = np.concatenate(
            [f_modes[fsel], table.pair_mode[psel][:, None]], axis=1
        )
        f_counts = -np.sort(-counts[sel], axis=1)
        f_codes = np.sort(
            np.concatenate([f_codes[fsel], pair_code[psel][:, None]], axis=1),
            axis=1,
        )
        f_dev = f_dev[fsel] + table.pair_dev[psel]
        f_g = f_g[fsel] + pg[psel]
        f_fs = f_fs[fsel] + table.pair_f[psel]
        f_lmax = np.maximum(f_lmax[fsel], table.pair_load[psel])
        f_lmin = np.minimum(f_lmin[fsel], table.pair_load[psel])
        f_used = f_used[fsel].copy()
        f_used[np.arange(len(fsel)), pj[psel]] = True
        out.append(
            (
                scores[sel],
                f_g.copy(),
                _spread(f_lmax, f_lmin, size),
                f_jobs.copy(),
                f_modes.copy(),
            )
        )
    return out

"""NUMA-domain-aware placement (paper §III-C).

Constraints enforced:
  * at most K *occupied* isolation domains (each job is homed in exactly
    one domain; a domain only hosts a second job when no empty domain is
    reachable),
  * a job's units are **contiguous** (on a GPU node contiguity is vacuous
    but harmless; the reference keeps it for its torus slices),
  * unit counts need NOT align with domain boundaries (paper: a 3-GPU job
    + 1-GPU job share a 2-domain node).

Allocation is **domain-spreading first-fit**: among all feasible contiguous
starts, prefer the one whose *home domain* (the least-occupied domain the
range overlaps) currently hosts the fewest jobs, breaking ties toward the
lowest start.  On an empty node this degenerates to plain first-fit, but
once jobs are running it steers new jobs away from occupied domains —
two co-running jobs never share CPU-side domain resources while another
domain sits empty, which is what the paper's NUMA-aware placement means.

``domain_jobs`` tracks actual per-domain occupancy (jobs homed in each
domain); callers that care about the K co-run cap should count occupied
domains, not running jobs, via ``occupied_domains()``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple


def domains_of_units(
    units: Sequence[int], total_units: int, domains: int
) -> Tuple[int, ...]:
    """Distinct isolation domains touched by a set of unit ids (ascending).

    A job homed in one domain can still *span* others when its contiguous
    range crosses a boundary (the paper's 3-GPU-on-a-2-domain-node case) —
    interference models key remote-traffic penalties on this.
    """
    return tuple(sorted({u * domains // total_units for u in units}))


class PlacementState:
    def __init__(self, units: int, domains: int):
        assert units >= 1 and domains >= 1
        self.units = units
        self.domains = domains
        self.free = [True] * units
        self.domain_jobs = [0] * domains  # jobs homed in each domain
        # fault plane: units lost to a node failure.  A dead
        # unit reads as occupied (free[u] = False), so allocation, the
        # contiguity scan, free_count() and therefore the idle-energy
        # integral all exclude it without touching any other code path.
        self.dead = [False] * units
        self._dead_n = 0

    def free_count(self) -> int:
        return sum(self.free)

    def dead_count(self) -> int:
        return self._dead_n

    def alive_units(self) -> int:
        return self.units - self._dead_n

    def mark_dead(self, ids) -> None:
        """Take failed units out of service.  The caller kills (and
        thereby frees) any job occupying them first."""
        for u in ids:
            assert self.free[u], f"unit {u} still occupied at failure"
            assert not self.dead[u], f"unit {u} already dead"
            self.free[u] = False
            self.dead[u] = True
            self._dead_n += 1

    def revive(self, ids) -> None:
        """Repaired units return to the free pool."""
        for u in ids:
            assert self.dead[u], f"unit {u} was not dead"
            self.dead[u] = False
            self.free[u] = True
            self._dead_n -= 1

    def occupied_domains(self) -> int:
        return sum(1 for c in self.domain_jobs if c)

    def domain_of_unit(self, u: int) -> int:
        return u * self.domains // self.units

    def _ranges(self) -> List[Tuple[int, int]]:
        """Maximal contiguous free (start, length) ranges."""
        out = []
        i = 0
        while i < self.units:
            if self.free[i]:
                j = i
                while j < self.units and self.free[j]:
                    j += 1
                out.append((i, j - i))
                i = j
            else:
                i += 1
        return out

    def can_allocate(self, g: int) -> bool:
        return any(length >= g for _, length in self._ranges())

    def max_contiguous(self) -> int:
        return max((length for _, length in self._ranges()), default=0)

    def _home_domain(self, start: int, g: int) -> int:
        """Least-occupied domain overlapped by [start, start+g)."""
        d_lo = self.domain_of_unit(start)
        d_hi = self.domain_of_unit(start + g - 1)
        return min(range(d_lo, d_hi + 1), key=lambda d: (self.domain_jobs[d], d))

    def allocate(self, g: int) -> Tuple[Tuple[int, ...], int]:
        """Domain-spreading first-fit contiguous allocation.

        Returns (unit ids, home domain).  The home domain's occupancy is
        incremented; pass it back to ``release`` when the job finishes.
        """
        best = None  # ((home occupancy, start), start, home)
        for start, length in self._ranges():
            for s in range(start, start + length - g + 1):
                home = self._home_domain(s, g)
                key = (self.domain_jobs[home], s)
                if best is None or key < best[0]:
                    best = (key, s, home)
                if self.domain_jobs[home] == 0:
                    break  # scanning right can't beat (0, s) within the range
            if best is not None and best[0][0] == 0:
                break  # later ranges have strictly larger starts
        if best is None:
            raise ValueError(f"cannot allocate {g} contiguous units (free={self.free})")
        _, s, home = best
        ids = tuple(range(s, s + g))
        for u in ids:
            self.free[u] = False
        self.domain_jobs[home] += 1
        return ids, home

    def release(self, ids, domain: Optional[int] = None) -> None:
        for u in ids:
            assert not self.free[u], f"double free of unit {u}"
            self.free[u] = True
        if domain is not None:
            assert self.domain_jobs[domain] > 0, f"release of empty domain {domain}"
            self.domain_jobs[domain] -= 1

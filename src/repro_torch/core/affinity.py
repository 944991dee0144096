"""CPU affinity / NUMA planner — paper §4.4.

Empirical rules from the paper (ARM Kunpeng 920 observations):
1. bind worker processes to explicit cores (avoid core-switch cost);
2. prefer cores with LARGE indices (the service framework and OS occupy the
   small-index cores by default);
3. never cross NUMA boundaries within one worker (remote-NUMA memory access
   is slower);
4. in a 128-core 4-NUMA box, at most the last 3 NUMAs (96 cores) are usable
   because the main program owns the first NUMA (paper §5.4).

``plan_affinity`` is a pure function (testable on any host);
``apply_affinity`` optionally calls sched_setaffinity.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence


@dataclass(frozen=True)
class NumaTopology:
    total_cores: int
    numa_nodes: int

    @property
    def cores_per_numa(self) -> int:
        return self.total_cores // self.numa_nodes

    def numa_of(self, core: int) -> int:
        return core // self.cores_per_numa


def plan_affinity(topo: NumaTopology, cores_needed: int,
                  reserve_first_numa: bool = True) -> List[int]:
    """Pick cores for one CPU embedding worker per §4.4: reverse index
    order, no NUMA crossing unless unavoidable, first NUMA reserved for the
    service framework."""
    if cores_needed <= 0:
        raise ValueError("cores_needed must be positive")
    cpn = topo.cores_per_numa
    first_allowed = cpn if (reserve_first_numa and topo.numa_nodes > 1) else 0
    avail = list(range(topo.total_cores - 1, first_allowed - 1, -1))
    if cores_needed > len(avail):
        raise ValueError(
            f"need {cores_needed} cores, only {len(avail)} usable "
            f"({topo.total_cores} total, first NUMA reserved)")

    # greedy: fill whole NUMAs from the top; avoid splitting a worker across
    # NUMA boundaries when a single NUMA can hold it
    if cores_needed <= cpn:
        for start_numa in range(topo.numa_nodes - 1,
                                first_allowed // cpn - 1, -1):
            hi = (start_numa + 1) * cpn - 1
            lo = start_numa * cpn
            cores = list(range(hi, hi - cores_needed, -1))
            if all(c >= lo for c in cores):
                return cores
    return avail[:cores_needed]


def numa_crossings(topo: NumaTopology, cores: Sequence[int]) -> int:
    """How many NUMA boundaries a core set spans minus one (0 == no cross)."""
    return len({topo.numa_of(c) for c in cores}) - 1


def apply_affinity(cores: Sequence[int]) -> bool:
    """Best-effort sched_setaffinity; returns False when unsupported."""
    try:
        import os

        os.sched_setaffinity(0, set(cores))
        return True
    except (AttributeError, OSError, ValueError):
        return False

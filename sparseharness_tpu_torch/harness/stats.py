"""Benchmark result records: per-launch rows with kernel time, correctness,
geometry, trial/iteration ids and a statistic kind (RAW_RESULT /
MULTI_ITERATION_SUM / MEDIAN_RESULT), as the reference's SqlStat rows."""

from __future__ import annotations

import dataclasses
import enum
import platform
import statistics
from typing import List, Optional

from sparseharness_tpu_torch.gold.check import Correctness


class Statistic(enum.Enum):
    RAW_RESULT = "RAW_RESULT"
    MULTI_ITERATION_SUM = "MULTI_ITERATION_SUM"
    MEDIAN_RESULT = "MEDIAN_RESULT"


@dataclasses.dataclass
class BenchRecord:
    time_ns: float
    correctness: Correctness
    kernel: str             # variant name
    geometry: str           # "BMxBN"
    trial: int
    iteration: int
    statistic: Statistic
    matrix: str = ""
    experiment_id: str = ""
    device: str = ""        # the card's name, or "cpu"
    host: str = dataclasses.field(default_factory=platform.node)
    nnz: int = 0
    gflops: float = 0.0
    gnnz_per_s: float = 0.0
    # None where no bandwidth bound applies (a run on the CPU)
    roofline_frac: Optional[float] = None

    def finalize(self) -> "BenchRecord":
        if self.nnz and self.time_ns > 0:
            s = self.time_ns * 1e-9
            self.gnnz_per_s = self.nnz / s / 1e9
            self.gflops = 2.0 * self.nnz / s / 1e9  # ⊗ + ⊕ per nonzero
        return self


def median_record(records: List[BenchRecord]) -> Optional[BenchRecord]:
    """MEDIAN_RESULT row over a trial set."""
    raws = [r for r in records if r.statistic is Statistic.RAW_RESULT]
    if not raws:
        return None
    med = statistics.median(r.time_ns for r in raws)
    return dataclasses.replace(
        raws[0], time_ns=med, trial=-1, iteration=-1,
        statistic=Statistic.MEDIAN_RESULT,
    ).finalize()

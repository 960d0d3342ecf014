"""Benchmark result records: per-launch rows with kernel time, correctness,
geometry, trial/iteration ids and a statistic kind (RAW_RESULT /
MULTI_ITERATION_SUM / MEDIAN_RESULT), as the reference's SqlStat rows.

Two sinks render them as the JAX package does: JSONL (every field) and SQL
INSERT rows in the reference's column layout, time in milliseconds."""

from __future__ import annotations

import dataclasses
import enum
import json
import platform
import statistics
from typing import Iterable, List, Optional, TextIO

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
    # mode-specific metrics; in the JSONL row, not in the SQL columns
    extra: dict = dataclasses.field(default_factory=dict)

    def finalize(self) -> "BenchRecord":
        if self.nnz and self.time_ns > 0:
            s = self.time_ns * 1e-9
            self.gnnz_per_s = self.nnz / s / 1e9
            self.gflops = 2.0 * self.nnz / s / 1e9  # ⊗ + ⊕ per nonzero
        return self


def to_jsonl(rec: BenchRecord) -> str:
    d = dataclasses.asdict(rec)
    d["correctness"] = rec.correctness.value
    d["statistic"] = rec.statistic.value
    if not d["extra"]:
        del d["extra"]
    return json.dumps(d)


_SQL_COLUMNS = (
    "time, correct, kernel, global, local, host, device, matrix, "
    "iteration, trial, statistic, experiment_id"
)


def to_sql(rec: BenchRecord, table_name: str = "table_name") -> str:
    """INSERT INTO row in the reference's layout: time in milliseconds,
    columns ``global, local`` (the geometry BMxBN split in two; a
    non-numeric geometry such as the fixpoints' '-' renders as 0), strings
    double-quoted."""
    bm, _, bn = rec.geometry.partition("x")
    vals = ", ".join([
        f"{rec.time_ns / 1e6:g}",
        f'"{rec.correctness.value}"',
        f'"{rec.kernel}"',
        bm if bm.isdigit() else "0",
        bn if bn.isdigit() else "0",
        f'"{rec.host}"',
        f'"{rec.device}"',
        f'"{rec.matrix}"',
        str(rec.iteration),
        str(rec.trial),
        f'"{rec.statistic.value}"',
        f'"{rec.experiment_id}"',
    ])
    return f"INSERT INTO {table_name} ({_SQL_COLUMNS}) VALUES ({vals});"


def write_records(records: Iterable[BenchRecord], jsonl: Optional[TextIO] = None,
                  sql: Optional[TextIO] = None, table_name: str = "table_name") -> None:
    for r in records:
        if jsonl is not None:
            jsonl.write(to_jsonl(r) + "\n")
        if sql is not None:
            sql.write(to_sql(r, table_name) + "\n")


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

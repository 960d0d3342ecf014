"""The sweep: variants × geometries × matrices.

The sweep axis is kernel variant × block geometry. Reference-style runfile
CSVs are accepted: each distinct launch geometry (global, local) maps onto
a block geometry, as the JAX package maps it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from sparseharness_tpu_torch.algorithms.apps import make_spmv_problem
from sparseharness_tpu_torch.formats.sparse import COO
from sparseharness_tpu_torch.gold import spmv_abs_bound, spmv_gold
from sparseharness_tpu_torch.harness.runner import (
    BenchmarkConfig, BenchmarkResult, benchmark_spmv,
)
from sparseharness_tpu_torch.ops import VARIANTS, Geometry
from sparseharness_tpu_torch.semiring import PLUS_TIMES, Semiring
from sparseharness_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    variant: str
    geometry: Geometry

    def name(self) -> str:
        return f"{self.variant}@{self.geometry}"


def default_sweep(variants: Optional[Sequence[str]] = None) -> List[SweepPoint]:
    """A grid of block shapes per variant (every registered one by
    default)."""
    points = []
    for v in variants or sorted(VARIANTS):
        if v in ("ell", "dense"):
            geoms = [Geometry(8, 128), Geometry(8, 256)]
        elif v == "bsr_pallas":
            geoms = [Geometry(8, 128), Geometry(16, 128), Geometry(32, 128),
                     Geometry(8, 256)]
        elif v in ("bsr_ell", "bsr_fused", "bsr_band"):
            geoms = [Geometry(8, 128), Geometry(8, 128, "bfloat16")]
        else:  # no geometry axis
            geoms = [Geometry(8, 128)]
        points.extend(SweepPoint(v, g) for g in geoms)
    return points


def load_runfile(path: str, variant: str = "bsr_pallas") -> List[SweepPoint]:
    """Read a reference-style runfile CSV (global1, ..., local1, ...) and map
    each distinct launch geometry onto a block geometry: the local size,
    rounded down to a multiple of 8 in [8, 512], is block_m; the
    global/local multiplier, binned at 512 and 4096, picks block_n 512,
    256 or 128."""
    points: List[SweepPoint] = []
    seen = set()
    with open(path) as f:
        for line in f:
            parts = [p for p in line.strip().split(",") if p]
            if len(parts) < 2:
                continue
            try:
                g0, l0 = int(parts[0]), int(parts[3]) if len(parts) > 3 else int(parts[1])
            except ValueError:
                continue
            bm = max(8, min(512, (l0 // 8) * 8))
            mult = max(1, g0 // max(l0, 1))
            bn = 128 if mult >= 4096 else (256 if mult >= 512 else 512)
            if (bm, bn) not in seen:
                seen.add((bm, bn))
                points.append(SweepPoint(variant, Geometry(bm, bn)))
    return points or [SweepPoint(variant, Geometry())]


def run_sweep(
    matrices: Dict[str, COO],
    points: Sequence[SweepPoint],
    sr: Semiring = PLUS_TIMES,
    config: BenchmarkConfig = BenchmarkConfig(),
    check_gold: bool = True,
    *,
    device: DeviceLike = None,
) -> Dict[str, Dict[str, BenchmarkResult]]:
    """For each matrix × sweep point: build, gold-check, benchmark. A point
    whose build refuses the matrix is skipped. Returns
    results[matrix][point_name]."""
    device = resolve_device(device)
    results: Dict[str, Dict[str, BenchmarkResult]] = {}
    for mname, coo in matrices.items():
        results[mname] = {}
        gold = scale = None
        for pt in points:
            try:
                prob = make_spmv_problem(coo, sr=sr, variant=pt.variant,
                                         geometry=pt.geometry, device=device)
            except NotImplementedError:
                continue
            if gold is None and check_gold:
                x_np = prob.x0.cpu().numpy()
                gold = spmv_gold(coo, x_np, prob.y.cpu().numpy(), sr)
                scale = spmv_abs_bound(coo, x_np)
            cfg = config
            if pt.geometry.value_dtype != "float32":
                # bf16 storage against an f32 gold needs a matching tolerance
                cfg = dataclasses.replace(config, delta=max(config.delta, 2e-2))
            results[mname][pt.name()] = benchmark_spmv(
                prob, gold=gold, config=cfg, geometry=pt.geometry,
                matrix_name=mname, nnz=coo.nnz, gold_scale=scale,
            )
    return results


def best_per_matrix(results: Dict[str, Dict[str, BenchmarkResult]]) -> Dict[str, str]:
    """The point with the least median time per matrix, among the results
    the gold gate passed."""
    best = {}
    for mname, per_point in results.items():
        ok = {k: v for k, v in per_point.items()
              if v.correctness.value in ("correct", "not_checked", "generally_correct")}
        if ok:
            best[mname] = min(ok, key=lambda k: ok[k].median_ns)
    return best

"""Weak scaling of the sharded SpMV: 1 → N ranks, the problem ∝ N.

Efficiency(N) = T(1 rank, base problem) / T(N ranks, N× the problem); 1.0
means each rank keeps doing the same work while the exchange rides the
interconnect.

Each rank times ``inner_iters`` chained steps x ← A ⊗ x of its mode's
local dot-product step (exchange included) with CUDA events on a card, or
the host clock on the CPU, and the point's time is the slowest rank's (an
``all_reduce`` of the maximum). The events replace the JAX package's
chained two-point clock, which separated dispatch cost on the TPU.

An efficiency is a device figure only where every rank has a card of its
own, and only beside another point: ranks that share one card, or run on
the CPU, check the mechanics (the build, the partition, the exchange, the
timing) and get no efficiency, and neither does a lone point.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from sparseharness_tpu_torch.formats.generate import banded_coo, random_graph_coo
from sparseharness_tpu_torch.parallel import comm, fixcore, launch
from sparseharness_tpu_torch.parallel import mesh as mesh_mod
from sparseharness_tpu_torch.parallel.sharded import _ell_local_dp, build_sharded_ell
from sparseharness_tpu_torch.parallel.sharded_band import band_local_dp, build_sharded_band
from sparseharness_tpu_torch.semiring import MIN_PLUS, Semiring
from sparseharness_tpu_torch.utils.device import DeviceLike, device_name, resolve_device
from sparseharness_tpu_torch.utils.logging import get_logger

log = get_logger("scaling")


@dataclasses.dataclass
class ScalePoint:
    n_devices: int
    rows: int
    nnz: int
    seconds_per_op: float
    efficiency: Optional[float]  # vs the first point; None: no card of its own a rank
    device: str = ""             # the card's name, or "cpu"
    shared: bool = False         # the ranks share a card, or run on the CPU


def _matrix(kernel: str, n: int, avg_degree: float):
    if kernel == "band":
        return banded_coo(n, max(int(avg_degree) // 2, 1), seed=7)
    return random_graph_coo(n, avg_degree, seed=7)


def _scaling_rank(mesh, kernel: str, n: int, avg_degree: float, sr: Semiring,
                  inner_iters: int, matrix_fn: Optional[Callable]) -> dict:
    """One rank of a point: build, warm up, time the chained steps."""
    coo = matrix_fn(n) if matrix_fn is not None else _matrix(kernel, n, avg_degree)
    if kernel == "band":
        op, chunk = build_sharded_band(coo, sr, mesh.size, device=mesh.device)
        step = band_local_dp(mesh, op, sr)
    else:
        op, chunk = build_sharded_ell(coo, sr, mesh.size, device=mesh.device)
        step = _ell_local_dp(mesh, op, sr, None)
    x0 = np.random.default_rng(3).uniform(0.1, 1.0, n).astype(np.float32)
    x = fixcore.local_rows(
        mesh, fixcore.pad_rows(x0, mesh.size * chunk, sr.zero, sr.dtype, mesh.device), chunk)
    for _ in range(2):
        x = step(x)
    cuda = mesh.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(mesh.device)
    comm.barrier(mesh)
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner_iters):
            x = step(x)
        end.record()
        end.synchronize()
        seconds = start.elapsed_time(end) * 1e-3 / inner_iters
    else:
        t0 = time.perf_counter()
        for _ in range(inner_iters):
            x = step(x)
        seconds = (time.perf_counter() - t0) / inner_iters
    slowest = comm.all_reduce(mesh, torch.tensor([seconds], dtype=torch.float64,
                                                 device=mesh.device), "max")
    return {"seconds_per_op": float(slowest[0]), "nnz": coo.nnz,
            "device": device_name(mesh.device)}


def weak_scaling_spmv(
    base_rows: int = 1 << 14,
    avg_degree: float = 8.0,
    device_counts: Optional[List[int]] = None,
    sr: Semiring = MIN_PLUS,
    inner_iters: int = 8,
    matrix_fn: Optional[Callable] = None,
    kernel: str = "ell",
    *,
    device: DeviceLike = None,
    backend: Optional[str] = None,
    devices: Optional[Sequence[int]] = None,
    timeout_s: float = 600.0,
) -> List[ScalePoint]:
    """Time the sharded SpMV at each rank count, rows ∝ ranks, each point a
    world of its own (``parallel/launch.py:run_world``).

    min_plus by default: its ⊕ is idempotent, so the chained x ← A ⊗ x
    needs no magnitude control and the timed step is exactly the SpMV.
    kernel="ell": the all-gather and the plain gather dp (any structure);
    kernel="band": the band kernel with the edge exchange overlapped with
    the interior launch, on a band matrix (banded_coo with half-width
    avg_degree / 2). ``matrix_fn(n)``, a module-level function, replaces
    the default matrix. On cards NCCL needs a card a rank; ``backend``
    "gloo" lets ranks share one."""
    if kernel not in ("ell", "band"):
        raise ValueError(f"unknown weak-scaling kernel {kernel!r}")
    dev = resolve_device(device)
    backend = backend or mesh_mod.default_backend(dev)
    if device_counts is None:
        avail = mesh_mod.device_count() if dev.type == "cuda" else min(os.cpu_count() or 1, 8)
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= avail]
    points: List[ScalePoint] = []
    base_time = None
    for d in device_counts:
        n = base_rows * d
        cards = {str(t) for t in mesh_mod.rank_devices(d, devices, device=dev, backend=backend)}
        shared = dev.type != "cuda" or len(cards) < d
        res = launch.run_world(_scaling_rank, d, backend=backend, device=dev, devices=devices,
                               args=(kernel, n, avg_degree, sr, inner_iters, matrix_fn),
                               timeout_s=timeout_s)[0]
        per = max(res["seconds_per_op"], 1e-9)
        if base_time is None:
            base_time = per
        points.append(ScalePoint(n_devices=d, rows=n, nnz=res["nnz"], seconds_per_op=per,
                                 efficiency=None if shared else base_time / per,
                                 device=res["device"], shared=shared))
        log.info("weak scaling d=%d: %.3f ms/op", d, per * 1e3)
    if len(points) < 2:  # one point scales nothing
        points = [dataclasses.replace(p, efficiency=None) for p in points]
    return points


def report(points: List[ScalePoint]) -> str:
    lines = ["devices  rows        nnz         ms/op    efficiency"]
    for p in points:
        eff = "-" if p.efficiency is None else f"{p.efficiency:.2f}"
        lines.append(f"{p.n_devices:7d}  {p.rows:<10d}  {p.nnz:<10d}  "
                     f"{p.seconds_per_op * 1e3:7.3f}  {eff:>10}")
    if any(p.shared and p.device == "cpu" for p in points):
        lines.append("ranks on the CPU: the mechanics only, no device efficiency")
    elif any(p.shared for p in points):
        lines.append(f"ranks share one card ({points[0].device}): no efficiency")
    elif len(points) < 2:
        lines.append("one point: no efficiency")
    return "\n".join(lines)

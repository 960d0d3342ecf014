"""The benchmark runner — trials, timing, timeout ratchet, correctness.

- warm-up excluded from timing: the first call builds the kernel and is
  discarded;
- on a GPU each trial is the CUDA-event interval around
  ``launches_per_trial`` back-to-back calls, divided by that count; on the
  CPU the host clock stands in and no device metric is derived;
- per-trial timeout with the adaptive ``lowerTimeout`` ratchet: once a
  trial completes in t, the cap becomes 2·t;
- correctness against a gold, and the liveness warning for a launch that
  changed nothing;
- a MEDIAN_RESULT row per configuration and MULTI_ITERATION_SUM rows for
  the fixpoint apps; the host-stepped form adds a RAW_RESULT row per step.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import numpy as np
import torch

from sparseharness_tpu_torch.algorithms.fixpoint import run_fixpoint_stepped
from sparseharness_tpu_torch.gold.check import Correctness, check_result
from sparseharness_tpu_torch.harness.roofline import roofline_seconds
from sparseharness_tpu_torch.harness.stats import BenchRecord, Statistic, median_record
from sparseharness_tpu_torch.ops import Geometry, spmv
from sparseharness_tpu_torch.utils.device import device_name
from sparseharness_tpu_torch.utils.logging import get_logger
from sparseharness_tpu_torch.utils.timing import ScopedTimer, report_timing

log = get_logger("harness")


@dataclasses.dataclass
class BenchmarkConfig:
    """The reference's CLI knobs: -n trials, -t timeout, -c delta, -e
    experiment id."""

    trials: int = 10
    timeout_s: float = 10.0
    delta: float = 1e-4
    experiment_id: str = ""
    adaptive_timeout: bool = True  # lowerTimeout ratchet
    check_every_trial: bool = False  # results are deterministic across trials
    launches_per_trial: int = 10


@dataclasses.dataclass
class BenchmarkResult:
    records: List[BenchRecord]
    median_ns: float
    best_ns: float
    correctness: Correctness
    gnnz_per_s: float
    roofline_frac: Optional[float]  # None off the GPU
    device: str
    iterations: int = 0  # fixpoint apps

    def summary(self) -> str:
        frac = ("not measured" if self.roofline_frac is None
                else f"{self.roofline_frac * 100:.1f}% of roofline")
        return (
            f"median {self.median_ns / 1e6:.3f} ms, best {self.best_ns / 1e6:.3f} ms, "
            f"{self.gnnz_per_s:.3f} Gnnz/s ({frac}) on {self.device}, "
            f"{self.correctness.value}"
        )


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time_launches(fn: Callable[[], Any], device: torch.device, n: int):
    """(seconds per call, last result) over n back-to-back calls."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            res = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3 / n, res
    t0 = time.perf_counter()
    for _ in range(n):
        res = fn()
    return (time.perf_counter() - t0) / n, res


def benchmark_spmv(
    problem,
    gold: Optional[np.ndarray] = None,
    config: BenchmarkConfig = BenchmarkConfig(),
    geometry: Geometry = Geometry(),
    matrix_name: str = "",
    nnz: int = 0,
    gold_scale: Optional[np.ndarray] = None,
) -> BenchmarkResult:
    """Benchmark a single-shot semiring SpMV — the app/spmv.cpp loop."""
    op, x, y = problem.operand, problem.x0, problem.y
    device = x.device
    dev = device_name(device)

    def run():
        return spmv(op, x, y, sr=problem.sr, variant=problem.variant,
                    n_rows=problem.n_rows, alpha=problem.alpha, beta=problem.beta)

    with ScopedTimer("warmup", "benchmark_spmv"):
        out = run()
        _sync(device)
    out_np = out.cpu().numpy()
    correctness = (
        check_result(out_np, gold, delta=config.delta, scale=gold_scale)
        if gold is not None else Correctness.NOT_CHECKED
    )
    # liveness: a launch that changed nothing usually means a broken kernel
    # (scripts grep for this exact phrase to tally failures)
    x_np = x.cpu().numpy()
    if out_np.shape == x_np.shape and np.array_equal(out_np, x_np):
        log.warning("kernel has probably failed: output equals input")

    sol = None
    if device.type == "cuda":
        sol = roofline_seconds(problem.variant, op, x.numel() * x.element_size(),
                               out.numel() * out.element_size(), dev)

    records: List[BenchRecord] = []
    timeout = config.timeout_s
    best = float("inf")
    for trial in range(config.trials):
        dt, res = _time_launches(run, device, config.launches_per_trial)
        report_timing("executeKernel", "benchmark_spmv", dt * 1e3)
        best = min(best, dt)
        corr = correctness
        if config.check_every_trial and gold is not None:
            corr = check_result(res.cpu().numpy(), gold, delta=config.delta,
                                scale=gold_scale)
        records.append(BenchRecord(
            time_ns=dt * 1e9, correctness=corr, kernel=problem.variant,
            geometry=str(geometry), trial=trial, iteration=0,
            statistic=Statistic.RAW_RESULT, matrix=matrix_name,
            experiment_id=config.experiment_id, device=dev, nnz=nnz,
            roofline_frac=None if sol is None else sol / dt,
        ).finalize())
        # adaptive timeout ratchet: cap later trials at 2× the best time
        if config.adaptive_timeout:
            timeout = min(timeout, 2.0 * dt)
        if dt > timeout:
            log.info("trial %d exceeded timeout %.3fs; stopping", trial, timeout)
            break

    med = median_record(records)
    med.matrix = matrix_name
    med.roofline_frac = None if sol is None else sol / (med.time_ns * 1e-9)
    records.append(med)
    return BenchmarkResult(
        records=records,
        median_ns=med.time_ns,
        best_ns=best * 1e9,
        correctness=correctness,
        gnnz_per_s=nnz / (med.time_ns * 1e-9) / 1e9,
        roofline_frac=med.roofline_frac,
        device=dev,
    )


def benchmark_fixpoint_stepped(
    components,
    gold: Optional[np.ndarray] = None,
    config: BenchmarkConfig = BenchmarkConfig(),
    matrix_name: str = "",
    kernel_name: str = "fixpoint",
    exact: bool = False,
) -> BenchmarkResult:
    """Host-stepped fixpoint: one step and one convergence-flag readback per
    iteration, a RAW_RESULT row per step and a MULTI_ITERATION_SUM row per
    trial, as the reference's per-iteration records. Each step is timed on
    the host clock up to its flag readback, which waits for the step's
    kernels. One untimed warm-up step runs first; a trial that passes the
    timeout stops mid-solve and ends the trials; the cap then ratchets to
    twice the last trial's time."""
    device = components.x0.device
    dev = device_name(device)
    records: List[BenchRecord] = []
    correctness = Correctness.NOT_CHECKED
    total_iters = 0
    with ScopedTimer("warmup", "benchmark_fixpoint_stepped"):
        for _ in run_fixpoint_stepped(components.step, components.x0,
                                      convergence=components.convergence, max_iter=1):
            break
    timeout = config.timeout_s
    for trial in range(config.trials):
        t_total, it, x, conv, timed_out = 0.0, 0, None, False, False
        gen = run_fixpoint_stepped(components.step, components.x0,
                                   convergence=components.convergence,
                                   max_iter=components.limit)
        t_prev = time.perf_counter()
        for x, it, conv in gen:
            now = time.perf_counter()
            dt, t_prev = now - t_prev, now
            t_total += dt
            records.append(BenchRecord(
                time_ns=dt * 1e9, correctness=Correctness.NOT_CHECKED,
                kernel=kernel_name, geometry="-", trial=trial, iteration=it,
                statistic=Statistic.RAW_RESULT, matrix=matrix_name,
                experiment_id=config.experiment_id, device=dev,
            ))
            if t_total > timeout:
                timed_out = True
                log.info("stepped trial %d exceeded timeout %.3fs at iteration %d; "
                         "stopping", trial, timeout, it)
                break
        total_iters = it
        if (conv and it <= 1 and x is not None
                and np.array_equal(x.cpu().numpy(), components.x0.cpu().numpy())):
            log.warning("kernel has probably failed: converged at iteration %d with "
                        "x unchanged from x0", it)
        if config.adaptive_timeout and not timed_out:
            timeout = min(timeout, max(2.0 * t_total, 1e-3))
        if trial == 0 and gold is not None and x is not None:
            final = x.cpu().numpy()
            if getattr(components, "unpermute", None) is not None:
                final = components.unpermute(final)
            correctness = check_result(final, gold, delta=config.delta, exact=exact)
        records.append(BenchRecord(
            time_ns=t_total * 1e9, correctness=correctness, kernel=kernel_name,
            geometry="-", trial=trial, iteration=it,
            statistic=Statistic.MULTI_ITERATION_SUM, matrix=matrix_name,
            experiment_id=config.experiment_id, device=dev,
        ))
        if timed_out:
            break  # every later trial would stop at the same cap
    sums = sorted(r.time_ns for r in records
                  if r.statistic is Statistic.MULTI_ITERATION_SUM)
    return BenchmarkResult(
        records=records, median_ns=sums[len(sums) // 2] if sums else 0.0,
        best_ns=sums[0] if sums else 0.0, correctness=correctness, gnnz_per_s=0.0,
        roofline_frac=None, device=dev, iterations=total_iters,
    )


def benchmark_fixpoint(
    solve_fn: Callable[[], Any],
    gold: Optional[np.ndarray] = None,
    config: BenchmarkConfig = BenchmarkConfig(),
    geometry: Geometry = Geometry(),
    matrix_name: str = "",
    kernel_name: str = "fixpoint",
    nnz: int = 0,
    exact: bool = False,
    x0: Optional[np.ndarray] = None,
) -> BenchmarkResult:
    """Benchmark a whole iterate-to-fixpoint solve: each trial runs the full
    fixpoint, timed on the host clock up to a device synchronise; the
    MULTI_ITERATION_SUM row records the solve time.

    ``x0``, when given, enables the liveness check: convergence at the
    first step with x unchanged means the step almost certainly did
    nothing."""
    with ScopedTimer("warmup", "benchmark_fixpoint"):
        res = solve_fn()
    device = res.x.device
    _sync(device)
    dev = device_name(device)
    iters = int(res.iterations)
    out = res.x.cpu().numpy()
    if not res.converged:
        log.warning("fixpoint unconverged after %d iterations (max_iter "
                    "reached)", iters)
    if (res.converged and iters <= 1 and x0 is not None
            and out.shape == np.shape(x0) and np.array_equal(out, x0)):
        log.warning("kernel has probably failed: converged at iteration "
                    "%d with x unchanged from x0", iters)
    correctness = (
        check_result(out, gold, delta=config.delta, exact=exact)
        if gold is not None else Correctness.NOT_CHECKED
    )

    records: List[BenchRecord] = []
    timeout = config.timeout_s
    best = float("inf")
    for trial in range(config.trials):
        t0 = time.perf_counter()
        solve_fn()
        _sync(device)
        dt = time.perf_counter() - t0
        report_timing("executeRun", "benchmark_fixpoint", dt * 1e3)
        best = min(best, dt)
        records.append(BenchRecord(
            time_ns=dt * 1e9, correctness=correctness, kernel=kernel_name,
            geometry=str(geometry), trial=trial, iteration=iters,
            statistic=Statistic.MULTI_ITERATION_SUM, matrix=matrix_name,
            experiment_id=config.experiment_id, device=dev,
            nnz=nnz * max(iters, 1),
        ).finalize())
        if config.adaptive_timeout:
            timeout = min(timeout, 2.0 * dt)
        if dt > timeout:
            break

    times = sorted(r.time_ns for r in records)
    med_ns = times[len(times) // 2] if times else 0.0
    return BenchmarkResult(
        records=records,
        median_ns=med_ns,
        best_ns=best * 1e9,
        correctness=correctness,
        gnnz_per_s=(nnz * iters / (med_ns * 1e-9) / 1e9) if med_ns else 0.0,
        roofline_frac=None,
        device=dev,
        iterations=iters,
    )

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root with one CUDA card and nvcc present:

    python3 chip_smoke.py

It imports only the port (``sparseharness_tpu_torch``) and, for phase
12's Kronecker graph, the benchmark's graph generator, never JAX. Each
phase prints one JSON line with its seconds; any failure raises, so the
script exits non-zero, and without a card it exits 1 before printing any
result. Phases:

1. device and build: the card, its power limit, torch and CUDA versions,
   and the nvcc build of every kernel source, with the g++ build of the
   native host library (formats/csrc/fast_mtx.cpp) beside it;
2. kernel vs plain: both paths of the bsr_band kernel (x staged in shared
   memory, x streamed; each reads only the rows' spans of the strips)
   against the plain torch version on the same CUDA tensors, for all seven
   semirings and every strip type, at a small and at the full bench width,
   for x uniform in (0.1, 1), x with ±inf, ±FLT_MAX and ±0, and negative x;
   bit-exact except plus_times, held within 1e-5 · max(1, |plain|, Σ|a·x|)
   because its sum order differs (NaN where a pad meets ±inf), and except
   the sign of a ±0 tie, which torch's amax leaves to its order: against
   the same dp with IEEE min and max the sign must match too;
3. the main path, with the launch counters reset just before and read just
   after: the 524,288-row band SpMV (bench.py's headline, 66,580,544 nnz)
   through make_spmv_problem and benchmark_spmv, gold-gated in f32 and bf16
   on both kernel paths; then the sssp, bfs and pagerank fixpoints at that
   width, each with a certificate that is cheap at full width;
4. the same apps on a small band against the port's NumPy golds;
5. kernel timing at the main path's f32 and bf16 shapes (CUDA events, the
   paths in turns): each kernel path, the plain version, torch.mv on a CSR
   tensor of the same matrix as the library yardstick, the bound (the
   least traffic: each row's span of values, x and the output), the bytes
   by design (band_traffic) and the layout's bytes and bound (every strip
   slot); then scripts/probe_band_spans_cuda.py once, as a subprocess;
6. blocked kernels vs plain: the strip kernel of bsr_fused (x gathered in
   the kernel) and of bsr_ell (x strips gathered before it), and the gen-1
   tile kernel of bsr_pallas, against their plain versions on the same
   CUDA tensors: all seven semirings and strip types on three small
   matrices (143 block-rows; random blocks; one row of 66 tiles, which
   takes two bsr_fused slabs; gen-1 also with 20 tiles a slab), and at the
   blocked bench width plus_times in f32 and bf16, min_plus and or_and;
7. the blocked main path, with the launch counters reset just before and
   read just after: bench.py's blocked candidate, block_random_coo(131072,
   2, seed=5) with 33,554,432 nnz, through make_spmv_problem and
   benchmark_spmv, gold-gated for bsr_fused and bsr_ell in f32 and bf16
   and bsr_pallas in f32; then sssp, bfs and pagerank with variant="auto",
   which must resolve bsr_fused (one bsr_fused launch per step), each
   certified;
8. the variant gate of bench.py: every registered variant gold-checked on
   random_coo(1138, 1138, 4054, seed=0), bsr_band and dia on
   banded_coo(1138, 8, seed=0), each operand on the card first passing
   verify_operand_initialized (every slot an entry or padding, every index
   in bounds);
9. kernel timing at the blocked shape: each blocked kernel, its plain
   version, torch.mv on a CSR tensor of the same matrix, and the bound;
10. the sell2 kernel against its plain version (over the panels of a CPU
   build, moved to the card; a card build keeps only the kernel's plan):
   all seven semirings and
   value types on the layout cases of tests/test_sell2.py (a hub row split
   into pieces, virtual chunks, two slabs, three chunks, a power-law graph
   with bucket layouts sharing a row0, empty rows, one entry per row), bit
   for bit except plus_times (held within the tolerance above, and to the
   same bits on a second run), then at the ragged bench width plus_times
   in f32 and bf16, min_plus and or_and;
11. the ragged main path, with the launch counters reset just before and
   read just after: bench.py's ragged matrix, power_law_coo(500000,
   2000000, alpha=1.5, seed=13) with 1,713,662 nnz, through
   make_spmv_problem and benchmark_spmv with sell2, gold-gated in f32, bf16
   and min_plus; then sssp, bfs, pagerank, connected_components and
   widest_path with variant="auto", which must resolve sell2 (one sell2
   launch per step), each certified;
12. kernel timing at the ragged shape: the sell2 kernel in f32 and bf16
   (the median of five windows, the host's enqueue time per call, and the
   device time per launch of its one kernel from torch.profiler, with the
   launches it recorded), its plain
   version, torch.mv on a CSR tensor of the same matrix, the bound, the
   bytes of the plan and of a call, the plan's bins (rows and entries
   each) and pieces, the seconds of each card build (native, with its
   seconds by stage), and the panels' figures from a CPU build; at the
   ragged shape the plan keeps x as it is, so a call is the kernel alone;
   then the sell2 kernel at the benchmark's Graph500 Kronecker graph of
   scale 20 (portbench/configs/g500-kron-s20.json, 31,403,178 entries over
   1,048,576 columns), whose plan gathers x in degree order: held to the
   plain version over a CPU build's panels in f32 plus_times (within the
   tolerance above), min_plus and or_and (bit for bit), with one x copy a
   call counted; then the call as built (the copy, then the kernel) timed
   in turns (degree, as is, as is, degree) with a plan of x as it is, made
   by a CPU build that takes all of x for L1 (the kernel alone, a
   yardstick), each kernel's device ms a launch from torch.profiler,
   beside the bound as portbench/work.py counts it (each folded value, x
   and the output once) and torch.mv on a CSR tensor of the folded matrix;
13. the SpMM kernels against their plain versions: spmm_tiles for all
   seven semirings and strip types over bsr_ell and bsr_fused strips of
   random_coo(300, 257, 2500, seed=3) and random_coo(64, 4096, 6000,
   seed=5) (K > 8) and the explicit columns of banded_coo(96, 40,
   seed=53), spmm_band in f32 and bf16, at m up to 200; bit for bit except
   plus_times (within the tolerance above, and the same bits twice); then
   spmm_band at full width (the bench band, f32, m = 128) on an X with
   ±inf and NaN in 96 places: NaN and ±inf exactly where the plain
   version's are (a pad the kernel skips meets a non-finite value), the
   rest within the tolerance, the same bits twice;
14. the SpMM path, with the launch counters reset just before phase 14
   and read just after phase 16: spmm at full width on the bench band (m =
   128 and 256 in f32, 128 with bf16 strips: spmm_band) and on the blocked
   matrix (plus_times at m = 8 and 128, min_plus and or_and at 128, over
   the bsr_ell and the bsr_fused operand: spmm_tiles), each held against
   the chunked plain version and, on four columns, against the port's spmv;
15. multi_sssp and multi_bfs on the blocked matrix from 128 seeded roots
   (bsr_ell, and auto resolving bsr_fused), one spmm_tiles launch a step,
   every column certified, four equal to the single-source solves;
16. the other multi-source routes: bsr_band operands through spmm_tiles on
   banded_coo(1 << 16, 63, seed=1) with 8 roots, the column map of sell2
   on the ragged matrix (8 sell2 launches a step), and a shuffled band
   solved with reorder="rcm" (native RCM), which must resolve bsr_band and
   equal the unshuffled solve;
17. SpMM kernel times at the full-width points: the median of five 20-call
   windows, the plain version, torch.sparse.mm on a CSR tensor (cuSPARSE,
   f32 plus_times only) and the bound (on the band, each row's span of
   values, beside the every-slot layout bound; the units the operations
   are counted at), and on the blocked matrix the X bytes the kernel
   reads by its design;
18. the sell kernels (the fused depth-0 kernel and the level kernel)
   against their plain versions, the fused kernel alone against
   fused_plain, the level kernel alone against its model levels_plain
   (slabs as built and every slab on the work path) and the whole dp
   against dp_sell_plain: all seven semirings
   on the matrices of tests/test_torch_sell.py
   (power_law_coo(1500, 9000, seed=4), a 400-entry hub row, two or more
   slabs at slab_nnz=8000, empty rows and a duplicate) and the gate's
   random_coo(1138, 1138, 4054, seed=0), then min_plus and or_and on
   banded_coo(1 << 16, 63, seed=1): bit for bit, plus_times included, and
   the same bits on a second call;
19. the sell path, with the launch counters reset just before phase 19 and
   read just after phase 21: banded_coo(1 << 18, 63, seed=1) (262,144
   columns, the widest x that sell's XROWS_MAX admits; 33,288,256 nnz)
   through make_spmv_problem and benchmark_spmv with variant="sell",
   gold-gated in f32, with the seconds of its NumPy build;
20. sssp and bfs with variant="sell" on banded_coo(1 << 16, 63, seed=1),
   one sell_fused and one sell_level launch a step, certified as in phase 3;
21. the CLI: the 1 << 16 band and the gate's matrix written with write_mtx
   into a temporary directory, then the nine commands run in process as
   ``python -m sparseharness_tpu_torch.cli <app>`` runs them (spmv and sssp
   with -k sell on the band; the sweep, a stepped sssp, bfs from three
   roots, pr, scc --full, eigenvector, cc, widest_path and just_parser -k
   sell on the small matrix, natively and with --no-native; the other
   commands parse natively), every return code 0, every JSONL row parsed
   and none gold-checked incorrect, the band's spmv and sssp rows and the
   sweep's sell row correct, and one spmv -k sell as a subprocess, correct;
22. the native host path against the NumPy one at full size: the sell2
   build of the ragged matrix both ways on the CPU (which keeps the
   panels beside the plan), every array identical, with both
   times, the native build's seconds by stage and its count of NumPy-body
   slabs, then the sell2 kernel on the native operand, moved to the card,
   against its plain version and the gold; RCM of the shuffled 1 << 16 band both ways, the
   same permutation; the parse of phase 21's 8.3 M-entry band.mtx both
   ways, the same indices and values within rtol 1e-6; each with both
   times (the kernel launches here are outside every counted run);
23. sell kernel times at the 1 << 18 band: the whole dp, the fused
   depth-0 launch alone and the level launch alone (median of five 20-call
   windows of CUDA events), the plain versions, torch.mv on a CSR tensor of
   the same matrix, the bounds and the bytes each moves by its design; the
   fused launch's level-0 rows, the level launch's dp and the whole dp held
   against the plain versions bit for bit; torch.profiler's device ms a
   launch of each sell kernel inside the dp (as built and with every slab
   on the level launch's work path), which the kernels line takes for the
   level launch (its CUDA-event time is the host's enqueue); a `spmv` call
   with variant="sell": one fused and one level launch, its ms and the
   host's enqueue ms;
24. sharded_world1: the row-sharded solvers (parallel/) in a world of one
   NCCL rank on the card, started by parallel.launch.run_world. The rank
   first runs the single-device port, then, with the launch counters reset
   just before and read just after, the sharded path: on the bench band
   (524,288 rows) the gather, halo, band and auto modes, each with SpMV in
   min_plus, or_and and plus_times against the single-device SpMV (bit for
   bit, plus_times within the tolerance above) and sssp, bfs (from the
   middle row) and pagerank against the single-device solves on x,
   iterations and converged (pagerank's x within 1e-6); the streamed band
   path forced (an SpMV and a 50-step capped sssp); auto_sharded_spmv on
   the 1 << 16 band; sell mode's SpMVs and solves and the frontier's sssp
   and bfs on the ragged matrix; the tiles mode's multi_sssp and
   multi_bfs from 8 roots (spmm_tiles at m = 8) on the blocked matrix; and
   the 1 << 16 band's band-mode sssp and frontier solves. The bsr_band
   (staged and streamed), sell2 and spmm_tiles launches of that run must
   each be > 0. Last, the band sssp against the single-device band sssp:
   steps, seconds, host ms a step and torch.profiler's device-busy ms a
   step over a 300-step solve;
25. sharded_ranks2_one_card: two gloo ranks sharing the card (every
   exchanged buffer copied through the host, the backend's rule): the band
   mode's sssp and the frontier's bfs and sssp on the 1 << 16 band, equal
   to the world of one's answers;
26. weak_scaling: harness/scaling.py's world-1 NCCL point of the band
   kernel at the bench band's width, ms per op and no efficiency;
27. sharded_cli: spmv and sssp --mesh 1 --sharded-mode band (as in JAX,
   --mesh 1 shards nothing), sssp --devices 0 --sharded-mode band (the
   sharded path, records tagged sssp:sharded1:band) and spmv --mesh 2,
   which one card refuses with JAX's make_mesh error;
28. the dia kernel against its plain version on the same CUDA tensors, on
   HPCG's matrix at its shipped 104³ grid (stencil27_coo: 1,124,864 rows,
   29,791,000 nnz, 27 diagonals), each operand built through
   variant="auto", which must resolve dia: all seven semirings in f32 and
   the float ones in bf16, bit for bit except plus_times, held within the
   tolerance above;
29. the stencil's main path, with the launch counters reset just before
   and read just after, in which only dia may launch: make_spmv_problem
   with variant="auto" and benchmark_spmv, gold-gated in f32 and bf16,
   then ten spmv calls, which must launch dia ten times;
30. dia kernel times at the 104³ stencil in f32 and bf16 (the median of
   five 50-call windows, the host's enqueue a call, a whole spmv call
   the same way, the plain version), torch.mv on a CSR tensor of the same matrix, the bound of
   the value slots and that of the matrix's entries; then the same in f32
   at a 160³ stencil, whose diagonals are 8.8 times the L2.

Then the kernels line, the nvidia-smi line and, last, the ok line.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

FULL_N = 1 << 19   # bench.py's banded headline: 524,288 rows
BAND = 63          # 127 nnz per interior row
SMALL_N = 3000
SMALL_BAND = 40
PT_DELTA = 1e-5    # plus_times tolerance, scaled by max(1, |ref|, Σ|a·x|)
F32_PEAK_OPS = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
BLOCK_N = 131072   # bench.py's blocked candidate: 16,384 block-rows of 2 tiles
BLOCK_SEED = 5
BLOCKED = ("bsr_fused", "bsr_ell", "bsr_pallas")
RAGGED_N = 500_000      # bench.py's ragged matrix: power_law_coo(500000,
RAGGED_NNZ = 2_000_000  # 2000000, alpha=1.5, seed=13), 1,713,662 nnz
RAGGED_SEED = 13
SEMIRINGS = ("plus_times", "min_plus", "or_and", "max_min", "max_times",
             "max_right", "min_right")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


class Phase:
    """Prints the phase's JSON line, with its seconds, when it ends."""

    def __init__(self, name: str):
        self.fields = {"phase": name}

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self.fields

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            self.fields["seconds"] = time.perf_counter() - self._t0
            emit(self.fields)
        return False


def time_ms(torch, fn, n: int) -> float:
    """Mean milliseconds per call over n back-to-back calls (CUDA events),
    after two warm-up calls."""
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n


def time_windows(torch, fn, windows: int = 5, n: int = 20) -> dict:
    """Milliseconds per call over ``windows`` runs of n back-to-back calls
    (CUDA events), after two warm-up calls: the median window, every window,
    and the host's median ms per call to enqueue them. When the enqueue
    takes as long as a call, the calls are bound by the host."""
    fn()
    fn()
    dev, host = [], []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        host.append((time.perf_counter() - t0) * 1e3 / n)
        end.synchronize()
        dev.append(start.elapsed_time(end) / n)
    return {"ms": float(np.median(dev)), "ms_windows": dev,
            "enqueue_ms": float(np.median(host))}


def random_x(torch, sr, n: int, rng) -> "torch.Tensor":
    if sr.dtype == torch.bool:
        x = rng.random(n) < 0.3
    elif sr.dtype == torch.int32:
        x = rng.integers(0, n, n).astype(np.int32)
    else:
        x = rng.uniform(0.1, 1.0, n).astype(np.float32)
    return torch.from_numpy(x).cuda()


def max_err(torch, a, b) -> float:
    """Largest |a − b| where a != b (matching infinities count as equal)."""
    a, b = a.double(), b.double()
    diff = torch.where(a == b, torch.zeros_like(a), (a - b).abs())
    return float(diff.max())


def check_kernel(torch, label, got, ref, bound) -> float:
    """Bit-exact, or plus_times (bound given) within
    PT_DELTA · max(1, |plain|, Σ|a·x|); the largest |got − ref|."""
    torch.cuda.synchronize()
    if bound is None:
        if not torch.equal(got, ref):
            raise AssertionError(f"{label}: kernel != plain in "
                                 f"{int((got != ref).sum())} rows")
        return 0.0
    tol = PT_DELTA * torch.maximum(torch.maximum(ref.abs(), bound), torch.ones_like(ref))
    bad = int(((got - ref).abs() > tol).sum())
    if bad:
        raise AssertionError(f"{label}: kernel outside tolerance in {bad} rows")
    return max_err(torch, got, ref)


def check_band(torch, label, got, ref, strict) -> None:
    """NaN where NaN, else the same bits; against the plain version
    (``strict`` False) two zeros of either sign also match: torch's amax and
    amin leave the sign of a ±0 tie to their reduction order."""
    torch.cuda.synchronize()
    if got.dtype != torch.float32:
        if not torch.equal(got, ref):
            raise AssertionError(f"{label}: kernel != reference in "
                                 f"{int((got != ref).sum())} rows")
        return
    nan = got.isnan()
    same = got.view(torch.int32) == ref.view(torch.int32)
    if not strict:
        same |= (got == 0) & (ref == 0)
    bad = int((nan != ref.isnan()).sum()) + int((~same & ~nan).sum())
    if bad:
        raise AssertionError(f"{label}: kernel != reference in {bad} rows")


def check_band_plus_times(torch, label, got, ref, bound) -> tuple:
    """plus_times: NaN where Σ|a·x| is NaN (a pad meets ±inf: 0·inf), and
    within PT_DELTA · max(1, |plain|, Σ|a·x|) where Σ|a·x| is finite. Where
    it is +inf the sum's value depends on its order, and such rows are not
    checked here (the exact semirings hold them bit for bit). Fails when no
    row is finite; returns the largest |got − ref| on the finite rows and
    their count."""
    torch.cuda.synchronize()
    nan = bound.isnan()
    if not (bool(got[nan].isnan().all()) and bool(ref[nan].isnan().all())):
        raise AssertionError(f"{label}: a 0·inf pad row is not NaN")
    fin = bound.isfinite()
    n_fin = int(fin.sum())
    if n_fin == 0:
        raise AssertionError(f"{label}: no row has a finite Σ|a·x| to check")
    return check_kernel(torch, label, got[fin], ref[fin], bound[fin]), n_fin


def kernel_vs_plain(torch, coo, errs) -> dict:
    """Both kernel paths against the plain version on one matrix, for x
    uniform in (0.1, 1), x with ±inf, ±FLT_MAX and ±0, and negative x; the
    exact semirings also bit for bit, zero signs included, against the dp
    with IEEE min and max. The worst plus_times error per path goes into
    ``errs``; the rows held to plus_times' tolerance, for each x kind, into
    the result."""
    from sparseharness_tpu_torch.ops import bsr_band
    from sparseharness_tpu_torch.semiring import PLUS_TIMES, get_semiring

    rng = np.random.default_rng(7)
    n = coo.shape[0]
    checked = 0
    finite_rows = {}
    for name in SEMIRINGS:
        sr = get_semiring(name)
        for vd in (("float32", "bfloat16") if sr.dtype == torch.float32 else ("float32",)):
            op = bsr_band.build_bsr_band(coo, sr, value_dtype=vd, device="cuda")
            for kind in bsr_band.X_KINDS:
                x = torch.from_numpy(bsr_band.band_x(sr, n, kind, rng)).cuda()
                x2d = bsr_band.pad_x(op, x, sr)
                ieee = bsr_band.band_dp_ieee(op.strips, x2d, sr, c0=op.c0, k_win=op.k_win)
                bound = None
                if name == "plus_times":
                    bound = bsr_band.band_dp_plain(
                        op.strips.abs(), x2d.abs(), PLUS_TIMES, c0=op.c0,
                        k_win=op.k_win, kc=op.k_win)
                # staged, streamed, and streamed with one slot per ⊕-partial
                for path, stage_x, kc in (("staged", True, op.k_win),
                                          ("streamed", False, bsr_band.chunk_slots(op, False)),
                                          ("streamed", False, 1)):
                    got = bsr_band.band_dp_cuda(op.strips, x2d, sr, c0=op.c0,
                                                k_win=op.k_win, stage_x=stage_x, kc=kc,
                                                spans=op.spans)
                    ref = bsr_band.band_dp_plain(op.strips, x2d, sr, c0=op.c0,
                                                 k_win=op.k_win, kc=kc)
                    label = f"{path} {name}/{vd}/{kind}/kc={kc}"
                    if bound is None:
                        check_band(torch, label, got, ref, strict=False)
                        check_band(torch, label + " (IEEE)", got, ieee, strict=True)
                    else:
                        err, n_fin = check_band_plus_times(torch, label, got, ref, bound)
                        errs[path] = max(errs[path], err)
                        finite_rows[f"{vd}/{kind}"] = n_fin
                    checked += 1
                del x, x2d, ieee, bound
            del op
    return {"rows": n, "nnz": coo.nnz, "comparisons": checked,
            "plus_times_finite_rows": finite_rows}


def spmv_main_path(torch, coo, out) -> None:
    from sparseharness_tpu_torch.algorithms import make_spmv_problem
    from sparseharness_tpu_torch.gold import Correctness, spmv_abs_bound, spmv_gold
    from sparseharness_tpu_torch.harness import (
        BenchmarkConfig, benchmark_spmv, device_hbm_bandwidth, variant_bytes,
    )
    from sparseharness_tpu_torch.ops import Geometry
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    card = torch.cuda.get_device_name(0)
    bw = device_hbm_bandwidth(card)
    config = BenchmarkConfig(trials=5, launches_per_trial=20)
    for vd in ("float32", "bfloat16"):
        geom = Geometry(8, 128, vd)
        prob = make_spmv_problem(coo, PLUS_TIMES, "bsr_band", geom, seed=2)
        gold_coo = coo
        if vd == "bfloat16":
            # the gate's gold uses the values as the bf16 strips hold them
            vals = torch.from_numpy(coo.vals).to(torch.bfloat16).float().numpy()
            gold_coo = coo.with_values(vals)
        x_np = prob.x0.cpu().numpy()
        gold = spmv_gold(gold_coo, x_np, prob.y.cpu().numpy(), PLUS_TIMES)
        scale = spmv_abs_bound(gold_coo, x_np)
        for path, windowed in (("staged", None), ("streamed", True)):
            p = dataclasses.replace(
                prob, operand=dataclasses.replace(prob.operand, windowed=windowed))
            res = benchmark_spmv(p, gold=gold, config=config, geometry=geom,
                                 matrix_name=f"banded{FULL_N}", nnz=coo.nnz,
                                 gold_scale=scale)
            if res.correctness is not Correctness.CORRECT:
                raise AssertionError(f"bsr_band@{geom} {path}: {res.correctness}")
            n_bytes = variant_bytes("bsr_band", p.operand, p.x0.numel() * 4,
                                    coo.shape[0] * 4)
            out.append({
                "variant": "bsr_band", "geometry": str(geom), "path": path,
                "correctness": res.correctness.value,
                "median_ms": res.median_ns * 1e-6, "best_ms": res.best_ns * 1e-6,
                "gnnz_per_s": res.gnnz_per_s,
                "bytes_per_s": n_bytes / (res.median_ns * 1e-9),
                "bound_ms": n_bytes / bw * 1e3,
                "roofline_frac": res.roofline_frac,
            })
        del prob


def fixpoints_main_path(torch, coo, out) -> None:
    from sparseharness_tpu_torch.algorithms import bfs, pagerank, sssp
    from sparseharness_tpu_torch.formats import pagerank_normalise
    from sparseharness_tpu_torch.ops import build_operand, dp_bsr_band_plain, fold_dp
    from sparseharness_tpu_torch.semiring import MIN_PLUS, PLUS_TIMES

    n = coo.shape[0]

    def plain_spmv(op, x, sr):
        return fold_dp(dp_bsr_band_plain(op, x, sr, n_rows=n)[:n], None, sr,
                       None, None)

    t0 = time.perf_counter()
    r = sssp(coo, 0, variant="bsr_band")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    op = build_operand(coo, MIN_PLUS, "bsr_band")
    again = torch.minimum(r.x, plain_spmv(op, r.x, MIN_PLUS))
    cert = bool(r.converged and float(r.x[0]) == 0.0 and torch.equal(again, r.x))
    del op, again
    out.append({"app": "sssp", "iterations": r.iterations, "converged": r.converged,
                "seconds": dt, "certificate": "x[0] == 0 and min(x, A⊗x) == x",
                "certified": cert})
    if not cert:
        raise AssertionError("sssp certificate failed")

    t0 = time.perf_counter()
    r = bfs(coo, 0, variant="bsr_band")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    want = torch.from_numpy(
        ((np.arange(n) + BAND - 1) // BAND).astype(np.int32)).cuda()
    cert = bool(r.converged and bool(r.x.all()) and torch.equal(r.aux, want))
    out.append({"app": "bfs", "iterations": r.iterations, "converged": r.converged,
                "seconds": dt, "certificate": f"levels == ceil(i / {BAND})",
                "certified": cert})
    if not cert:
        raise AssertionError("bfs certificate failed")

    delta, damping = 1e-6, 0.85
    t0 = time.perf_counter()
    r = pagerank(coo, damping, variant="bsr_band", delta=delta)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    op = build_operand(pagerank_normalise(coo, damping), PLUS_TIMES, "bsr_band")
    teleport = np.float32((1.0 - damping) / n)
    resid = float((plain_spmv(op, r.x, PLUS_TIMES) + teleport - r.x).abs().max())
    total = float(r.x.double().sum())
    cert = bool(r.converged and resid < delta and abs(total - 1.0) < 1e-3)
    del op
    out.append({"app": "pagerank", "iterations": r.iterations,
                "converged": r.converged, "seconds": dt,
                "certificate": "|A·x + t − x| < delta and Σx ≈ 1",
                "residual": resid, "sum": total, "certified": cert})
    if not cert:
        raise AssertionError("pagerank certificate failed")


def small_apps(torch) -> dict:
    from sparseharness_tpu_torch.algorithms import bfs, pagerank, sssp
    from sparseharness_tpu_torch.formats import banded_coo
    from sparseharness_tpu_torch.gold import (
        Correctness, bfs_levels_gold, check_result, pagerank_gold, sssp_gold,
    )

    coo = banded_coo(SMALL_N, SMALL_BAND, seed=3)
    r = sssp(coo, 0, variant="bsr_band")
    if check_result(r.x.cpu().numpy(), sssp_gold(coo, 0), delta=1e-5) is not Correctness.CORRECT:
        raise AssertionError("small sssp disagrees with sssp_gold")
    r = bfs(coo, 0, variant="bsr_band")
    if not np.array_equal(r.aux.cpu().numpy(), bfs_levels_gold(coo, 0)):
        raise AssertionError("small bfs levels disagree with bfs_levels_gold")
    r = pagerank(coo, variant="bsr_band")
    err = float(np.abs(r.x.cpu().numpy() - pagerank_gold(coo)).max())
    if not (r.converged and err < 1e-6):
        raise AssertionError(f"small pagerank off pagerank_gold by {err}")
    return {"rows": SMALL_N, "pagerank_max_abs_err": err}


def kernel_times(torch, coo) -> dict:
    """Per-kernel ms at the main path's shape, the plain version's ms, the
    library yardstick's ms and the bound, for f32 (and the kernels' bf16).
    The bound is the least traffic these inputs need (variant_bytes: each
    row's span of values, x and the output); beside it the bytes by design
    (band_traffic: the span chunks, the span table, x and the output) and
    the layout's bytes and bound (every strip slot)."""
    from sparseharness_tpu_torch.harness import device_hbm_bandwidth, variant_bytes
    from sparseharness_tpu_torch.ops import bsr_band
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    card = torch.cuda.get_device_name(0)
    bw = device_hbm_bandwidth(card)
    n = coo.shape[0]
    x = random_x(torch, PLUS_TIMES, n, np.random.default_rng(11))
    csr = csr_of(torch, coo)
    res = {}
    for vd in ("float32", "bfloat16"):
        op = bsr_band.build_bsr_band(coo, PLUS_TIMES, value_dtype=vd, device="cuda")
        x2d = bsr_band.pad_x(op, x, PLUS_TIMES)
        n_bytes = variant_bytes("bsr_band", op, n * 4, n * 4)
        n_ops = 2 * coo.nnz  # one ⊗ and one ⊕ per stored value
        entry = bound(n_bytes, n_ops, bw)
        traffic = bsr_band.band_traffic(op)
        layout = (op.strips.numel() * op.strips.element_size() + x2d.numel() * 4
                  + op.strips.shape[0] * op.strips.shape[1] * 4)
        entry.update(design_bytes=traffic["bytes"], design_bound_ms=traffic["bytes"] / bw * 1e3,
                     layout_bytes=layout, layout_bound_ms=layout / bw * 1e3)
        ms = {"staged": [], "streamed": []}
        # the paths in turns: staged, streamed, streamed, staged
        for path in ("staged", "streamed", "streamed", "staged"):
            stage_x = path == "staged"
            kc = bsr_band.chunk_slots(op, stage_x)
            ms[path].append(time_ms(torch, lambda: bsr_band.band_dp_cuda(
                op.strips, x2d, PLUS_TIMES, c0=op.c0, k_win=op.k_win,
                stage_x=stage_x, kc=kc, spans=op.spans), 50))
        for path, t in ms.items():
            entry[f"{path}_ms"] = min(t)
            entry[f"{path}_ms_runs"] = t
            entry[f"{path}_share_of_bound"] = entry["bound_ms"] / min(t)
        entry["plain_ms"] = time_ms(torch, lambda: bsr_band.band_dp_plain(
            op.strips, x2d, PLUS_TIMES, c0=op.c0, k_win=op.k_win, kc=op.k_win), 5)
        # library yardstick: cuSPARSE SpMV through torch.mv on a CSR tensor
        # of the same matrix (plus_times, f32), in the same run
        entry["library_ms"] = time_ms(torch, lambda: torch.mv(csr, x), 20)
        res[vd] = entry
        del op, x2d
    return res


def band_span_probe() -> dict:
    """scripts/probe_band_spans_cuda.py once, as a subprocess: its seconds
    and its JSON lines (the designs' ms in turns, the streamed path and
    torch.mv)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.join("scripts", "probe_band_spans_cuda.py")],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"the band span probe exited {proc.returncode}: "
                             f"{proc.stderr[-2000:]}")
    lines = [json.loads(ln) for ln in proc.stdout.splitlines() if ln.startswith("{")]
    return {"probe_seconds": time.perf_counter() - t0, "lines": lines}


def one_wide_row(n_rows: int = 600):
    """600 entries in row 0 over 66 block-columns: K = 66, so bsr_fused's
    slab height is 56 and its 75 block-rows take two slabs."""
    from sparseharness_tpu_torch.formats import coo_from_arrays

    cols = np.arange(0, 600 * 14, 14, dtype=np.int32)
    return coo_from_arrays(np.zeros(600, np.int32), cols,
                           np.linspace(0.1, 1.0, 600).astype(np.float32),
                           (n_rows, 8400))


def blocked_vs_plain(torch, coo, cases, errs, tiles_per_slab=(None,)) -> int:
    """The strip kernel (both x sources) and the gen-1 tile kernel against
    their plain versions on one matrix, for (semiring, strip type) cases;
    the worst plus_times error per kernel goes into ``errs``. Returns the
    number of comparisons."""
    from sparseharness_tpu_torch.ops import bsr, bsr_ell, bsr_fused
    from sparseharness_tpu_torch.semiring import PLUS_TIMES, get_semiring

    rng = np.random.default_rng(9)
    checked = 0
    for name, vd in cases:
        sr = get_semiring(name)
        x = random_x(torch, sr, coo.shape[1], rng)
        fop = bsr_fused.build_bsr_fused(coo, sr, value_dtype=vd, device="cuda")
        eop = bsr_ell.build_bsr_ell(coo, sr, value_dtype=vd, device="cuda")
        strips, cols, k, bn = bsr_fused._flat(fop)
        x2d = bsr.pad_x2d(x, bn, sr)
        for kernel, st, cl in (("bsr_fused", strips, cols),
                               ("bsr_ell", eop.tiles, eop.tile_cols)):
            xt = bsr_ell.gather_x_strips(x2d, cl)
            ref = bsr_ell.strip_dp_plain(st, xt, sr)
            bound = (bsr_ell.strip_dp_plain(st.abs(), xt.abs(), PLUS_TIMES)
                     if name == "plus_times" else None)
            got = (bsr_ell.strip_dp_cuda(st, x2d, sr, k=k, cols=cl)
                   if kernel == "bsr_fused" else bsr_ell.strip_dp_cuda(st, xt, sr, k=k))
            errs[kernel] = max(errs[kernel], check_kernel(
                torch, f"{kernel} {name}/{vd}", got, ref, bound))
            checked += 1
        del fop, eop, strips, cols
        if vd != "float32":
            continue  # gen-1 tiles are always the carrier type
        for tps in tiles_per_slab:
            gop = bsr.build_bsr(coo, sr, tiles_per_slab=tps or bsr.DEFAULT_TILES_PER_SLAB,
                                device="cuda")
            args = (gop.tiles, x2d, gop.tile_cols, gop.seg)
            ref = bsr.tile_dp_plain(*args, sr)
            bound = (bsr.tile_dp_plain(gop.tiles.abs(), x2d.abs(), gop.tile_cols,
                                       gop.seg, PLUS_TIMES)
                     if name == "plus_times" else None)
            errs["bsr_pallas"] = max(errs["bsr_pallas"], check_kernel(
                torch, f"bsr_pallas {name}/tps={tps}", bsr.tile_dp_cuda(*args, sr),
                ref, bound))
            checked += 1
            del gop, args
    return checked


def all_cases(torch):
    from sparseharness_tpu_torch.semiring import get_semiring

    return [(n, vd) for n in SEMIRINGS for vd in ("float32", "bfloat16")
            if vd == "float32" or get_semiring(n).dtype == torch.float32]


def blocked_main_path(torch, coo, out) -> None:
    """bench.py's blocked candidate through make_spmv_problem and
    benchmark_spmv, gold-gated, for each blocked variant."""
    from sparseharness_tpu_torch.algorithms import make_spmv_problem
    from sparseharness_tpu_torch.gold import Correctness, spmv_abs_bound, spmv_gold
    from sparseharness_tpu_torch.harness import (
        BenchmarkConfig, benchmark_spmv, device_hbm_bandwidth, variant_bytes,
    )
    from sparseharness_tpu_torch.ops import Geometry
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    bw = device_hbm_bandwidth(torch.cuda.get_device_name(0))
    config = BenchmarkConfig(trials=5, launches_per_trial=20)
    golds = {}
    for variant, vd in (("bsr_fused", "float32"), ("bsr_fused", "bfloat16"),
                        ("bsr_ell", "float32"), ("bsr_ell", "bfloat16"),
                        ("bsr_pallas", "float32")):
        geom = Geometry(8, 128, vd)
        prob = make_spmv_problem(coo, PLUS_TIMES, variant, geom, seed=4)
        if vd not in golds:
            gold_coo = coo
            if vd == "bfloat16":
                # the gate's gold uses the values as the bf16 strips hold them
                vals = torch.from_numpy(coo.vals).to(torch.bfloat16).float().numpy()
                gold_coo = coo.with_values(vals)
            x_np = prob.x0.cpu().numpy()
            golds[vd] = (spmv_gold(gold_coo, x_np, prob.y.cpu().numpy(), PLUS_TIMES),
                         spmv_abs_bound(gold_coo, x_np))
        gold, scale = golds[vd]
        res = benchmark_spmv(prob, gold=gold, config=config, geometry=geom,
                             matrix_name=f"block{BLOCK_N}", nnz=coo.nnz,
                             gold_scale=scale)
        if res.correctness is not Correctness.CORRECT:
            raise AssertionError(f"{variant}@{geom}: {res.correctness}")
        n_bytes = variant_bytes(variant, prob.operand, prob.x0.numel() * 4,
                                coo.shape[0] * 4)
        out.append({
            "variant": variant, "geometry": str(geom),
            "correctness": res.correctness.value,
            "median_ms": res.median_ns * 1e-6, "best_ms": res.best_ns * 1e-6,
            "gnnz_per_s": res.gnnz_per_s,
            "bytes_per_s": n_bytes / (res.median_ns * 1e-9),
            "bound_ms": n_bytes / bw * 1e3,
            "roofline_frac": res.roofline_frac,
        })
        del prob


def blocked_fixpoints(torch, coo, out) -> None:
    """sssp, bfs and pagerank with variant="auto" on the blocked matrix.
    auto must resolve bsr_fused: each step launches it once. Certificates:
    sssp's x is tight (x[0] = 0 and A⊗x = x on every other row, with
    positive weights the shortest paths), bfs levels equal the NumPy gold,
    pagerank's residual is below delta and Σx ≈ 1."""
    from sparseharness_tpu_torch.algorithms import bfs, pagerank, sssp
    from sparseharness_tpu_torch.formats import pagerank_normalise
    from sparseharness_tpu_torch.gold import bfs_levels_gold
    from sparseharness_tpu_torch.ops import LAUNCHES, build_operand, dp_bsr_fused_plain, fold_dp
    from sparseharness_tpu_torch.semiring import MIN_PLUS, PLUS_TIMES

    n = coo.shape[0]

    def plain_spmv(op, x, sr):
        return fold_dp(dp_bsr_fused_plain(op, x, sr, n_rows=n)[:n], None, sr, None, None)

    def run(app, *args, **kw):
        before = LAUNCHES["bsr_fused"]
        t0 = time.perf_counter()
        r = app(coo, *args, variant="auto", **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = LAUNCHES["bsr_fused"] - before
        if launched != r.iterations:
            raise AssertionError(f"{app.__name__}: {launched} bsr_fused launches for "
                                 f"{r.iterations} steps: auto did not resolve bsr_fused")
        return r, dt

    r, dt = run(sssp, 0)
    op = build_operand(coo, MIN_PLUS, "bsr_fused")
    ax = plain_spmv(op, r.x, MIN_PLUS)
    cert = bool(r.converged and float(r.x[0]) == 0.0 and bool((r.x >= 0).all())
                and torch.equal(ax[1:], r.x[1:]))
    del op, ax
    out.append({"app": "sssp", "variant": "auto -> bsr_fused", "iterations": r.iterations,
                "converged": r.converged, "seconds": dt,
                "certificate": "x[0] == 0, x >= 0 and A⊗x == x on rows != 0",
                "certified": cert})
    if not cert:
        raise AssertionError("blocked sssp certificate failed")

    r, dt = run(bfs, 0)
    t0 = time.perf_counter()
    want = bfs_levels_gold(coo, 0)
    gold_s = time.perf_counter() - t0
    cert = bool(r.converged and np.array_equal(r.aux.cpu().numpy(), want))
    out.append({"app": "bfs", "variant": "auto -> bsr_fused", "iterations": r.iterations,
                "converged": r.converged, "seconds": dt, "gold_seconds": gold_s,
                "levels": int(want.max()), "certificate": "levels == bfs_levels_gold",
                "certified": cert})
    if not cert:
        raise AssertionError("blocked bfs certificate failed")

    delta, damping = 1e-6, 0.85
    r, dt = run(pagerank, damping, delta=delta)
    op = build_operand(pagerank_normalise(coo, damping), PLUS_TIMES, "bsr_fused")
    teleport = np.float32((1.0 - damping) / n)
    resid = float((plain_spmv(op, r.x, PLUS_TIMES) + teleport - r.x).abs().max())
    total = float(r.x.double().sum())
    cert = bool(r.converged and resid < delta and abs(total - 1.0) < 1e-3)
    del op
    out.append({"app": "pagerank", "variant": "auto -> bsr_fused",
                "iterations": r.iterations, "converged": r.converged, "seconds": dt,
                "certificate": "|A·x + t − x| < delta and Σx ≈ 1",
                "residual": resid, "sum": total, "certified": cert})
    if not cert:
        raise AssertionError("blocked pagerank certificate failed")


def variant_gate(torch) -> dict:
    """bench.py's gate: every registered variant on its home structure,
    its operand on the card passing verify_operand_initialized, gold-checked
    CORRECT on the card."""
    from sparseharness_tpu_torch.algorithms import make_spmv_problem
    from sparseharness_tpu_torch.formats import banded_coo, random_coo
    from sparseharness_tpu_torch.gold import Correctness, spmv_gold
    from sparseharness_tpu_torch.harness import BenchmarkConfig, benchmark_spmv
    from sparseharness_tpu_torch.ops import VARIANTS, verify_operand_initialized
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    small = random_coo(1138, 1138, 4054, seed=0)
    band = banded_coo(1138, 8, seed=0)
    gate = [(v, small) for v in sorted(VARIANTS) if v not in ("bsr_band", "dia")]
    gate += [("bsr_band", band), ("dia", band)]
    for variant, m in gate:
        prob = make_spmv_problem(m, variant=variant, seed=1)
        # every slot of the card's operand is an entry or padding (raises)
        verify_operand_initialized(m, PLUS_TIMES, prob.operand, variant)
        gold = spmv_gold(m, prob.x0.cpu().numpy(), prob.y.cpu().numpy(), PLUS_TIMES)
        res = benchmark_spmv(prob, gold=gold, config=BenchmarkConfig(trials=1))
        if res.correctness is not Correctness.CORRECT:
            raise AssertionError(f"gate: {variant} is {res.correctness}")
    return {"variants": [v for v, _ in gate], "correct": len(gate),
            "init_checked": len(gate)}


def csr_of(torch, coo):
    """A CUDA CSR tensor of coo (f32), for torch.mv as the library
    yardstick; the port never calls it."""
    n = coo.shape[0]
    counts = np.bincount(coo.rows, minlength=n)
    crow = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    order = np.lexsort((coo.cols, coo.rows))
    return torch.sparse_csr_tensor(
        crow, torch.from_numpy(coo.cols[order]), torch.from_numpy(coo.vals[order]),
        size=coo.shape).cuda()


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: int, n_ops: int, bw: float) -> dict:
    """The least time: the larger of the bytes over the memory rate and
    the operations over the rate of the units the kernels use (FP32 outside
    the tensor cores: none of the port's kernels uses a tensor core)."""
    bytes_ms, ops_ms = n_bytes / bw * 1e3, n_ops / F32_PEAK_OPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": n_bytes, "ops_units": "FP32, 67 TFLOP/s"}


def blocked_kernel_times(torch, coo) -> dict:
    """Per-kernel ms at the blocked main path's shape (f32, and bf16 for the
    strip kernel), the plain version's ms, the bound and the library
    yardstick's ms. The bound counts each kernel input read once and the
    output written once; the operations are one ⊗ and one ⊕ per slot."""
    from sparseharness_tpu_torch.harness import device_hbm_bandwidth
    from sparseharness_tpu_torch.ops import bsr, bsr_ell, bsr_fused
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    bw = device_hbm_bandwidth(torch.cuda.get_device_name(0))
    n = coo.shape[0]
    x = random_x(torch, PLUS_TIMES, n, np.random.default_rng(12))
    res = {}
    for vd in ("float32", "bfloat16"):
        fop = bsr_fused.build_bsr_fused(coo, PLUS_TIMES, value_dtype=vd, device="cuda")
        strips, cols, k, bn = bsr_fused._flat(fop)
        x2d = bsr.pad_x2d(x, bn, PLUS_TIMES)
        out_bytes = strips.shape[0] * strips.shape[1] * 4
        entry = {"bsr_fused": bound(tensor_bytes(strips, cols, x2d) + out_bytes,
                                    2 * strips.numel(), bw)}
        entry["bsr_fused"]["ms"] = time_ms(torch, lambda: bsr_ell.strip_dp_cuda(
            strips, x2d, PLUS_TIMES, k=k, cols=cols), 50)
        entry["bsr_fused"]["plain_ms"] = time_ms(torch, lambda: bsr_ell.strip_dp_plain(
            strips, bsr_ell.gather_x_strips(x2d, cols), PLUS_TIMES), 10)
        del fop, strips, cols
        eop = bsr_ell.build_bsr_ell(coo, PLUS_TIMES, value_dtype=vd, device="cuda")
        xt = bsr_ell.gather_x_strips(x2d, eop.tile_cols)
        out_bytes = eop.tiles.shape[0] * eop.tiles.shape[1] * 4
        entry["bsr_ell"] = bound(tensor_bytes(eop.tiles, xt) + out_bytes,
                                 2 * eop.tiles.numel(), bw)
        entry["bsr_ell"]["ms"] = time_ms(torch, lambda: bsr_ell.strip_dp_cuda(
            eop.tiles, xt, PLUS_TIMES, k=k), 50)
        entry["bsr_ell"]["gather_ms"] = time_ms(
            torch, lambda: bsr_ell.gather_x_strips(x2d, eop.tile_cols), 50)
        entry["bsr_ell"]["plain_ms"] = time_ms(torch, lambda: bsr_ell.strip_dp_plain(
            eop.tiles, bsr_ell.gather_x_strips(x2d, eop.tile_cols), PLUS_TIMES), 10)
        del eop, xt
        if vd == "float32":
            gop = bsr.build_bsr(coo, PLUS_TIMES, device="cuda")
            args = (gop.tiles, x2d, gop.tile_cols, gop.seg)
            out_bytes = gop.seg.shape[0] * (gop.seg.shape[1] - 1) * gop.tiles.shape[2] * 4
            entry["bsr_pallas"] = bound(tensor_bytes(*args) + out_bytes,
                                        2 * gop.tiles.numel(), bw)
            entry["bsr_pallas"]["slabs"] = list(gop.tiles.shape[:2])
            entry["bsr_pallas"]["ms"] = time_ms(
                torch, lambda: bsr.tile_dp_cuda(*args, PLUS_TIMES), 50)
            entry["bsr_pallas"]["plain_ms"] = time_ms(
                torch, lambda: bsr.tile_dp_plain(*args, PLUS_TIMES), 10)
            del gop, args
        res[vd] = entry
    csr = csr_of(torch, coo)
    res["library_ms"] = time_ms(torch, lambda: torch.mv(csr, x), 20)
    del csr
    return res


def ragged_cases(torch):
    """The layout cases of tests/test_sell2.py (see the module docstring)."""
    from sparseharness_tpu_torch.formats import coo_from_arrays, power_law_coo, random_coo

    rng = np.random.default_rng(5)
    bg = random_coo(1200, 4000, 5000, seed=6)
    hub = coo_from_arrays(np.r_[np.full(600, 7), bg.rows],
                          np.r_[rng.choice(4000, 600, replace=False), bg.cols],
                          np.r_[rng.uniform(0.1, 1.0, 600).astype(np.float32), bg.vals],
                          (1200, 4000))
    rng = np.random.default_rng(9)
    ch = np.repeat(np.arange(60), 64)
    cols = (ch * 16384 + np.repeat(np.tile(np.arange(4), 60), 16) * 128
            + rng.integers(0, 128, ch.size))
    light = coo_from_arrays(rng.integers(0, 4096, ch.size), cols,
                            rng.uniform(0.1, 1.0, ch.size).astype(np.float32),
                            (4096, 60 * 16384))
    rows = np.arange(2000)
    return [hub, light, random_coo(32768 + 3000, 900, 40_000, seed=1),
            random_coo(700, 2 * 16384 + 5000, 30_000, seed=2),
            power_law_coo(20000, 60000, seed=4),
            coo_from_arrays([0, 1, 2], [10, 20, 30], [1.0, 2.0, 3.0], (5000, 5000)),
            coo_from_arrays(rows, (rows * 37) % 2000,
                            np.linspace(0.1, 1.0, 2000).astype(np.float32), (2000, 2000))]


def sell2_vs_plain(torch, coo, cases, errs) -> int:
    """The sell2 kernel against its plain version on one matrix for
    (semiring, value type) cases: bit for bit, except plus_times within
    PT_DELTA · max(1, |plain|, Σ|a·x|), and plus_times' second run to the
    same bits. The worst plus_times error goes into ``errs``."""
    from sparseharness_tpu_torch.ops import sell2
    from sparseharness_tpu_torch.semiring import PLUS_TIMES, get_semiring

    rng = np.random.default_rng(10)
    checked = 0
    for name, vd in cases:
        sr = get_semiring(name)
        m = coo.with_values(coo.vals != 0) if sr.dtype == torch.bool else coo
        op = sell2.build_sell2(m, sr, value_dtype=vd, device="cuda")
        x = random_x(torch, sr, m.shape[1], rng)
        got = sell2.sell2_dp_cuda(op, x, sr)
        ref_op = sell2.build_sell2(m, sr, value_dtype=vd, device="cpu").to("cuda")
        ref = sell2.dp_sell2_plain(ref_op, x, sr, n_rows=m.shape[0])
        del ref_op
        bound = None
        if name == "plus_times":
            again = sell2.sell2_dp_cuda(op, x, sr)
            torch.cuda.synchronize()
            if not torch.equal(again.view(torch.int32), got.view(torch.int32)):
                raise AssertionError(f"sell2 {name}/{vd}: two runs differ")
            if not torch.equal(got, ref):
                aop = sell2.build_sell2(m.with_values(np.abs(m.vals)), sr, value_dtype=vd,
                                        device="cpu").to("cuda")
                bound = sell2.dp_sell2_plain(aop, x.abs(), PLUS_TIMES, n_rows=m.shape[0])
                del aop
        errs["sell2"] = max(errs["sell2"], check_kernel(
            torch, f"sell2 {name}/{vd}", got, ref, bound))
        checked += 1
        del op
    return checked


def ragged_main_path(torch, coo, out) -> None:
    """bench.py's ragged matrix through make_spmv_problem and
    benchmark_spmv with sell2, gold-gated."""
    from sparseharness_tpu_torch.algorithms import make_spmv_problem
    from sparseharness_tpu_torch.gold import Correctness, spmv_abs_bound, spmv_gold
    from sparseharness_tpu_torch.harness import (
        BenchmarkConfig, benchmark_spmv, device_hbm_bandwidth, variant_bytes,
    )
    from sparseharness_tpu_torch.ops import Geometry
    from sparseharness_tpu_torch.semiring import MIN_PLUS, PLUS_TIMES

    bw = device_hbm_bandwidth(torch.cuda.get_device_name(0))
    config = BenchmarkConfig(trials=5, launches_per_trial=20)
    for sr, vd in ((PLUS_TIMES, "float32"), (PLUS_TIMES, "bfloat16"),
                   (MIN_PLUS, "float32")):
        geom = Geometry(8, 128, vd)
        t0 = time.perf_counter()
        prob = make_spmv_problem(coo, sr, "sell2", geom, seed=3)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        gold_coo = coo
        if vd == "bfloat16":
            vals = torch.from_numpy(coo.vals).to(torch.bfloat16).float().numpy()
            gold_coo = coo.with_values(vals)
        x_np = prob.x0.cpu().numpy()
        gold = spmv_gold(gold_coo, x_np, prob.y.cpu().numpy(), sr)
        scale = spmv_abs_bound(gold_coo, x_np) if sr is PLUS_TIMES else None
        res = benchmark_spmv(prob, gold=gold, config=config, geometry=geom,
                             matrix_name=f"zipf{RAGGED_N}", nnz=coo.nnz, gold_scale=scale)
        if res.correctness is not Correctness.CORRECT:
            raise AssertionError(f"sell2@{geom} {sr.name}: {res.correctness}")
        n_bytes = variant_bytes("sell2", prob.operand, prob.x0.numel() * 4,
                                coo.shape[0] * 4)
        out.append({
            "variant": "sell2", "semiring": sr.name, "geometry": str(geom),
            "correctness": res.correctness.value, "build_seconds": build_s,
            "median_ms": res.median_ns * 1e-6, "best_ms": res.best_ns * 1e-6,
            "gnnz_per_s": res.gnnz_per_s, "bytes_per_s": n_bytes / (res.median_ns * 1e-9),
            "bound_ms": n_bytes / bw * 1e3, "roofline_frac": res.roofline_frac,
        })
        del prob


def ragged_fixpoints(torch, coo, out) -> None:
    """sssp, bfs, pagerank, connected_components and widest_path with
    variant="auto" on the ragged matrix. auto must resolve sell2: each step
    launches it once. Certificates, each against the plain version on an
    operand built for the check: sssp's x is tight (x[0] = 0, x ≥ 0 and
    A⊗x = x off the root); bfs levels and component labels equal the NumPy
    golds; pagerank's x and Σx agree with the NumPy gold (dangling vertices
    leak mass, so Σx < 1; the residual |A·x + t − x| is reported);
    widest_path's x is a fixpoint, max(x, A⊗x) = x, with the root at
    FLT_MAX."""
    from sparseharness_tpu_torch.algorithms import (
        bfs, connected_components, pagerank, sssp, widest_path,
    )
    from sparseharness_tpu_torch.formats import pagerank_normalise
    from sparseharness_tpu_torch.gold import (
        bfs_levels_gold, connected_components_gold, pagerank_gold,
    )
    from sparseharness_tpu_torch.ops import LAUNCHES, build_operand, dp_sell2_plain, fold_dp
    from sparseharness_tpu_torch.semiring import MAX_MIN, MIN_PLUS, PLUS_TIMES

    n = coo.shape[0]

    def plain_spmv(m, x, sr):
        op = build_operand(m, sr, "sell2", device="cpu").to("cuda")
        return fold_dp(dp_sell2_plain(op, x, sr, n_rows=n)[:n], None, sr, None, None)

    def run(app, *args, **kw):
        before = LAUNCHES["sell2"]
        t0 = time.perf_counter()
        r = app(coo, *args, variant="auto", **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = LAUNCHES["sell2"] - before
        if launched != r.iterations:
            raise AssertionError(f"{app.__name__}: {launched} sell2 launches for "
                                 f"{r.iterations} steps: auto did not resolve sell2")
        return r, dt

    def record(app, r, dt, certificate, cert, **extra):
        out.append({"app": app, "variant": "auto -> sell2", "iterations": r.iterations,
                    "converged": r.converged, "seconds": dt, "certificate": certificate,
                    "certified": cert, **extra})
        if not cert:
            raise AssertionError(f"ragged {app} certificate failed")

    r, dt = run(sssp, 0)
    ax = plain_spmv(coo, r.x, MIN_PLUS)
    record("sssp", r, dt, "x[0] == 0, x >= 0 and A⊗x == x on rows != 0",
           bool(r.converged and float(r.x[0]) == 0.0 and bool((r.x >= 0).all())
                and torch.equal(ax[1:], r.x[1:])),
           reached=int((r.x < 3e38).sum()))
    del ax

    r, dt = run(bfs, 0)
    want = bfs_levels_gold(coo, 0)
    record("bfs", r, dt, "levels == bfs_levels_gold",
           bool(r.converged and np.array_equal(r.aux.cpu().numpy(), want)),
           levels=int(want.max()), reached=int((want >= 0).sum()))

    delta, damping = 1e-6, 0.85
    r, dt = run(pagerank, damping, delta=delta)
    teleport = np.float32((1.0 - damping) / n)
    resid = float((plain_spmv(pagerank_normalise(coo, damping), r.x, PLUS_TIMES)
                   + teleport - r.x).abs().max())
    total = float(r.x.double().sum())
    t0 = time.perf_counter()
    want = pagerank_gold(coo, damping, tol=delta)
    gold_s = time.perf_counter() - t0
    err = float(np.abs(r.x.cpu().numpy() - want).max())
    record("pagerank", r, dt, "|x − pagerank_gold| < 1e-5 and Σx == Σgold within 1e-4",
           bool(r.converged and err < 1e-5 and abs(total - float(want.sum(dtype=np.float64)))
                < 1e-4),
           residual=resid, sum=total, max_abs_err_vs_gold=err, gold_seconds=gold_s)

    r, dt = run(connected_components)
    want = connected_components_gold(coo)
    record("connected_components", r, dt, "labels == connected_components_gold",
           bool(r.converged and np.array_equal(r.x.cpu().numpy(), want)),
           components=int(np.unique(want).size))

    r, dt = run(widest_path, 0)
    ax = plain_spmv(coo, r.x, MAX_MIN)
    flt_max = float(np.finfo(np.float32).max)
    record("widest_path", r, dt, "max(x, A⊗x) == x and x[0] == FLT_MAX",
           bool(r.converged and float(r.x[0]) == flt_max
                and torch.equal(torch.maximum(r.x, ax), r.x)),
           reached=int((r.x > -flt_max).sum()))


def sell2_work(torch, plan) -> dict:
    """The plan's bins (rows and entries each, widest first), its pieces
    and owners, and the most pieces an owner folds."""
    return {"bin_rows": list(plan.bin_rows), "bin_entries": list(plan.bin_entries),
            "pieces": plan.n_pieces, "owners": int(plan.owners.shape[0]),
            "pieces_per_owner_max": int((plan.owners[:, 2] - plan.owners[:, 1]).max())
            if plan.owners.numel() else 0}


def sell2_call_bytes(plan, x_bytes: int) -> int:
    """The bytes one call moves by its design: the plan's column and value
    stream, row pointers and destinations once, the piece values written and
    read once, x once and the output once."""
    return (tensor_bytes(plan.cols, plan.vals, plan.row_ptr, plan.row_dest)
            + 2 * plan.n_pieces * 4 + x_bytes + plan.n_final * 4)


def ragged_kernel_times(torch, coo) -> dict:
    """The sell2 kernel's ms at the ragged shape (f32 and bf16), its plain
    version's ms, the bound, the seconds of each build and the library
    yardstick's ms. The bound counts the matrix, as portbench/work.py
    does: each folded value once (in the value type), x and the output
    once; the panel stream and the plan are reported beside it
    (``stream_bytes``, ``plan_bytes``), and ``call_bytes`` is what a call
    moves by its design. The kernel's device ms comes from torch.profiler,
    the host's enqueue per call from ``time_windows``, and the bins from
    the plan. The panels, which a card build does not keep, are a CPU
    build's, moved to the card for the plain version."""
    from sparseharness_tpu_torch.harness import device_hbm_bandwidth
    from sparseharness_tpu_torch.ops import sell2
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    bw = device_hbm_bandwidth(torch.cuda.get_device_name(0))
    x = random_x(torch, PLUS_TIMES, coo.shape[1], np.random.default_rng(13))
    res = {}
    for vd in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        rec = sell2.EncodeRecord()
        op = sell2.build_sell2(coo, PLUS_TIMES, value_dtype=vd, device="cuda", record=rec)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        panels = sell2.build_sell2(coo, PLUS_TIMES, value_dtype=vd, device="cpu").to(
            "cuda").panels
        stream = [t for s in panels.slabs if s is not None for t in s.values()]
        plan = op.plan
        n_slots = sum(s["vals"].numel() for s in panels.slabs if s is not None)
        entry = bound(plan.n_entries * plan.vals.element_size() + x.numel() * 4
                      + coo.shape[0] * 4, 2 * plan.n_entries, bw)
        entry.update(
            build_seconds=build_s, build_native=rec.native, build_stages=rec.seconds,
            numpy_body_slabs=rec.numpy_slabs, panels=sum(lay.panels for lay in panels.layouts),
            layouts=len(panels.layouts), entries=plan.n_entries, slots=n_slots,
            pieces=plan.n_pieces,
            virtual_chunks=0 if panels.virt_blocks is None else int(
                panels.virt_blocks.shape[0]),
            stream_bytes=tensor_bytes(*stream),
            plan_bytes=tensor_bytes(*(getattr(plan, f.name) for f in dataclasses.fields(plan)
                                      if isinstance(getattr(plan, f.name), torch.Tensor))),
            call_bytes=sell2_call_bytes(plan, x.numel() * 4), work=sell2_work(torch, plan),
            **time_windows(torch, lambda: sell2.sell2_dp_cuda(op, x, PLUS_TIMES)),
            plain_ms=time_ms(torch, lambda: sell2.dp_sell2_plain(
                dataclasses.replace(op, panels=panels), x, PLUS_TIMES,
                n_rows=coo.shape[0]), 3))
        entry["stages"] = stage_ms(torch, lambda: sell2.sell2_dp_cuda(op, x, PLUS_TIMES),
                                   r"sell2_\w+?_kernel")
        res[vd] = entry
        del op, panels, stream
    csr = csr_of(torch, coo)
    res["library_ms"] = time_ms(torch, lambda: torch.mv(csr, x), 20)
    del csr
    return res


def kron_coo():
    """The benchmark's Graph500 Kronecker graph at scale 20, made on the
    card from its configuration's graph seed, as a host COO."""
    from portbench.graphs import kronecker
    from sparseharness_tpu_torch.formats import coo_from_arrays

    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, "portbench", "configs", "g500-kron-s20.json")) as f:
        params = json.load(f)["params"]
    rows, cols, vals, n = kronecker.make(params, 0, "cuda")
    return coo_from_arrays(rows.cpu().numpy(), cols.cpu().numpy(), vals.cpu().numpy(), (n, n))


def kron_kernel_times(torch, errs) -> dict:
    """The sell2 kernel at the Kronecker graph, whose plan gathers x in
    degree order: held to the plain version over a CPU build's panels in
    f32 plus_times, min_plus and or_and (sell2_vs_plain, the worst
    plus_times error into ``errs``) with the launches of those calls; then
    the plus_times call timed in turns with the plan of x as it is, made by
    a CPU build that takes all of x for L1 (the kernel alone, a yardstick);
    the bound counts the matrix as portbench/work.py does."""
    from sparseharness_tpu_torch.formats import fold_duplicates
    from sparseharness_tpu_torch.harness import device_hbm_bandwidth
    from sparseharness_tpu_torch.ops import LAUNCHES, sell2
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    bw = device_hbm_bandwidth(torch.cuda.get_device_name(0))
    coo = kron_coo()
    n = coo.shape[0]
    before = dict(LAUNCHES)
    checked = sell2_vs_plain(torch, coo, [("plus_times", "float32"), ("min_plus", "float32"),
                                          ("or_and", "float32")], errs)
    launches = {k: LAUNCHES[k] - before[k] for k in ("sell2", "sell2_x")}
    if launches["sell2_x"] != launches["sell2"] or not launches["sell2"]:
        raise AssertionError(f"sell2 kron20: x copies and calls differ: {launches}")
    x = random_x(torch, PLUS_TIMES, n, np.random.default_rng(13))
    t0 = time.perf_counter()
    op = sell2.build_sell2(coo, PLUS_TIMES, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if op.plan.x_order != "degree":
        raise AssertionError("the Kronecker graph's plan keeps x as it is")
    l1 = sell2.L1_COLS
    sell2.L1_COLS = n
    try:
        as_is = sell2.build_sell2(coo, PLUS_TIMES, device="cpu").to("cuda")
    finally:
        sell2.L1_COLS = l1
    if as_is.plan.x_order != "as_is":
        raise AssertionError("the yardstick's plan orders x")
    plan = op.plan
    res = {"rows": n, "nnz": coo.nnz, "entries": plan.n_entries, "build_seconds": build_s,
           "comparisons": checked, "launches": launches, "max_abs_err": errs["sell2"],
           **bound(plan.n_entries * 4 + 2 * n * 4, 2 * plan.n_entries, bw),
           "hot_share": {}, "turns": []}
    runs = {"degree": op, "as_is": as_is}
    for label, o in runs.items():
        cols = o.plan.cols[:o.plan.n_entries]
        res["hot_share"][label] = int((cols < sell2.L1_COLS).sum()) / cols.numel()
    for label in ("degree", "as_is", "as_is", "degree"):
        fn = lambda o=runs[label]: sell2.sell2_dp_cuda(o, x, PLUS_TIMES)  # noqa: E731
        res["turns"].append({"x_order": label, **time_windows(torch, fn),
                             "stages": stage_ms(torch, fn, r"sell2_\w+?_kernel")})
    for label in runs:
        res[label] = {"ms": float(np.median([t["ms"] for t in res["turns"]
                                             if t["x_order"] == label]))}
    del op, as_is, runs
    csr = csr_of(torch, fold_duplicates(coo, np.add))
    res["library_ms"] = time_ms(torch, lambda: torch.mv(csr, x), 20)
    del csr
    return res


def stage_ms(torch, fn, pattern: str, n: int = 20) -> dict:
    """{match: {"ms": device ms per launch, "launches": launches recorded}}
    for each CUDA kernel that ``fn`` launches whose name matches
    ``pattern``, from torch.profiler over n calls. Each total is divided by
    the launches the profiler recorded, not by n, so calls it did not keep
    do not dilute the mean. Empty when the profiler records no device
    time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    totals = {}
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
        name = re.search(pattern, evt.key)
        if us and name and evt.count:
            us0, count0 = totals.get(name.group(0), (0.0, 0))
            totals[name.group(0)] = (us0 + us, count0 + evt.count)
    return {k: {"ms": us / count / 1e3, "launches": count} for k, (us, count) in totals.items()}


def kernel_spans(torch, fn, n: int = 20) -> list:
    """[(kernel name, start us, end us)] of the device kernels of n calls of
    fn, from torch.profiler's trace, in start order."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    return sorted(((e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"),
                  key=lambda sp: sp[1])


def call_metrics(spans, first: str) -> dict:
    """Medians over the calls in ``spans`` (kernel_spans): a call is a
    launch whose name holds ``first`` and the kernels after it. The first
    launch's ms, the later kernels' span (from their first start to their
    last end), how far they end past the first launch's end (``tail_ms``:
    what they add to a call), the gap to the next call's first launch, and
    the call from one first launch's start to the next one's. Empty when
    no call has a later kernel."""
    heads = [i for i, sp in enumerate(spans) if first in sp[0]]
    rows = {"first_ms": [], "rest_ms": [], "tail_ms": [], "gap_ms": [], "call_ms": []}
    for a, b in zip(heads, heads[1:] + [len(spans)]):
        rest = spans[a + 1:b]
        if not rest:
            continue
        end = max(sp[2] for sp in rest)
        rows["first_ms"].append((spans[a][2] - spans[a][1]) / 1e3)
        rows["rest_ms"].append((end - min(sp[1] for sp in rest)) / 1e3)
        rows["tail_ms"].append((end - spans[a][2]) / 1e3)
        if b < len(spans):
            rows["gap_ms"].append((spans[b][1] - end) / 1e3)
            rows["call_ms"].append((spans[b][1] - spans[a][1]) / 1e3)
    return {k: float(np.median(v)) for k, v in rows.items() if v}


def call_trace(torch, fn, first: str, n: int = 20) -> dict:
    """call_metrics of n calls of fn."""
    return call_metrics(kernel_spans(torch, fn, n), first)


# ------------------------------------------------------------------ sell

SELL_N = 1 << 18       # the widest x that sell's XROWS_MAX admits: 262,144 columns
SELL_BAND_N = 1 << 16  # the sell fixpoints' and the CLI's band (about 1,100 steps)


def sell_cases(torch):
    """(matrix, build keywords): the matrices of tests/test_torch_sell.py
    and the gate's matrix."""
    from sparseharness_tpu_torch.formats import coo_from_arrays, power_law_coo, random_coo

    rng = np.random.default_rng(0)
    hub_cols = rng.choice(600, 400, replace=False)
    bg = random_coo(600, 600, 2000, seed=2)
    hub = coo_from_arrays(np.r_[np.zeros(400, np.int64), bg.rows], np.r_[hub_cols, bg.cols],
                          rng.uniform(0.1, 1.0, 400 + bg.nnz).astype(np.float32), (600, 600))
    empty = coo_from_arrays([0, 0, 0, 5, 5], [3, 3, 7, 1, 200],
                            np.float32([1, 2, 3, 4, 5]), (300, 300))
    return [(power_law_coo(1500, 9000, seed=4), {}), (hub, {}),
            (power_law_coo(2000, 30000, seed=5), {"slab_nnz": 8000}), (empty, {}),
            (random_coo(1138, 1138, 4054, seed=0), {})]


def sell_vs_plain(torch, coo, kw, names, errs) -> int:
    """The fused depth-0 kernel alone against fused_plain, the level kernel
    alone (from fused_plain's level-0 rows) against its model levels_plain
    with the operand's slabs as built, with the slabs of more than 500
    rows on the work path (a launch of both paths where the matrix has
    one) and with every slab on the work path, and both sell kernels (one sell_dp_cuda call) against dp_sell_plain, on
    one matrix: bit for bit for every semiring, plus_times included, and
    the same bits on a second call. Returns the number of comparisons."""
    from sparseharness_tpu_torch.ops import sell
    from sparseharness_tpu_torch.semiring import get_semiring

    rng = np.random.default_rng(15)
    for name in names:
        sr = get_semiring(name)
        m = coo.with_values(coo.vals != 0) if sr.dtype == torch.bool else coo
        op = sell.build_sell(m, sr, device="cuda", **kw)
        x = random_x(torch, sr, m.shape[1], rng)
        x2d = sell.pad_x2d(op, x, sr)
        work_ref, dp_ref = sell.fused_plain(op, x2d, sr)
        work, dp = torch.zeros_like(work_ref), torch.zeros_like(dp_ref)
        sell.fused_cuda(op, x2d, sr, work, dp)
        for label, got0, ref0 in (("work", work, work_ref), ("dp", dp, dp_ref)):
            check_kernel(torch, f"sell fused {name} ({label})", got0.view(torch.int32),
                         ref0.view(torch.int32), None)
        for path, lop in (("built", op), ("split at 500 rows", sell.relevel(op, 500)),
                          ("work path", sell.relevel(op, 0))):
            work, dp = sell.fused_plain(lop, x2d, sr)
            lwork, ldp = work.clone(), dp.clone()
            sell.levels_cuda(lop, sr, work, dp)
            sell.levels_plain(lop, sr, lwork, ldp)
            for label, got0, ref0 in (("work", work, lwork), ("dp", dp, ldp)):
                errs["sell_level"] = max(errs["sell_level"], check_kernel(
                    torch, f"sell level {name} {path} ({label})", got0.view(torch.int32),
                    ref0.view(torch.int32), None))
        got = sell.sell_dp_cuda(op, x2d, sr)
        check_same_bits(torch, f"sell {name}", got, sell.sell_dp_cuda(op, x2d, sr))
        ref = sell.dp_sell_plain(op, x, sr, n_rows=m.shape[0])
        if sr.dtype == torch.bool:
            got = got > 0
        elif not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"sell {name}: kernel != plain in "
                                 f"{int((got.view(torch.int32) != ref.view(torch.int32)).sum())}"
                                 " rows")
        err = check_kernel(torch, f"sell {name}", got, ref, None)
        errs["sell_fused"] = max(errs["sell_fused"], err)
        errs["sell_level"] = max(errs["sell_level"], err)
        del op, x2d, work, dp, work_ref, dp_ref, lwork, ldp
    return 5 * len(names)


def sell_main_path(torch, coo, out):
    """The 1 << 18 band through make_spmv_problem and benchmark_spmv with
    variant="sell", gold-gated in f32. Returns the problem, whose operand
    the kernel-time phase reuses."""
    from sparseharness_tpu_torch.algorithms import make_spmv_problem
    from sparseharness_tpu_torch.gold import Correctness, spmv_abs_bound, spmv_gold
    from sparseharness_tpu_torch.harness import (
        BenchmarkConfig, benchmark_spmv, device_hbm_bandwidth, variant_bytes,
    )
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    bw = device_hbm_bandwidth(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    prob = make_spmv_problem(coo, PLUS_TIMES, "sell", seed=6)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    x_np = prob.x0.cpu().numpy()
    gold = spmv_gold(coo, x_np, prob.y.cpu().numpy(), PLUS_TIMES)
    res = benchmark_spmv(prob, gold=gold, config=BenchmarkConfig(trials=5, launches_per_trial=20),
                         matrix_name=f"banded{coo.shape[0]}", nnz=coo.nnz,
                         gold_scale=spmv_abs_bound(coo, x_np))
    if res.correctness is not Correctness.CORRECT:
        raise AssertionError(f"sell on banded{coo.shape[0]}: {res.correctness}")
    op = prob.operand
    n_bytes = variant_bytes("sell", op, prob.x0.numel() * 4, coo.shape[0] * 4)
    out.append({
        "variant": "sell", "rows": coo.shape[0], "nnz": coo.nnz,
        "correctness": res.correctness.value, "build_seconds": build_s,
        "slabs": len(op.layouts), "max_levels": op.max_levels,
        "phase_a_sublanes": int(op.lanesel.shape[0]),
        "packed_slots": int(op.lanesel.numel() + op.idx.numel()),
        "median_ms": res.median_ns * 1e-6, "best_ms": res.best_ns * 1e-6,
        "gnnz_per_s": res.gnnz_per_s, "bytes_per_s": n_bytes / (res.median_ns * 1e-9),
        "bound_ms": n_bytes / bw * 1e3, "roofline_frac": res.roofline_frac,
    })
    return prob


def sell_fixpoints(torch, band, out) -> None:
    """sssp and bfs with variant="sell" on the 1 << 16 band: one sell_fused
    and one sell_level launch a step. Certificates as phase 3's, with the
    plain band dp."""
    from sparseharness_tpu_torch.algorithms import bfs, sssp
    from sparseharness_tpu_torch.ops import LAUNCHES, build_operand, dp_bsr_band_plain, fold_dp
    from sparseharness_tpu_torch.semiring import MIN_PLUS

    n = band.shape[0]

    def run(app):
        before = dict(LAUNCHES)
        t0 = time.perf_counter()
        r = app(band, 0, variant="sell")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        for kernel in ("sell_fused", "sell_level"):
            if LAUNCHES[kernel] - before[kernel] != r.iterations:
                raise AssertionError(f"{app.__name__}: {LAUNCHES[kernel] - before[kernel]} "
                                     f"{kernel} launches for {r.iterations} steps")
        return r, dt

    r, dt = run(sssp)
    op = build_operand(band, MIN_PLUS, "bsr_band")
    again = torch.minimum(r.x, fold_dp(dp_bsr_band_plain(op, r.x, MIN_PLUS, n_rows=n)[:n], None,
                                       MIN_PLUS, None, None))
    cert = bool(r.converged and float(r.x[0]) == 0.0 and torch.equal(again, r.x))
    del op, again
    out.append({"app": "sssp", "variant": "sell", "rows": n, "iterations": r.iterations,
                "converged": r.converged, "seconds": dt,
                "certificate": "x[0] == 0 and min(x, A⊗x) == x", "certified": cert})
    if not cert:
        raise AssertionError("sell sssp certificate failed")
    r, dt = run(bfs)
    want = torch.from_numpy(((np.arange(n) + BAND - 1) // BAND).astype(np.int32)).cuda()
    cert = bool(r.converged and bool(r.x.all()) and torch.equal(r.aux, want))
    out.append({"app": "bfs", "variant": "sell", "rows": n, "iterations": r.iterations,
                "converged": r.converged, "seconds": dt,
                "certificate": f"levels == ceil(i / {BAND})", "certified": cert})
    if not cert:
        raise AssertionError("sell bfs certificate failed")


def cli_path(torch, band, small, d, out) -> None:
    """The nine CLI commands in process, as python -m
    sparseharness_tpu_torch.cli runs them, on .mtx files written by the
    port's write_mtx into directory ``d`` (band.mtx stays for the
    native_host phase); then spmv -k sell as a subprocess. Every return code
    must be 0, every JSONL row must parse, no row may be gold-checked
    incorrect, and the rows of spmv -k sell and sssp -k sell on the band,
    the sweep's sell row on the small matrix and the subprocess must read
    correct. The commands parse the files natively."""
    import contextlib
    import io
    import os

    from sparseharness_tpu_torch.cli import main as cli
    from sparseharness_tpu_torch.formats import write_mtx

    band_path, small_path = os.path.join(d, "band.mtx"), os.path.join(d, "small.mtx")
    jsonl, sql = os.path.join(d, "out.jsonl"), os.path.join(d, "out.sql")
    t0 = time.perf_counter()
    write_mtx(band_path, band)
    write_mtx(small_path, small)
    out.append({"write_mtx_seconds": time.perf_counter() - t0})
    sink = ["--jsonl", jsonl, "--sql", sql]
    runs = [("spmv", ["-m", band_path, "-k", "sell", "-n", "3"] + sink),
            ("sssp", ["-m", band_path, "-k", "sell", "-n", "2"] + sink),
            ("spmv", ["-m", small_path, "--sweep", "-n", "2"] + sink),
            ("sssp", ["-m", small_path, "--stepped", "-k", "auto", "-n", "2"] + sink),
            ("bfs", ["-m", small_path, "--roots", "0,5,9", "-n", "2"] + sink),
            ("pr", ["-m", small_path, "-n", "2"] + sink),
            ("scc", ["-m", small_path, "--full", "-n", "2"] + sink),
            ("eigenvector", ["-m", small_path, "-n", "2"] + sink),
            ("cc", ["-m", small_path, "-n", "2"] + sink),
            ("widest_path", ["-m", small_path, "-k", "auto", "-n", "2"] + sink),
            ("just_parser", ["-m", small_path, "-k", "sell", "-n", "2"]),
            ("just_parser", ["-m", small_path, "-k", "sell", "-n", "2", "--no-native"])]
    for app, argv in runs:
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.COMMANDS[app](argv)
        torch.cuda.synchronize()
        lines = buf.getvalue().strip().splitlines()
        out.append({"app": app, "args": " ".join(os.path.basename(a) for a in argv
                                                 if not a.endswith((".jsonl", ".sql"))),
                    "rc": rc, "seconds": time.perf_counter() - t0,
                    "last_line": lines[-1] if lines else ""})
        if rc != 0:
            raise AssertionError(f"cli {app} {argv}: rc {rc}\n{buf.getvalue()}")
    with open(jsonl) as f:
        rows = [json.loads(line) for line in f]
    with open(sql) as f:
        n_sql = sum(1 for line in f if line.startswith("INSERT INTO"))
    if len(rows) != n_sql or not rows:
        raise AssertionError(f"{len(rows)} JSONL rows against {n_sql} SQL rows")
    wrong = [r for r in rows if r["correctness"] in ("incorrect", "bad_length")]
    if wrong:
        raise AssertionError(f"cli rows gold-checked wrong: {wrong}")
    for label, path, kernel in (("spmv -k sell on the band", band_path, "sell"),
                                ("sssp -k sell on the band", band_path, "sssp:sell"),
                                ("the sweep's sell point", small_path, "sell")):
        mine = [r["correctness"] for r in rows
                if r["matrix"] == path and r["kernel"] == kernel]
        if not mine or set(mine) != {"correct"}:
            raise AssertionError(f"cli {label}: correctness {mine}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "sparseharness_tpu_torch.cli", "spmv", "-m", small_path,
         "-k", "sell", "-n", "2"], cwd=os.path.dirname(os.path.abspath(__file__)),
        capture_output=True, text=True, timeout=600)
    out.append({"subprocess": "python -m sparseharness_tpu_torch.cli spmv -k sell -n 2",
                "rc": proc.returncode, "seconds": time.perf_counter() - t0,
                "last_line": (proc.stdout.strip().splitlines() or [""])[-1]})
    if proc.returncode != 0 or not out[-1]["last_line"].endswith(", correct"):
        raise AssertionError(f"cli subprocess: rc {proc.returncode}, "
                             f"{out[-1]['last_line']!r}\n{proc.stderr}")
    out.append({"jsonl_rows": len(rows), "sql_rows": n_sql,
                "kernels": sorted({r["kernel"] for r in rows})})


def _with_native(flag: str, fn):
    """fn() with SPARSEHARNESS_TPU_NATIVE set to flag, and its seconds."""
    before = os.environ.get("SPARSEHARNESS_TPU_NATIVE")
    os.environ["SPARSEHARNESS_TPU_NATIVE"] = flag
    try:
        t0 = time.perf_counter()
        res = fn()
        return res, time.perf_counter() - t0
    finally:
        if before is None:
            del os.environ["SPARSEHARNESS_TPU_NATIVE"]
        else:
            os.environ["SPARSEHARNESS_TPU_NATIVE"] = before


def same_sell2(torch, op_a, op_b) -> int:
    """Fails unless two sell2 operands of CPU builds hold the same arrays,
    panels and plan; returns the tensors compared."""
    a, b = op_a.panels, op_b.panels
    if a.layouts != b.layouts or (a.n_chunks, op_a.base_pad) != (b.n_chunks, op_b.base_pad):
        raise AssertionError("sell2 native vs NumPy: layouts differ")
    pairs = [(f"slab {i} {k}", sa[k], sb[k]) for i, (sa, sb) in
             enumerate(zip(a.slabs, b.slabs, strict=True)) if sa is not None for k in sa]
    pairs += [(f, getattr(a, f), getattr(b, f)) for f in ("piece_owner", "virt_blocks")]
    pairs += [(f"plan.{f.name}", getattr(op_a.plan, f.name), getattr(op_b.plan, f.name))
              for f in dataclasses.fields(op_a.plan)
              if isinstance(getattr(op_a.plan, f.name), torch.Tensor)]
    for label, x, y in pairs:
        if (x is None) != (y is None) or (x is not None and not (
                x.dtype == y.dtype and torch.equal(_bits(torch, x), _bits(torch, y)))):
            raise AssertionError(f"sell2 native vs NumPy: {label} differs")
    return len(pairs)


def _bits(torch, t):
    """A float tensor's bit patterns, so that equality is bit for bit."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    return t


def native_host(torch, rcoo, band, band_path) -> dict:
    """The native host path against the NumPy one on the card's host, at
    full size: the sell2 build of the ragged bench matrix both ways on the
    CPU (every array identical, panels and plan; both times, the native
    build's seconds by stage and its count of NumPy-body slabs), then the
    sell2 kernel on the native operand, moved to the card, against its
    plain version and the gold; RCM of the shuffled
    1 << 16 band both ways (the same permutation); the parse of the CLI's
    8.3 M-entry band.mtx both ways (the same indices, values within
    rtol 1e-6)."""
    from sparseharness_tpu_torch.formats import (
        native_io, permute_coo, rcm_permutation, read_mtx,
    )
    from sparseharness_tpu_torch.gold import Correctness, check_result, spmv_abs_bound, spmv_gold
    from sparseharness_tpu_torch.ops import sell2, spmv
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    res = {"library": str(native_io.library_path().relative_to(
        os.path.dirname(os.path.abspath(__file__))))}

    def build():
        rec = sell2.EncodeRecord()
        return sell2.build_sell2(rcoo, PLUS_TIMES, device="cpu", record=rec), rec

    (ref, ref_rec), numpy_s = _with_native("0", build)
    (op, rec), native_s = _with_native("1", build)
    if not rec.native or ref_rec.native:
        raise AssertionError("sell2 builds did not take the paths asked for")
    res["sell2"] = {"rows": rcoo.shape[0], "nnz": rcoo.nnz, "numpy_seconds": numpy_s,
                    "native_seconds": native_s, "speedup": numpy_s / native_s,
                    "native_stages": rec.seconds, "numpy_stages": ref_rec.seconds,
                    "numpy_body_slabs": rec.numpy_slabs,
                    "tensors_identical": same_sell2(torch, op, ref)}
    del ref
    op = op.to("cuda")
    x = random_x(torch, PLUS_TIMES, rcoo.shape[1], np.random.default_rng(41))
    got = sell2.sell2_dp_cuda(op, x, PLUS_TIMES)
    plain = sell2.dp_sell2_plain(op, x, PLUS_TIMES, n_rows=rcoo.shape[0])
    x_np = x.cpu().numpy()
    bound = torch.from_numpy(spmv_abs_bound(rcoo, x_np).astype(np.float32)).cuda()
    n = rcoo.shape[0]
    res["sell2"]["max_abs_err"] = check_kernel(torch, "native sell2 vs plain", got[:n],
                                               plain[:n], bound)
    y = spmv(op, x, sr=PLUS_TIMES, variant="sell2", n_rows=n)
    gold = spmv_gold(rcoo, x_np, np.zeros(n, np.float32), PLUS_TIMES)
    verdict = check_result(y.cpu().numpy(), gold, scale=spmv_abs_bound(rcoo, x_np))
    res["sell2"]["gold"] = verdict.value
    if verdict is not Correctness.CORRECT:
        raise AssertionError(f"native sell2 spmv: {verdict}")
    del op, got, plain, y

    n = band.shape[0]
    shuffled = permute_coo(band, np.random.default_rng(37).permutation(n).astype(np.int32))
    perm_np, rcm_numpy_s = _with_native("0", lambda: rcm_permutation(shuffled))
    perm, rcm_native_s = _with_native("1", lambda: rcm_permutation(shuffled))
    if not np.array_equal(perm, perm_np):
        raise AssertionError("native RCM permutation != NumPy's")
    res["rcm"] = {"rows": n, "nnz": shuffled.nnz, "numpy_seconds": rcm_numpy_s,
                  "native_seconds": rcm_native_s, "speedup": rcm_numpy_s / rcm_native_s,
                  "same_permutation": True}

    np_coo, parse_numpy_s = _with_native("0", lambda: read_mtx(band_path))
    nat_coo, parse_native_s = _with_native("1", lambda: read_mtx(band_path))
    if not (np.array_equal(nat_coo.rows, np_coo.rows)
            and np.array_equal(nat_coo.cols, np_coo.cols)):
        raise AssertionError("native parse indices != NumPy's")
    if not np.allclose(nat_coo.vals, np_coo.vals, rtol=1e-6, atol=0):
        raise AssertionError("native parse values outside rtol 1e-6 of NumPy's")
    res["parse"] = {"file_bytes": os.path.getsize(band_path), "nnz": nat_coo.nnz,
                    "numpy_seconds": parse_numpy_s, "native_seconds": parse_native_s,
                    "speedup": parse_numpy_s / parse_native_s,
                    "values_bit_equal": bool(np.array_equal(nat_coo.vals, np_coo.vals))}
    return res


def sell_kernel_times(torch, op, coo, errs) -> dict:
    """The sell kernels at the 1 << 18 band: the whole dp, the fused depth-0
    launch alone and the level launch alone (CUDA events), their plain
    versions, torch.mv on a CSR tensor of the same matrix, the bounds and
    the bytes each moves by its design. Whole dp: the operand's arrays, x
    and the output (variant_bytes), 2 ops per nonzero. The fused launch:
    its level-0 idx rows, lanesel, vals, blocksel and x in, the level-0
    rows out (fused_traffic), one ⊗ per nonzero and one ⊕ per nonzero but
    the first of each level-0 output. The level launch (level_traffic):
    the level-0 rows and the later levels' idx region rows in, the final
    rows of the slabs with a later level out, one ⊕ per valid idx slot
    past a run's first. The fused launch's level-0 rows, the
    level launch's dp and the whole dp are held against the plain versions
    bit for bit first. Then torch.profiler's device ms a launch of each
    kernel inside the dp (the level launch's span there starts while the
    fused launch drains, so it holds its wait), the level launch alone
    (back to back: its own device ms, which the kernels line takes), the
    dp's trace (call_trace: how far the level launch ends past the fused
    launch's end), each also with every slab on the level launch's work
    path, and a `spmv` call with variant="sell": its ms, the host's enqueue
    ms and its launches."""
    from sparseharness_tpu_torch.harness import device_hbm_bandwidth, variant_bytes
    from sparseharness_tpu_torch.ops import LAUNCHES, sell, spmv
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    bw = device_hbm_bandwidth(torch.cuda.get_device_name(0))
    n = coo.shape[0]
    sr = PLUS_TIMES
    x = random_x(torch, sr, coo.shape[1], np.random.default_rng(16))
    x2d = sell.pad_x2d(op, x, sr)
    work_ref, dp_ref = sell.fused_plain(op, x2d, sr)
    work, dp = torch.zeros_like(work_ref), torch.zeros_like(dp_ref)
    sell.fused_cuda(op, x2d, sr, work, dp)
    errs["sell_fused"] = max(errs["sell_fused"], check_kernel(
        torch, "sell fused launch at full width", work, work_ref, None), check_kernel(
        torch, "sell fused launch at full width (dp)", dp, dp_ref, None))
    sell.levels_plain(op, sr, work_ref, dp_ref)
    sell.levels_cuda(op, sr, work, dp)
    errs["sell_level"] = max(errs["sell_level"], check_kernel(
        torch, "sell level launch at full width", dp, dp_ref, None), check_kernel(
        torch, "sell dp at full width", dp, sell.dp_sell_plain(op, x, sr, n_rows=n), None))
    del work_ref, dp_ref

    traffic = sell.fused_traffic(op)
    fused_ops = 2 * coo.nnz - traffic["live_outputs"]
    levels = sell.level_traffic(op)
    work_op = sell.relevel(op, 0)
    level0 = [sell.level_plain(sell.phase_a_plain(slab, x2d, sr), slab["idx0"],
                               lay.levels[0], sr) for slab, lay in zip(op.slabs, op.layouts)]

    def plain_levels():
        for slab, lay, src in zip(op.slabs, op.layouts, level0):
            for li in range(1, len(lay.levels)):
                src = sell.level_plain(src, slab[f"idx{li}"], lay.levels[li], sr)

    before = dict(LAUNCHES)
    spmv(op, x, sr=sr, variant="sell", n_rows=n)
    torch.cuda.synchronize()
    per_call = {k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]}
    if per_call != {"sell_fused": 1, "sell_level": 1}:
        raise AssertionError(f"a sell spmv call launched {per_call}, not one fused and one "
                             "level launch")
    f32 = 4
    res = {
        "dp": {**bound(variant_bytes("sell", op, x.numel() * f32, n * f32), 2 * coo.nnz, bw),
               "design_bytes": traffic["staged_bytes"] + levels["design_bytes"],
               **time_windows(torch, lambda: sell.sell_dp_cuda(op, x2d, sr)),
               "plain_ms": time_ms(torch, lambda: sell.dp_sell_plain(op, x, sr, n_rows=n), 3)},
        "sell_fused": {
            **bound(traffic["bound_bytes"], fused_ops, bw),
            "design_bytes": traffic["staged_bytes"], "in_place_bytes": traffic["in_place_bytes"],
            "traffic": traffic,
            **time_windows(torch, lambda: sell.fused_cuda(op, x2d, sr, work, dp)),
            "plain_ms": time_ms(torch, lambda: sell.fused_plain(op, x2d, sr), 3)},
        "sell_level": {
            **bound(levels["bound_bytes"], levels["operations"], bw),
            "traffic": levels, "work_path_design_bytes": sell.level_traffic(work_op)[
                "design_bytes"],
            **time_windows(torch, lambda: sell.levels_cuda(op, sr, work, dp)),
            "plain_ms": time_ms(torch, plain_levels, 3)},
        "spmv_call": {**time_windows(torch, lambda: spmv(op, x, sr=sr, variant="sell",
                                                         n_rows=n)),
                      "launches_per_call": per_call},
        "depth_rows": list(op.depth_rows), "work_rows": op.work_rows,
        "work_path_work_rows": work_op.work_rows,
        # device ms per launch inside the dp, from torch.profiler: the level
        # launch's CUDA-event time above is the host's, when it enqueues
        # slower than the card runs it
        "profiler": stage_ms(torch, lambda: sell.sell_dp_cuda(op, x2d, sr),
                             r"sell_(fused|level)_kernel"),
        "profiler_work_path": stage_ms(torch, lambda: sell.sell_dp_cuda(work_op, x2d, sr),
                                       r"sell_(fused|level)_kernel"),
        "level_alone": stage_ms(torch, lambda: sell.levels_cuda(op, sr, work, dp),
                                r"sell_level_kernel"),
        "call_trace": call_trace(torch, lambda: sell.sell_dp_cuda(op, x2d, sr), "sell_fused"),
        "call_trace_work_path": call_trace(
            torch, lambda: sell.sell_dp_cuda(work_op, x2d, sr), "sell_fused"),
    }
    alone = res["level_alone"].get("sell_level_kernel")
    trace = res["call_trace"]
    if alone:
        res["sell_level"]["device_ms"] = alone["ms"]
    if "tail_ms" in trace:
        res["sell_level"]["tail_ms"] = trace["tail_ms"]
    if alone and "call_ms" in trace:
        # the aims: the level launch at most 0.0052 ms on the card, a dp at
        # most the fused launch + 0.004 ms (the trace's call, from one
        # fused launch's start to the next one's)
        res["aims"] = {"level_device_ms": alone["ms"], "level_aim_ms": 0.0052,
                       "dp_call_ms": trace["call_ms"],
                       "dp_aim_ms": trace["first_ms"] + 0.004}
    csr = csr_of(torch, coo)
    res["library_ms"] = time_ms(torch, lambda: torch.mv(csr, x), 20)
    del csr, work, dp, level0, work_op
    return res


# ------------------------------------------------------------------ SpMM

SPMM_BAND_N = 1 << 16   # the band-routed multi-source depth (about 1,200 steps)
SPMM_ROOTS = 128        # roots of the full-width multi-source solves


def random_block(torch, sr, n: int, m: int, gen) -> "torch.Tensor":
    """An (n, m) X on the card from a seeded CUDA generator."""
    u = torch.rand((n, m), generator=gen, device="cuda")
    if sr.dtype == torch.bool:
        return u < 0.3
    if sr.dtype == torch.int32:
        return (u * n).to(torch.int32)
    return u * 0.9 + 0.1


def check_same_bits(torch, label, got, again) -> None:
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"{label}: two runs differ")


def spmm_vs_plain_small(torch, errs) -> int:
    """Both SpMM kernels against their plain versions on the tests'
    matrices: spmm_tiles for every semiring and strip type over bsr_ell and
    bsr_fused strips of random_coo(300, 257, 2500, seed=3) and of
    random_coo(64, 4096, 6000, seed=5) (K > 8), and over the explicit
    columns of banded_coo(96, 40, seed=53), at m in (1, 5, 8, 32, 40, 200),
    through both of its thread maps; spmm_band in f32 and bf16 at m in (1,
    40, 200). Bit for bit but
    plus_times, which must also give the same bits on a second run."""
    from sparseharness_tpu_torch.formats import banded_coo, random_coo
    from sparseharness_tpu_torch.ops import bsr_band, bsr_ell, bsr_fused, spmm_tiles
    from sparseharness_tpu_torch.semiring import PLUS_TIMES, get_semiring

    gen = torch.Generator(device="cuda").manual_seed(17)
    mats = [random_coo(300, 257, 2500, seed=3), random_coo(64, 4096, 6000, seed=5)]
    band = banded_coo(96, 40, seed=53)
    checked = 0
    for name, vd in all_cases(torch):
        sr = get_semiring(name)
        ops = []
        for coo in mats:
            ops.append((f"bsr_ell{coo.shape}", coo.shape[1], bsr_ell.build_bsr_ell(
                coo, sr, value_dtype=vd, device="cuda")))
            ops.append((f"bsr_fused{coo.shape}", coo.shape[1],
                        spmm_tiles.ell_operand_from_fused(bsr_fused.build_bsr_fused(
                            coo, sr, value_dtype=vd, device="cuda"))))
        ops.append(("band(96, 40)", 96, spmm_tiles.ell_operand_from_band(
            bsr_band.build_bsr_band(band, sr, value_dtype=vd, device="cuda"))))
        for label, n_cols, op in ops:
            bn = op.tiles.shape[2] // op.tile_cols.shape[1]
            for m in (1, 5, 8, 32, 40, 200):
                x2d = spmm_tiles.pad_x_block(random_block(torch, sr, n_cols, m, gen), bn, sr)
                got = spmm_tiles.spmm_tiles_cuda(op.tiles, op.tile_cols, x2d, sr)
                ref = spmm_tiles.spmm_tiles_plain(op.tiles, op.tile_cols, x2d, sr)
                bound = None
                if name == "plus_times":
                    check_same_bits(torch, f"spmm_tiles {label} {vd} m={m}", got,
                                    spmm_tiles.spmm_tiles_cuda(op.tiles, op.tile_cols, x2d, sr))
                    bound = spmm_tiles.spmm_tiles_plain(op.tiles.abs(), op.tile_cols,
                                                        x2d.abs(), PLUS_TIMES)
                errs["spmm_tiles"] = max(errs["spmm_tiles"], check_kernel(
                    torch, f"spmm_tiles {label} {name}/{vd} m={m}", got, ref, bound))
                checked += 1
    for vd in ("float32", "bfloat16"):
        for coo in (banded_coo(1024, 7, seed=1), banded_coo(600, 4, seed=3), band):
            op = bsr_band.build_bsr_band(coo, PLUS_TIMES, value_dtype=vd, device="cuda")
            for m in (1, 40, 200):
                x2d = bsr_band.pad_x_block(op, random_block(torch, PLUS_TIMES, coo.shape[1],
                                                            m, gen))
                args = dict(c0=op.c0, k_win=op.k_win)
                got = bsr_band.band_spmm_cuda(op.strips, x2d, spans=op.spans, **args)
                check_same_bits(torch, f"spmm_band {coo.shape} {vd} m={m}", got,
                                bsr_band.band_spmm_cuda(op.strips, x2d, spans=op.spans, **args))
                ref = bsr_band.band_spmm_plain(op.strips, x2d, **args)
                bound = bsr_band.band_spmm_plain(op.strips.abs(), x2d, **args)
                errs["spmm_band"] = max(errs["spmm_band"], check_kernel(
                    torch, f"spmm_band {coo.shape} {vd} m={m}", got, ref, bound))
                checked += 1
    return checked


def spmm_band_nonfinite(torch, coo, errs) -> dict:
    """spmm_band at full width (the bench band, f32 strips, m = 128) on an
    X with +inf, −inf and NaN in 96 seeded places, against the plain
    version, which multiplies every strip slot: NaN exactly where the plain
    version's is (a pad it skips meets a non-finite X value: 0·inf), ±inf
    equal, the rows and columns whose window holds no non-finite value
    within PT_DELTA · max(1, |y|, Σ|a·x|), and the same bits (NaNs
    included) on a second call."""
    from sparseharness_tpu_torch.ops import Geometry, bsr_band, build_operand
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    n = coo.shape[0]
    op = build_operand(coo, PLUS_TIMES, "bsr_band", Geometry(8, 128, "float32"))
    gen = torch.Generator(device="cuda").manual_seed(59)
    x = random_block(torch, PLUS_TIMES, n, 128, gen)
    rng = np.random.default_rng(61)
    rows = torch.as_tensor(rng.integers(0, n, 96), device="cuda")
    cols = torch.as_tensor(rng.integers(0, 128, 96), device="cuda")
    x[rows, cols] = torch.tensor([float("inf"), float("-inf"), float("nan")],
                                 device="cuda").repeat(32)
    x2d = bsr_band.pad_x_block(op, x)
    args = dict(c0=op.c0, k_win=op.k_win, spans=op.spans)
    got = bsr_band.band_spmm_cuda(op.strips, x2d, **args)
    check_same_bits(torch, "spmm_band non-finite X", got,
                    bsr_band.band_spmm_cuda(op.strips, x2d, **args))
    ref = bsr_band.band_spmm_plain(op.strips, x2d, c0=op.c0, k_win=op.k_win)
    sum_abs = bsr_band.band_spmm_plain(op.strips.abs(), x2d.abs(), c0=op.c0, k_win=op.k_win)
    nan = ref.isnan()
    inf = ref.isinf()
    if not torch.equal(got.isnan(), nan):
        raise AssertionError(f"spmm_band non-finite X: NaN in {int(got.isnan().sum())} "
                             f"outputs, the plain version in {int(nan.sum())}")
    if not torch.equal(got[inf], ref[inf]):
        raise AssertionError("spmm_band non-finite X: an infinite output differs")
    fin = sum_abs.isfinite()
    errs["spmm_band"] = max(errs["spmm_band"], check_kernel(
        torch, "spmm_band non-finite X", got[fin], ref[fin], sum_abs[fin]))
    return {"nan_outputs": int(nan.sum()), "inf_outputs": int(inf.sum()),
            "finite_checked": int(fin.sum()), "non_finite_x": 96}


def column_spmvs(torch, coo, op, variant, sr, x, cols, gold_coo) -> dict:
    """spmv of X's columns ``cols`` through the port's SpMV path; the first
    is gated against the NumPy gold (within 1e-4 · max(1, |gold|, Σ|a·x|)
    for plus_times, exactly otherwise)."""
    from sparseharness_tpu_torch.gold import Correctness, check_result, spmv_abs_bound, spmv_gold
    from sparseharness_tpu_torch.ops import spmv

    n = coo.shape[0]
    out = {j: spmv(op, x[:, j].contiguous(), None, sr=sr, variant=variant, n_rows=n)
           for j in cols}
    x0 = x[:, cols[0]].cpu().numpy()
    gold = spmv_gold(gold_coo, x0, np.full(n, sr.zero, sr.np_dtype), sr)
    plus = sr.name == "plus_times"
    corr = check_result(out[cols[0]].cpu().numpy(), gold, exact=not plus,
                        scale=spmv_abs_bound(gold_coo, x0) if plus else None)
    if corr is not Correctness.CORRECT:
        raise AssertionError(f"spmv gate of column {cols[0]} ({sr.name}, {variant}): {corr}")
    return out


def bf16_values(torch, coo):
    """coo with its values as bf16 strips hold them."""
    return coo.with_values(torch.from_numpy(coo.vals).to(torch.bfloat16).float().numpy())


def spmm_full_width(torch, coo, bcoo, out, errs) -> None:
    """spmm at full width through the entry point: the bench band at m =
    128 and 256 (f32) and 128 (bf16 strips), which must launch spmm_band;
    the blocked matrix under plus_times at m = 8 and 128 and min_plus and
    or_and at m = 128 through the bsr_ell and the bsr_fused operand, which
    must launch spmm_tiles. Each result is held against the chunked plain
    version on the card, and four of its columns against the port's
    spmv of that column (the first gated against the NumPy gold): bit for
    bit for min_plus and or_and, within PT_DELTA · max(1, |y|, Σ|a·x|) for
    plus_times."""
    from sparseharness_tpu_torch.ops import (
        LAUNCHES, Geometry, build_operand, ell_operand_from_fused, spmm, spmm_band_plain,
        spmm_bsr_ell_plain,
    )
    from sparseharness_tpu_torch.ops.torch_ops import fold_dp
    from sparseharness_tpu_torch.semiring import MIN_PLUS, OR_AND, PLUS_TIMES

    gen = torch.Generator(device="cuda").manual_seed(21)

    def run(kernel, label, op, variant, sr, x, n, plain, abs_plain, spmv_cols):
        before = LAUNCHES[kernel]
        t0 = time.perf_counter()
        y = spmm(op, x, sr=sr, variant=variant, n_rows=n)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if LAUNCHES[kernel] - before != 1:
            raise AssertionError(f"{label}: spmm did not launch {kernel}")
        ref = plain(x)
        bound = abs_plain(x) if sr is PLUS_TIMES else None
        errs[kernel] = max(errs[kernel], check_kernel(torch, label, y, ref, bound))
        for j, col in spmv_cols.items():
            if j < x.shape[1]:
                check_kernel(torch, f"{label} column {j} vs spmv", y[:, j], col,
                             None if bound is None else bound[:, j])
        out.append({"spmm": label, "kernel": kernel, "shape": list(y.shape),
                    "seconds": dt, "columns_vs_spmv": sorted(j for j in spmv_cols
                                                            if j < x.shape[1]),
                    "spmm_tiles_launches": (
                        {f"{label.split()[0]} {sr.name} m={x.shape[1]}": 1}
                        if kernel == "spmm_tiles" else {})})

    n = coo.shape[0]
    x256 = random_block(torch, PLUS_TIMES, n, 256, gen)
    for vd, ms in (("float32", (128, 256)), ("bfloat16", (128,))):
        op = build_operand(coo, PLUS_TIMES, "bsr_band", Geometry(8, 128, vd))
        abs_op = dataclasses.replace(op, strips=op.strips.abs())
        cols = column_spmvs(torch, coo, op, "bsr_band", PLUS_TIMES, x256, (0, 37, 77, 127),
                            bf16_values(torch, coo) if vd == "bfloat16" else coo)
        for m in ms:
            x = x256 if m == 256 else x256[:, :m].contiguous()
            run("spmm_band", f"band {vd} m={m}", op, "bsr_band", PLUS_TIMES, x, n,
                lambda x: spmm_band_plain(op, x, n_rows=n),
                lambda x: spmm_band_plain(abs_op, x, n_rows=n), cols)
            del x
        del op, abs_op
    del x256

    n = bcoo.shape[0]
    x128 = random_block(torch, PLUS_TIMES, n, 128, gen)
    xbool = random_block(torch, OR_AND, n, 128, gen)
    for sr, x, ms in ((PLUS_TIMES, x128, (8, 128)), (MIN_PLUS, x128, (128,)),
                      (OR_AND, xbool, (128,))):
        for variant in ("bsr_ell", "bsr_fused"):
            op = build_operand(bcoo, sr, variant)
            tile_op = op if variant == "bsr_ell" else ell_operand_from_fused(op)
            abs_op = tile_op._replace(tiles=tile_op.tiles.abs())
            cols = column_spmvs(torch, bcoo, op, variant, sr, x, (0, 3, 5, 7)
                                if sr is PLUS_TIMES else (0, 31, 64, 127), bcoo)
            for m in ms:
                xm = x if m == x.shape[1] else x[:, :m].contiguous()
                run("spmm_tiles", f"blocked {variant} {sr.name} m={m}", op, variant, sr, xm,
                    n, lambda x: fold_dp(spmm_bsr_ell_plain(tile_op, x, sr, n_rows=n), None,
                                         sr, None, None),
                    lambda x: spmm_bsr_ell_plain(abs_op, x, PLUS_TIMES, n_rows=n), cols)
            del op, tile_op, abs_op


def multi_source_full_width(torch, bcoo, out) -> None:
    """multi_sssp and multi_bfs with the default bsr_ell, and multi_sssp
    with variant="auto" (which must resolve bsr_fused), on the blocked
    matrix from SPMM_ROOTS seeded roots. Each launches spmm_tiles exactly
    once per step. Certificates: sssp x[root_j, j] = 0, x ≥ 0 and A⊗X = X
    off the roots, every column, with the chunked plain version; bfs
    levels of four columns equal bfs_levels_gold; four columns of each
    equal the port's single-source solve bit for bit."""
    from sparseharness_tpu_torch.algorithms import bfs, multi_bfs, multi_sssp, sssp
    from sparseharness_tpu_torch.gold import bfs_levels_gold
    from sparseharness_tpu_torch.ops import (
        LAUNCHES, build_operand, build_operand_auto, spmm_bsr_ell_plain,
    )
    from sparseharness_tpu_torch.ops.torch_ops import fold_dp
    from sparseharness_tpu_torch.semiring import MIN_PLUS

    n = bcoo.shape[0]
    roots = np.random.default_rng(23).choice(n, SPMM_ROOTS, replace=False)
    ridx = torch.as_tensor(roots, device="cuda")
    cidx = torch.arange(SPMM_ROOTS, device="cuda")
    picks = (0, 1, SPMM_ROOTS // 2, SPMM_ROOTS - 1)

    def run(app, **kw):
        before = LAUNCHES["spmm_tiles"]
        t0 = time.perf_counter()
        r = app(bcoo, roots, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = LAUNCHES["spmm_tiles"] - before
        if launched != r.iterations:
            raise AssertionError(f"{app.__name__}: {launched} spmm_tiles launches for "
                                 f"{r.iterations} steps")
        sr = "min_plus" if app is multi_sssp else "or_and"
        return r, dt, {f"blocked {sr} m={SPMM_ROOTS}": launched}

    t0 = time.perf_counter()
    ell_op = build_operand(bcoo, MIN_PLUS, "bsr_ell")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for variant in ("bsr_ell", "auto"):
        kw = {} if variant == "bsr_ell" else {"variant": "auto"}
        r, dt, launched = run(multi_sssp, **kw)
        ax = fold_dp(spmm_bsr_ell_plain(ell_op, r.x, MIN_PLUS, n_rows=n), None, MIN_PLUS,
                     None, None)
        off_root = torch.ones_like(r.x, dtype=torch.bool)
        off_root[ridx, cidx] = False
        cert = bool(r.converged and bool((r.x[ridx, cidx] == 0).all())
                    and bool((r.x >= 0).all()) and torch.equal(ax[off_root], r.x[off_root]))
        singles = all(torch.equal(r.x[:, j], sssp(bcoo, int(roots[j]), variant="bsr_ell").x)
                      for j in picks)
        resolved = "bsr_ell"
        if variant == "auto":
            resolved = build_operand_auto(bcoo, MIN_PLUS)[0]
        out.append({"app": "multi_sssp", "variant": f"{variant} -> {resolved}",
                    "roots": SPMM_ROOTS, "iterations": r.iterations, "converged": r.converged,
                    "seconds": dt, "bsr_ell_build_seconds": build_s,
                    "certificate": "x[root_j, j] == 0, x >= 0 and A⊗X == X off the roots "
                                   "(every column); 4 columns == sssp",
                    "certified": cert, "columns_equal_single_source": singles,
                    "reached": int((r.x < 3e38).sum()), "spmm_tiles_launches": launched})
        if not (cert and singles and resolved == ("bsr_ell" if variant == "bsr_ell"
                                                  else "bsr_fused")):
            raise AssertionError(f"multi_sssp ({variant} -> {resolved}) certificate failed")
        del r, ax, off_root

    r, dt, launched = run(multi_bfs)
    t0 = time.perf_counter()
    levels = all(np.array_equal(r.aux[:, j].cpu().numpy(), bfs_levels_gold(bcoo, int(roots[j])))
                 for j in picks)
    gold_s = time.perf_counter() - t0
    singles = all(torch.equal(r.aux[:, j], bfs(bcoo, int(roots[j]), variant="bsr_ell").aux)
                  for j in picks)
    cert = bool(r.converged and levels)
    out.append({"app": "multi_bfs", "variant": "bsr_ell", "roots": SPMM_ROOTS,
                "iterations": r.iterations, "converged": r.converged, "seconds": dt,
                "gold_seconds": gold_s,
                "certificate": "4 columns' levels == bfs_levels_gold and == bfs",
                "certified": cert, "columns_equal_single_source": singles,
                "spmm_tiles_launches": launched})
    if not (cert and singles):
        raise AssertionError("multi_bfs certificate failed")


def multi_source_routes(torch, rcoo, out) -> None:
    """The other routes of the multi-source apps: on banded_coo(1 << 16, 63,
    seed=1) with 8 roots and variant="bsr_band", min_plus and or_and take
    spmm_tiles through the band's explicit columns (one launch a step); on
    the ragged matrix multi_bfs with variant="auto" resolves sell2 and maps
    spmv over its 8 columns (8 sell2 launches a step); the band shuffled by
    a seeded permutation and solved with reorder="rcm" must resolve
    bsr_band after RCM and equal the unshuffled solve after un-permuting."""
    from sparseharness_tpu_torch.algorithms import apps, multi_bfs, multi_sssp
    from sparseharness_tpu_torch.formats import (
        banded_coo, bandwidth, permute_coo, rcm_permutation,
    )
    from sparseharness_tpu_torch.gold import bfs_levels_gold
    from sparseharness_tpu_torch.ops import (
        LAUNCHES, build_operand, build_operand_auto, ell_operand_from_band, spmm_bsr_ell_plain,
    )
    from sparseharness_tpu_torch.ops.torch_ops import fold_dp
    from sparseharness_tpu_torch.semiring import MIN_PLUS

    band = banded_coo(SPMM_BAND_N, BAND, seed=1)
    n = band.shape[0]
    roots = np.random.default_rng(29).choice(n, 8, replace=False)

    def run(kernel, per_step, app, coo, rts, **kw):
        before = LAUNCHES[kernel]
        t0 = time.perf_counter()
        r = app(coo, rts, **kw)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launched = LAUNCHES[kernel] - before
        if launched != per_step * r.iterations:
            raise AssertionError(f"{app.__name__}: {launched} {kernel} launches for "
                                 f"{r.iterations} steps")
        return r, dt, {f"band m={len(rts)}": launched} if kernel == "spmm_tiles" else {}

    r_sssp, dt, launched = run("spmm_tiles", 1, multi_sssp, band, roots, variant="bsr_band")
    op = ell_operand_from_band(build_operand(band, MIN_PLUS, "bsr_band"))
    ax = fold_dp(spmm_bsr_ell_plain(op, r_sssp.x, MIN_PLUS, n_rows=n), None, MIN_PLUS,
                 None, None)
    off_root = torch.ones_like(r_sssp.x, dtype=torch.bool)
    off_root[torch.as_tensor(roots, device="cuda"), torch.arange(8, device="cuda")] = False
    cert = bool(r_sssp.converged and torch.equal(ax[off_root], r_sssp.x[off_root]))
    out.append({"app": "multi_sssp", "matrix": f"banded{n}", "variant": "bsr_band",
                "roots": 8, "iterations": r_sssp.iterations, "seconds": dt,
                "certificate": "A⊗X == X off the roots", "certified": cert,
                "spmm_tiles_launches": launched})
    if not cert:
        raise AssertionError("band multi_sssp certificate failed")
    del op, ax, off_root

    r, dt, launched = run("spmm_tiles", 1, multi_bfs, band, roots, variant="bsr_band")
    # the band is complete, so a vertex is ceil(|i − root| / BAND) levels out
    dist = (torch.arange(n, device="cuda")[:, None]
            - torch.as_tensor(roots, device="cuda")[None, :]).abs()
    want = ((dist + BAND - 1) // BAND).to(torch.int32)
    cert = bool(r.converged and torch.equal(r.aux, want))
    out.append({"app": "multi_bfs", "matrix": f"banded{n}", "variant": "bsr_band",
                "roots": 8, "iterations": r.iterations, "seconds": dt,
                "certificate": f"levels == ceil(|i − root| / {BAND}), every column",
                "certified": cert, "spmm_tiles_launches": launched})
    if not cert:
        raise AssertionError("band multi_bfs certificate failed")

    rroots = np.random.default_rng(31).choice(rcoo.shape[0], 8, replace=False)
    r, dt, _ = run("sell2", 8, multi_bfs, rcoo, rroots, variant="auto")
    cert = bool(r.converged and all(np.array_equal(r.aux[:, j].cpu().numpy(),
                                                   bfs_levels_gold(rcoo, int(rroots[j])))
                                    for j in (0, 7)))
    out.append({"app": "multi_bfs", "matrix": f"zipf{rcoo.shape[0]}",
                "variant": "auto -> sell2 (column map)", "roots": 8,
                "iterations": r.iterations, "seconds": dt,
                "certificate": "8 sell2 launches a step; 2 columns' levels == bfs_levels_gold",
                "certified": cert})
    if not cert:
        raise AssertionError("ragged multi_bfs certificate failed")

    scramble = np.random.default_rng(37).permutation(n).astype(np.int32)
    shuffled = permute_coo(band, scramble)
    inv_scramble = np.argsort(scramble)
    # The solve's own RCM is the only one: it is timed and kept as it runs.
    seen = {}

    def watched_rcm(coo):
        t0 = time.perf_counter()
        seen["perm"] = rcm_permutation(coo)
        seen["seconds"] = time.perf_counter() - t0
        return seen["perm"]

    apps.rcm_permutation = watched_rcm
    before = LAUNCHES["spmm_tiles"]
    try:
        t0 = time.perf_counter()
        r = multi_sssp(shuffled, inv_scramble[roots], variant="auto", reorder="rcm")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        apps.rcm_permutation = rcm_permutation
    launched = LAUNCHES["spmm_tiles"] - before
    reordered = permute_coo(shuffled, seen["perm"])
    resolved = build_operand_auto(reordered, MIN_PLUS)[0]
    # shuffled vertex i is band vertex scramble[i]
    same = torch.equal(r.x, r_sssp.x[torch.as_tensor(scramble, device="cuda").long()])
    out.append({"app": "multi_sssp", "matrix": f"shuffled banded{n}",
                "variant": f"auto, reorder=rcm -> {resolved}", "roots": 8,
                "iterations": r.iterations, "seconds": dt, "rcm_seconds": seen["seconds"],
                "bandwidth_before": bandwidth(shuffled), "bandwidth_after": bandwidth(reordered),
                "certificate": "resolves bsr_band; x == the unshuffled band's x, un-permuted",
                "certified": bool(same and resolved == "bsr_band"),
                "spmm_tiles_launches": {"band m=8": launched}})
    if not (same and resolved == "bsr_band"):
        raise AssertionError(f"rcm multi_sssp: resolved {resolved}, equal {same}")


def spmm_kernel_times(torch, coo, bcoo) -> dict:
    """Both SpMM kernels at the full-width points, and spmm_tiles at the
    band-routed multi-source solves' own shape (the explicit columns of
    banded_coo(SPMM_BAND_N, BAND, seed=1) at m = 8, where most of its
    launches run): the median of five 20-call windows, the chunked plain
    version, torch.sparse.mm on a CSR tensor of the same matrix (cuSPARSE
    SpMM, plus_times in f32 only: no library call computes the other
    semirings) and the bound. The bound counts the strips (and tile_cols),
    X once and Y once, and 2 operations per nonzero per column: the strips'
    pad slots are bytes the kernel must read but no work the product
    needs. On the band's operand the strip bytes are each row's occupied
    span of values (spans.lanes, as the band SpMV's bound counts them): a
    pad's product is the ⊕ identity, or for plus_times comes from X alone;
    ``layout_bound_ms`` counts every strip slot. spmm_band's bound counts
    each row's span of values too. The operations are counted at the rate
    of the FP32 units (``ops_units``). The blocked points carry
    ``x_read_bytes``, the X bytes the kernel reads by its design (each tile
    slot's X block once a block-row), and that rate. Each spmm_tiles point is
    also held against the plain version on the inputs it is timed on (bit
    for bit, plus_times within PT_DELTA · max(1, |y|, Σ|a·x|)), its largest
    |Δ| in ``max_abs_err``."""
    from sparseharness_tpu_torch.formats import banded_coo
    from sparseharness_tpu_torch.harness import device_hbm_bandwidth
    from sparseharness_tpu_torch.ops import Geometry, bsr_band, build_operand, spmm_tiles
    from sparseharness_tpu_torch.semiring import MIN_PLUS, OR_AND, PLUS_TIMES

    bw = device_hbm_bandwidth(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(41)
    res = {}
    n = coo.shape[0]
    x256 = random_block(torch, PLUS_TIMES, n, 256, gen)
    csr = csr_of(torch, coo)
    for vd, m in (("float32", 128), ("float32", 256), ("bfloat16", 128)):
        op = build_operand(coo, PLUS_TIMES, "bsr_band", Geometry(8, 128, vd))
        x2d = bsr_band.pad_x_block(op, x256 if m == 256 else x256[:, :m].contiguous())
        rest = tensor_bytes(x2d) + op.strips.shape[0] * op.strips.shape[1] * m * 4
        entry = bound(op.spans.lanes * op.strips.element_size() + rest, 2 * coo.nnz * m, bw)
        layout = bound(tensor_bytes(op.strips) + rest, 2 * coo.nnz * m, bw)
        entry.update(layout_bytes=layout["bytes"], layout_bound_ms=layout["bound_ms"])
        args = dict(c0=op.c0, k_win=op.k_win)
        entry.update(time_windows(torch, lambda: bsr_band.band_spmm_cuda(
            op.strips, x2d, spans=op.spans, **args)))
        entry["plain_ms"] = time_ms(torch, lambda: bsr_band.band_spmm_plain(op.strips, x2d,
                                                                            **args), 2)
        if vd == "float32":
            entry["library_ms"] = time_ms(torch, lambda: torch.sparse.mm(csr, x2d[:n]), 10)
        res[f"band {vd} m={m}"] = entry
        del op, x2d
    del x256, csr

    def tiles_point(label, op, x2d, sr, entry, csr, n) -> None:
        """Time spmm_tiles at one point and hold it against the plain
        version on the same inputs."""
        def kernel():
            return spmm_tiles.spmm_tiles_cuda(op.tiles, op.tile_cols, x2d, sr)

        ref = spmm_tiles.spmm_tiles_plain(op.tiles, op.tile_cols, x2d, sr)
        sum_abs = (spmm_tiles.spmm_tiles_plain(op.tiles.abs(), op.tile_cols, x2d.abs(),
                                               PLUS_TIMES) if sr is PLUS_TIMES else None)
        entry["max_abs_err"] = check_kernel(torch, f"spmm_tiles {label}", kernel(), ref, sum_abs)
        del ref, sum_abs
        entry.update(time_windows(torch, kernel))
        entry["plain_ms"] = time_ms(torch, lambda: spmm_tiles.spmm_tiles_plain(
            op.tiles, op.tile_cols, x2d, sr), 2)
        entry["library_ms"] = (time_ms(torch, lambda: torch.sparse.mm(csr, x2d[:n]), 10)
                               if sr is PLUS_TIMES else None)
        res[label] = entry

    n = bcoo.shape[0]
    x128 = random_block(torch, PLUS_TIMES, n, 128, gen)
    csr = csr_of(torch, bcoo)
    for sr, m in ((PLUS_TIMES, 128), (PLUS_TIMES, 8), (MIN_PLUS, 128)):
        op = build_operand(bcoo, sr, "bsr_ell")
        bn = op.tiles.shape[2] // op.tile_cols.shape[1]
        x2d = spmm_tiles.pad_x_block(x128 if m == 128 else x128[:, :m].contiguous(), bn, sr)
        out_bytes = op.tiles.shape[0] * op.tiles.shape[1] * m * 4
        label = f"blocked {sr.name} m={m}"
        tiles_point(label, op, x2d, sr, bound(tensor_bytes(op.tiles, op.tile_cols, x2d)
                                              + out_bytes, 2 * bcoo.nnz * m, bw), csr, n)
        # X as the kernel reads it: each tile slot's (bn, m) block once for
        # its block-row (bm = 8: the row map's 8-row group, the tile map's
        # block), through L2
        x_read = op.tile_cols.numel() * bn * m * 4
        res[label].update(x_read_bytes=x_read, x_read_GBps=x_read / res[label]["ms"] / 1e6)
        del op, x2d
    del csr, x128

    band = banded_coo(SPMM_BAND_N, BAND, seed=1)
    n = band.shape[0]
    csr = csr_of(torch, band)
    for sr in (MIN_PLUS, OR_AND, PLUS_TIMES):
        bop = build_operand(band, sr, "bsr_band")
        op = spmm_tiles.ell_operand_from_band(bop)
        bn = op.tiles.shape[2] // op.tile_cols.shape[1]
        x2d = spmm_tiles.pad_x_block(random_block(torch, sr, n, 8, gen), bn, sr)
        rest = tensor_bytes(op.tile_cols, x2d) + op.tiles.shape[0] * op.tiles.shape[1] * 8 * 4
        entry = bound(bop.spans.lanes * op.tiles.element_size() + rest, 2 * band.nnz * 8, bw)
        layout = bound(tensor_bytes(op.tiles) + rest, 2 * band.nnz * 8, bw)
        entry.update(layout_bytes=layout["bytes"], layout_bound_ms=layout["bound_ms"])
        tiles_point(f"band {sr.name} m=8", op, x2d, sr, entry, csr, n)
        del bop, op, x2d
    return res


# -------------------------------------------------------------------- dia

STENCIL_GRID = 104  # HPCG's shipped local grid (hpcg.dat): 1,124,864 rows, 29,791,000 nnz
STENCIL_WIDE = 160  # a grid whose 442 MB of diagonals are 8.8 times the H100's 50 MB L2


def dia_vs_plain(torch, coo, errs) -> int:
    """The dia kernel against its plain version on the same CUDA tensors,
    each operand built through ``auto``, which must resolve dia: all seven
    semirings, f32 values and, for the float semirings, bf16; the dp, and
    the dp with the kernel's fold against ``fold_dp`` over the plain dp;
    bit for bit, plus_times within PT_DELTA · max(1, |plain|, Σ|a·x|). The
    worst plus_times error goes into ``errs``; returns the comparisons."""
    from sparseharness_tpu_torch.ops import Geometry, build_operand_auto, dia
    from sparseharness_tpu_torch.ops.torch_ops import fold_dp
    from sparseharness_tpu_torch.semiring import PLUS_TIMES, get_semiring

    rng = np.random.default_rng(17)
    n = coo.shape[0]
    checked = 0
    for name in SEMIRINGS:
        sr = get_semiring(name)
        x = random_x(torch, sr, n, rng)
        for vd in (("float32", "bfloat16") if sr.dtype == torch.float32 else ("float32",)):
            route, op = build_operand_auto(coo, sr, Geometry(value_dtype=vd), device="cuda")
            if route != "dia":
                raise AssertionError(f"auto resolved {route}, not dia, for {name}/{vd}")
            bound = None
            if name == "plus_times":
                bound = dia.dp_dia_plain(dia.DiaOperand(op.vals.abs(), op.offsets), x.abs(),
                                         PLUS_TIMES, n_rows=n)
            plain = dia.dp_dia_plain(op, x, sr, n_rows=n)
            for fold, want in ((False, plain), (True, fold_dp(plain, None, sr, None, None))):
                err = check_kernel(torch, f"dia {name}/{vd} fold={fold}",
                                   dia.dia_dp_cuda(op, x, sr, n_rows=n, fold=fold), want, bound)
                if bound is not None:
                    errs["dia"] = max(errs["dia"], err)
                checked += 1
            del op, bound, plain
    return checked


def dia_main_path(torch, coo, out) -> dict:
    """HPCG's stencil through make_spmv_problem with variant="auto", which
    must resolve dia, and benchmark_spmv, gold-gated in f32 and bf16; then
    ten ``spmv`` calls, which must launch dia once each and nothing else.
    Returns those ten calls' launches."""
    from sparseharness_tpu_torch.algorithms import make_spmv_problem
    from sparseharness_tpu_torch.gold import Correctness, spmv_abs_bound, spmv_gold
    from sparseharness_tpu_torch.harness import (
        BenchmarkConfig, benchmark_spmv, device_hbm_bandwidth, variant_bytes,
    )
    from sparseharness_tpu_torch.ops import LAUNCHES, Geometry, spmv
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    bw = device_hbm_bandwidth(torch.cuda.get_device_name(0))
    config = BenchmarkConfig(trials=5, launches_per_trial=20)
    for vd in ("float32", "bfloat16"):
        geom = Geometry(value_dtype=vd)
        t0 = time.perf_counter()
        prob = make_spmv_problem(coo, PLUS_TIMES, "auto", geom, seed=4)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        if prob.variant != "dia":
            raise AssertionError(f"auto resolved {prob.variant}, not dia, for the stencil")
        gold_coo = coo
        if vd == "bfloat16":
            vals = torch.from_numpy(coo.vals).to(torch.bfloat16).float().numpy()
            gold_coo = coo.with_values(vals)
        x_np = prob.x0.cpu().numpy()
        gold = spmv_gold(gold_coo, x_np, prob.y.cpu().numpy(), PLUS_TIMES)
        res = benchmark_spmv(prob, gold=gold, config=config, geometry=geom,
                             matrix_name=f"stencil27_{STENCIL_GRID}", nnz=coo.nnz,
                             gold_scale=spmv_abs_bound(gold_coo, x_np))
        if res.correctness is not Correctness.CORRECT:
            raise AssertionError(f"dia@{geom}: {res.correctness}")
        n_bytes = variant_bytes("dia", prob.operand, prob.x0.numel() * 4, coo.shape[0] * 4)
        out.append({
            "variant": prob.variant, "geometry": str(geom), "correctness": res.correctness.value,
            "build_seconds": build_s, "median_ms": res.median_ns * 1e-6,
            "best_ms": res.best_ns * 1e-6, "gnnz_per_s": res.gnnz_per_s,
            "bytes_per_s": n_bytes / (res.median_ns * 1e-9), "bound_ms": n_bytes / bw * 1e3,
            "roofline_frac": res.roofline_frac,
        })
        if vd == "float32":
            before = dict(LAUNCHES)
            for _ in range(10):
                spmv(prob.operand, prob.x0, sr=PLUS_TIMES, variant="dia", n_rows=coo.shape[0])
            torch.cuda.synchronize()
            ten = {k: v - before[k] for k, v in LAUNCHES.items() if v != before[k]}
            if ten != {"dia": 10}:
                raise AssertionError(f"ten spmv calls launched {ten}, not dia 10 times")
        del prob
    return ten


def dia_kernel_times(torch, coo, value_dtypes=("float32", "bfloat16")) -> dict:
    """The dia kernel at a stencil's shape, for each value type: the median
    of five 50-call windows of CUDA events (the host enqueues a launch
    faster than the kernel runs, so they time the kernel) and the host's
    enqueue a call, a whole ``spmv`` call (the kernel, which folds) the same way,
    and the plain version; torch.mv on a CSR tensor of
    the same matrix as the library yardstick. The bound counts the (D, n)
    value slots, x and the output once each, the operations one ⊗ and one
    ⊕ a slot; ``matrix_bound_ms`` counts the matrix's entries in place of
    the slots (off-matrix slots and the 0̄ of missing neighbours are not
    work), as the benchmark's ``kernel_roofline.spmv`` does."""
    from sparseharness_tpu_torch.harness import device_hbm_bandwidth
    from sparseharness_tpu_torch.ops import Geometry, build_operand_auto, dia, spmv
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    bw = device_hbm_bandwidth(torch.cuda.get_device_name(0))
    n = coo.shape[0]
    x = random_x(torch, PLUS_TIMES, n, np.random.default_rng(19))
    res = {"rows": n, "nnz": coo.nnz, "matrix_bound_ms": (coo.nnz + 2 * n) * 4 / bw * 1e3}
    for vd in value_dtypes:
        t0 = time.perf_counter()
        route, op = build_operand_auto(coo, PLUS_TIMES, Geometry(value_dtype=vd), device="cuda")
        torch.cuda.synchronize()
        if route != "dia":
            raise AssertionError(f"auto resolved {route}, not dia, for {vd}")
        kernel = lambda: dia.dia_dp_cuda(op, x, PLUS_TIMES, n_rows=n)  # noqa: E731
        entry = bound(tensor_bytes(op.vals, x) + n * 4, 2 * op.vals.numel(), bw)
        entry.update(build_seconds=time.perf_counter() - t0, diagonals=len(op.offsets),
                     **time_windows(torch, kernel, n=50))
        entry["call"] = time_windows(torch, lambda: spmv(op, x, sr=PLUS_TIMES, variant="dia",
                                                         n_rows=n), n=50)
        entry["plain_ms"] = time_ms(torch, lambda: dia.dp_dia_plain(op, x, PLUS_TIMES,
                                                                    n_rows=n), 5)
        res[vd] = entry
        del op
    csr = csr_of(torch, coo)
    res["library_ms"] = time_ms(torch, lambda: torch.mv(csr, x), 20)
    del csr
    return res


def ragged_phases(torch, card: str, smi: str, rcoo):
    """Phases 10–12 (the sell2 kernel's, at the ragged shape ``rcoo``);
    returns the main path's sell2 launches, the kernel's largest plus_times
    error and its times."""
    from sparseharness_tpu_torch.ops import LAUNCHES

    rerrs = {"sell2": 0.0}
    with Phase("sell2_kernel_vs_plain_small") as f:
        f["comparisons"] = sum(sell2_vs_plain(torch, m, all_cases(torch), rerrs)
                               for m in ragged_cases(torch))
    with Phase("sell2_kernel_vs_plain_full") as f:
        f["comparisons"] = sell2_vs_plain(
            torch, rcoo, [("plus_times", "float32"), ("plus_times", "bfloat16"),
                          ("min_plus", "float32"), ("or_and", "float32")], rerrs)
        f.update(rows=rcoo.shape[0], nnz=rcoo.nnz, max_abs_err=rerrs)

    for key in LAUNCHES:
        LAUNCHES[key] = 0
    rspmv_lines, rapp_lines = [], []
    with Phase("main_path_ragged_spmv") as f:
        ragged_main_path(torch, rcoo, rspmv_lines)
        f.update(card=card, nvidia_smi=smi, runs=rspmv_lines)
    with Phase("main_path_ragged_fixpoints") as f:
        ragged_fixpoints(torch, rcoo, rapp_lines)
        f.update(card=card, nvidia_smi=smi, runs=rapp_lines)
    rlaunches = dict(LAUNCHES)
    emit({"phase": "main_path_ragged_launches", "launches": rlaunches})
    if rlaunches["sell2"] <= 0:
        raise AssertionError("the sell2 kernel never launched on the ragged main path")

    with Phase("ragged_kernel_times") as f:
        rtimes = ragged_kernel_times(torch, rcoo)
        if any("sell2_x" in k for vd in ("float32", "bfloat16") for k in rtimes[vd]["stages"]):
            raise AssertionError("the ragged shape's call copied x")
        f.update(card=card, nvidia_smi=smi, times=rtimes)
    with Phase("kron_kernel_times") as f:
        kerrs = {"sell2": 0.0}
        rtimes["kron20"] = kron_kernel_times(torch, kerrs)
        f.update(card=card, nvidia_smi=smi, times=rtimes["kron20"])
    return rlaunches["sell2"], rerrs, rtimes


def dia_phases(torch, card: str, smi: str) -> dict:
    """Phases 28–30 (the stencil's); returns the dia kernel's entry of the
    kernels line."""
    from sparseharness_tpu_torch.formats import stencil27_coo
    from sparseharness_tpu_torch.ops import LAUNCHES

    stencil = stencil27_coo(STENCIL_GRID, STENCIL_GRID, STENCIL_GRID, seed=11)
    derrs = {"dia": 0.0}
    with Phase("dia_kernel_vs_plain") as f:
        f.update(rows=stencil.shape[0], nnz=stencil.nnz,
                 comparisons=dia_vs_plain(torch, stencil, derrs), max_abs_err=derrs)
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    dia_lines = []
    with Phase("main_path_dia_spmv") as f:
        ten = dia_main_path(torch, stencil, dia_lines)
        f.update(card=card, nvidia_smi=smi, runs=dia_lines, ten_calls=ten)
    dlaunches = {k: v for k, v in LAUNCHES.items() if v}
    emit({"phase": "main_path_dia_launches", "launches": dlaunches})
    if list(dlaunches) != ["dia"]:
        raise AssertionError(f"the stencil's main path launched {dlaunches}, not dia alone")
    with Phase("dia_kernel_times") as f:
        dtimes = dia_kernel_times(torch, stencil)
        del stencil
        wide = stencil27_coo(STENCIL_WIDE, STENCIL_WIDE, STENCIL_WIDE, seed=12)
        dtimes[f"grid {STENCIL_WIDE}"] = dia_kernel_times(torch, wide, ("float32",))
        del wide
        f.update(card=card, nvidia_smi=smi, times=dtimes)

    # the dia kernel at HPCG's grid, and beside it a grid whose diagonals
    # are 8.8 times the L2, so that they stream from HBM
    t, w = dtimes["float32"], dtimes[f"grid {STENCIL_WIDE}"]
    return {
        "name": "dia", "route": "cuda", "source": "sparseharness_tpu_torch/ops/csrc/dia.cu",
        "replaces": "none: sparseharness_tpu/ops/dia.py:72 is plain XLA",
        "launches": dlaunches["dia"], "max_abs_err": derrs["dia"], "ms": t["ms"],
        "enqueue_ms": t["enqueue_ms"], "bf16_ms": dtimes["bfloat16"]["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "matrix_bound_ms": dtimes["matrix_bound_ms"], "library_ms": dtimes["library_ms"],
        "points": {f"grid {STENCIL_WIDE}": {
            "ms": w["float32"]["ms"], "bound_ms": w["float32"]["bound_ms"],
            "matrix_bound_ms": w["matrix_bound_ms"], "plain_ms": w["float32"]["plain_ms"],
            "library_ms": w["library_ms"]}},
    }


# ---------------------------------------------------------------- sharded

SHARDED_ROOTS = 8        # the tiles mode's sources: spmm_tiles at m = 8
STREAMED_STEPS = 50      # the streamed band path's capped fixpoint
BUSY_STEPS = 300         # the profiled window of the band sssp, in steps
SHARDED_SEMIRINGS = ("min_plus", "or_and", "plus_times")
CLI_BAND_N = 1 << 12     # the sharded CLI's band


def _sharded_x(name: str, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if name == "or_and":
        return rng.random(n) < 0.3
    return rng.uniform(0.1, 1.0, n).astype(np.float32)


def _check_sharded_dp(label, got, ref, name, bound) -> float:
    """min_plus and or_and bit for bit; plus_times within PT_DELTA ·
    max(1, |ref|, Σ|a·x|). Returns the largest difference."""
    got, ref = got.cpu().numpy(), ref.cpu().numpy()
    if got.shape != ref.shape or got.dtype != ref.dtype:
        raise AssertionError(f"{label}: {got.shape} {got.dtype} against {ref.shape} {ref.dtype}")
    if name != "plus_times":
        if got.tobytes() != ref.tobytes():
            raise AssertionError(f"{label}: {int((got != ref).sum())} rows differ")
        return 0.0
    err = np.abs(got - ref)
    if not np.all(err <= PT_DELTA * np.maximum(np.maximum(1.0, np.abs(ref)), bound)):
        raise AssertionError(f"{label}: plus_times off by up to {float(err.max())}")
    return float(err.max())


def _check_sharded_fix(label, got, ref, app) -> dict:
    """x bit for bit (pagerank within 1e-6), iterations, converged and the
    BFS levels as the single-device solve's."""
    if (got.iterations, got.converged) != (ref.iterations, ref.converged):
        raise AssertionError(f"{label}: {got.iterations} steps, converged {got.converged}, "
                             f"against {ref.iterations}, {ref.converged}")
    gx, rx = got.x.cpu().numpy(), ref.x.cpu().numpy()
    if app == "pagerank":
        if not np.abs(gx - rx).max() <= 1e-6:
            raise AssertionError(f"{label}: pagerank off by {float(np.abs(gx - rx).max())}")
    elif gx.tobytes() != rx.tobytes():
        raise AssertionError(f"{label}: {int((gx != rx).sum())} entries differ")
    if ref.aux is not None and got.aux.cpu().numpy().tobytes() != ref.aux.cpu().numpy().tobytes():
        raise AssertionError(f"{label}: the levels differ")
    return {"steps": got.iterations, "converged": got.converged}


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _busy_ms_per_step(torch, device, solve, steps: int):
    """The device's busy ms a step over a solve of ``steps`` steps, from
    torch.profiler (every kernel and copy it records); None off a card."""
    if device.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile

    _sync(torch, device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        solve()
        _sync(torch, device)
    busy = sum(getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
               for e in prof.key_averages())
    return busy / 1e3 / steps


def _timed(torch, device, fn):
    _sync(torch, device)
    t0 = time.perf_counter()
    res = fn()
    _sync(torch, device)
    return res, time.perf_counter() - t0


def _sharded_world1_rank(mesh, backend: str) -> dict:
    """One NCCL rank on cuda:0 (a world of one, started by run_world): every
    sharded mode at full width against the single-device port, the launch
    counts of the sharded path alone, the band sssp's step costs, and the
    1 << 16 band's answers for the two-rank phase."""
    import torch

    from sparseharness_tpu_torch import algorithms as apps
    from sparseharness_tpu_torch.formats import banded_coo, block_random_coo, power_law_coo
    from sparseharness_tpu_torch.gold import spmv_abs_bound
    from sparseharness_tpu_torch.ops import LAUNCHES, build_operand, spmv
    from sparseharness_tpu_torch.parallel import auto_sharded_spmv, frontier, sharded
    from sparseharness_tpu_torch.parallel import sharded_band, sharded_sell
    from sparseharness_tpu_torch.semiring import MIN_PLUS, PLUS_TIMES, get_semiring

    dev = mesh.device
    if (mesh.size, mesh.backend) != (1, backend):
        raise AssertionError(f"expected one {backend} rank, got {mesh}")
    out = {"mesh": {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
                    "device": str(dev)}}
    t0 = time.perf_counter()
    band = banded_coo(FULL_N, BAND, seed=1)
    rcoo = power_law_coo(RAGGED_N, RAGGED_NNZ, alpha=1.5, seed=RAGGED_SEED)
    bcoo = block_random_coo(BLOCK_N, 2, bm=8, bn=128, seed=BLOCK_SEED)
    band16 = banded_coo(SELL_BAND_N, BAND, seed=1)
    roots = np.random.default_rng(29).choice(BLOCK_N, SHARDED_ROOTS, replace=False)
    root = FULL_N // 2  # the band's solves spread both ways: half the steps
    xs = {(m, name): _sharded_x(name, coo.shape[1], seed)
          for m, coo, seed in (("band", band, 3), ("ragged", rcoo, 4), ("band16", band16, 5))
          for name in SHARDED_SEMIRINGS}
    bounds = {m: spmv_abs_bound(coo, xs[(m, "plus_times")])
              for m, coo in (("band", band), ("ragged", rcoo), ("band16", band16))}
    out["data_seconds"] = time.perf_counter() - t0

    # ---- the single-device port, before the counted run
    t0 = time.perf_counter()
    ref_dp = {}
    for m, coo, variant in (("band", band, "bsr_band"), ("ragged", rcoo, "sell2"),
                            ("band16", band16, "bsr_band")):
        for name in SHARDED_SEMIRINGS:
            sr = get_semiring(name)
            op = build_operand(coo, sr, variant, device=dev)
            ref_dp[(m, name)] = spmv(op, torch.from_numpy(xs[(m, name)]).to(dev), sr=sr,
                                     variant=variant, n_rows=coo.shape[0])
            del op
    ref = {
        ("band", "sssp"): _timed(torch, dev, lambda: apps.sssp(band, root, variant="bsr_band",
                                                          device=dev)),
        ("band", "bfs"): _timed(torch, dev, lambda: apps.bfs(band, root, variant="bsr_band",
                                                        device=dev)),
        ("band", "pagerank"): _timed(torch, dev, lambda: apps.pagerank(band, variant="bsr_band",
                                                                  device=dev)),
        ("ragged", "sssp"): _timed(torch, dev, lambda: apps.sssp(rcoo, 0, variant="sell2",
                                                            device=dev)),
        ("ragged", "bfs"): _timed(torch, dev, lambda: apps.bfs(rcoo, 0, variant="sell2",
                                                          device=dev)),
        ("ragged", "pagerank"): _timed(torch, dev, lambda: apps.pagerank(rcoo, variant="sell2",
                                                                    device=dev)),
        ("blocked", "multi_sssp"): _timed(torch, dev, lambda: apps.multi_sssp(
            bcoo, roots, variant="bsr_ell", device=dev)),
        ("blocked", "multi_bfs"): _timed(torch, dev, lambda: apps.multi_bfs(
            bcoo, roots, variant="bsr_ell", device=dev)),
        ("band16", "sssp"): _timed(torch, dev, lambda: apps.sssp(band16, 0, variant="bsr_band",
                                                            device=dev)),
        ("band16", "bfs"): _timed(torch, dev, lambda: apps.bfs(band16, 0, variant="bsr_band",
                                                          device=dev)),
        ("band_capped", "sssp"): _timed(torch, dev, lambda: apps.sssp(
            band, root, variant="bsr_band", max_iter=STREAMED_STEPS, device=dev)),
    }
    ref = {k: v[0] for k, v in ref.items()}
    out["reference_seconds"] = time.perf_counter() - t0

    # ---- the sharded path, counted
    spmv_of = {"ShardedBandOperand": sharded_band.sharded_spmv_band,
               "HaloEll": sharded.sharded_spmv_halo, "ShardedEll": sharded.sharded_spmv}
    solves = {"sssp": lambda coo, r, **kw: sharded.sharded_sssp(coo, r, mesh=mesh, **kw),
              "bfs": lambda coo, r, **kw: sharded.sharded_bfs(coo, r, mesh=mesh, **kw),
              "pagerank": lambda coo, r, **kw: sharded.sharded_pagerank(coo, mesh=mesh, **kw)}
    errs, runs = {}, []
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    t_path = time.perf_counter()
    for mode in ("gather", "halo", "band", "auto"):
        for name in SHARDED_SEMIRINGS:
            sr = get_semiring(name)
            op = sharded._build_sharded_auto(band, sr, 1, mode, device=dev)[0]
            if mode == "auto" and type(op).__name__ != "ShardedBandOperand":
                raise AssertionError(f"auto resolved {type(op).__name__} on the band")
            got = spmv_of[type(op).__name__](mesh, op, xs[("band", name)], sr, FULL_N)
            errs[f"{mode} {name}"] = _check_sharded_dp(
                f"{mode} spmv {name}", got, ref_dp[("band", name)], name, bounds["band"])
            del op, got
        for app in ("sssp", "bfs", "pagerank"):
            res, secs = _timed(torch, dev, lambda: solves[app](band, root, mode=mode))
            runs.append({"matrix": "band", "mode": mode, "app": app, "seconds": secs,
                         **_check_sharded_fix(f"{mode} {app}", res, ref[("band", app)], app)})
            del res
    # the streamed band path, forced: one SpMV and a capped fixpoint
    op = dataclasses.replace(
        sharded_band.build_sharded_band(band, MIN_PLUS, 1, device=dev)[0], windowed=True)
    errs["band streamed min_plus"] = _check_sharded_dp(
        "streamed spmv", sharded_band.sharded_spmv_band(mesh, op, xs[("band", "min_plus")],
                                                        MIN_PLUS, FULL_N),
        ref_dp[("band", "min_plus")], "min_plus", None)
    x0 = np.full(FULL_N, np.finfo(np.float32).max, np.float32)
    x0[root] = 0.0
    res = sharded_band.sharded_fixpoint_band(mesh, op, x0, MIN_PLUS, n_rows=FULL_N,
                                             combine=sharded.combine_min,
                                             max_iter=STREAMED_STEPS)
    runs.append({"matrix": "band", "mode": "band streamed", "app": "sssp capped",
                 **_check_sharded_fix("streamed sssp", res, ref[("band_capped", "sssp")],
                                      "sssp")})
    del op, res
    # auto_sharded_spmv: the ELL rows as a Shard(0) DTensor, on the 1 << 16
    # band (the ELL build sorts on the host)
    errs["auto_sharded_spmv plus_times"] = _check_sharded_dp(
        "auto_sharded_spmv", auto_sharded_spmv(mesh, band16, PLUS_TIMES,
                                               xs[("band16", "plus_times")]),
        ref_dp[("band16", "plus_times")], "plus_times", bounds["band16"])
    # sell mode and the frontier on the ragged matrix
    for name in SHARDED_SEMIRINGS:
        sr = get_semiring(name)
        op = sharded_sell.build_sharded_sell(rcoo, sr, 1, device=dev)[0]
        errs[f"sell {name}"] = _check_sharded_dp(
            f"sell spmv {name}", sharded_sell.sharded_spmv_sell(
                mesh, op, xs[("ragged", name)], sr, RAGGED_N),
            ref_dp[("ragged", name)], name, bounds["ragged"])
        del op
    for app in ("sssp", "bfs", "pagerank"):
        res, secs = _timed(torch, dev, lambda: solves[app](rcoo, 0, mode="sell"))
        runs.append({"matrix": "ragged", "mode": "sell", "app": app, "seconds": secs,
                     **_check_sharded_fix(f"sell {app}", res, ref[("ragged", app)], app)})
    for app, fn in (("sssp", frontier.frontier_sssp), ("bfs", frontier.frontier_bfs)):
        res, secs = _timed(torch, dev, lambda: fn(rcoo, 0, mesh=mesh))
        if res.local != "sell":
            raise AssertionError(f"frontier {app} ran {res.local}, not sell")
        runs.append({"matrix": "ragged", "mode": "frontier", "app": app, "seconds": secs,
                     "sent_entries": res.sent_entries, "dense_phase_iters": res.dense_phase_iters,
                     "dense_fallbacks": res.dense_fallbacks,
                     **_check_sharded_fix(f"frontier {app}", res, ref[("ragged", app)], app)})
    # tiles mode: spmm_tiles at m = 8 on the blocked matrix
    for app, fn in (("multi_sssp", sharded.sharded_multi_sssp),
                    ("multi_bfs", sharded.sharded_multi_bfs)):
        res, secs = _timed(torch, dev, lambda: fn(bcoo, roots, mesh=mesh, mode="tiles"))
        runs.append({"matrix": "blocked", "mode": "tiles", "app": app, "seconds": secs,
                     **_check_sharded_fix(f"tiles {app}", res, ref[("blocked", app)], app)})
    # the 1 << 16 band's answers, which the two-rank phase is held against
    band16_out = {}
    for app, fn in (("sssp", lambda: sharded.sharded_sssp(band16, 0, mesh=mesh, mode="band")),
                    ("frontier_bfs", lambda: frontier.frontier_bfs(band16, 0, mesh=mesh,
                                                                   budget=512)),
                    ("frontier_sssp", lambda: frontier.frontier_sssp(band16, 0, mesh=mesh,
                                                                     budget=512))):
        res = fn()
        base = "bfs" if app == "frontier_bfs" else "sssp"
        _check_sharded_fix(f"band16 {app}", res, ref[("band16", base)], base)
        band16_out[app] = {"x": res.x.cpu().numpy(), "iterations": res.iterations,
                           "converged": res.converged,
                           "aux": None if res.aux is None else res.aux.cpu().numpy()}
    out["launches"] = dict(LAUNCHES)
    out["sharded_path_seconds"] = time.perf_counter() - t_path
    out.update(runs=runs, max_abs_err=errs, band16=band16_out)

    # ---- the band sssp's step costs: sharded band mode against one card
    # the operands are built before the clocks start (return_solver)
    steps = {}
    for label, solve, capped in (
            ("single_device",
             apps.sssp(band, root, variant="bsr_band", device=dev, return_solver=True),
             apps.sssp(band, root, variant="bsr_band", max_iter=BUSY_STEPS, device=dev,
                       return_solver=True)),
            ("sharded_band",
             sharded.sharded_sssp(band, root, mesh=mesh, mode="band", return_solver=True),
             sharded.sharded_sssp(band, root, mesh=mesh, mode="band", max_iter=BUSY_STEPS,
                                  return_solver=True))):
        capped()  # the sharded solver places its shard on its first run
        res, secs = _timed(torch, dev, solve)
        host = secs * 1e3 / res.iterations
        busy = _busy_ms_per_step(torch, dev, capped, BUSY_STEPS)
        steps[label] = {"steps": res.iterations, "seconds": secs, "host_ms_per_step": host,
                        "device_busy_ms_per_step": busy,
                        "device_idle_share": None if busy is None else 1 - busy / host}
    out["band_sssp_steps"] = steps
    return out


def _sharded_ranks2_rank(mesh, host_copy: bool) -> dict:
    """One of two gloo ranks sharing cuda:0: the band mode and the frontier
    on the 1 << 16 band, every exchange copied through the host."""
    import torch

    from sparseharness_tpu_torch.formats import banded_coo
    from sparseharness_tpu_torch.ops import LAUNCHES
    from sparseharness_tpu_torch.parallel import frontier, sharded

    if (mesh.size, mesh.backend, mesh.host_copy) != (2, "gloo", host_copy):
        raise AssertionError(f"expected two gloo ranks (host copy {host_copy}), got {mesh}")
    band16 = banded_coo(SELL_BAND_N, BAND, seed=1)
    for key in LAUNCHES:
        LAUNCHES[key] = 0
    out = {"mesh": {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
                    "device": str(mesh.device), "host_copy": mesh.host_copy}}
    for app, fn in (("sssp", lambda: sharded.sharded_sssp(band16, 0, mesh=mesh, mode="band")),
                    ("frontier_bfs", lambda: frontier.frontier_bfs(band16, 0, mesh=mesh,
                                                                   budget=512)),
                    ("frontier_sssp", lambda: frontier.frontier_sssp(band16, 0, mesh=mesh,
                                                                     budget=512))):
        res, secs = _timed(torch, mesh.device, fn)
        out[app] = {"x": res.x.cpu().numpy(), "iterations": res.iterations,
                    "converged": res.converged, "seconds": secs,
                    "aux": None if res.aux is None else res.aux.cpu().numpy()}
        if app != "sssp":
            out[app].update(sent_entries=res.sent_entries, local=res.local,
                            dense_phase_iters=res.dense_phase_iters)
    out["launches"] = dict(LAUNCHES)
    return out


def sharded_world1(torch, device: str = "cuda") -> dict:
    """Phase sharded_world1: the rank's checks raise in the rank, which
    fails the world and with it this phase."""
    from sparseharness_tpu_torch.parallel import mesh as mesh_mod, run_world

    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    backend = mesh_mod.default_backend(torch.device(device))
    out = run_world(_sharded_world1_rank, 1, device=device, timeout_s=900,
                    args=(backend,))[0]
    out["world_seconds"] = time.perf_counter() - t0
    for kernel in ("staged", "streamed", "sell2", "spmm_tiles"):
        if device == "cuda" and out["launches"][kernel] <= 0:
            raise AssertionError(f"the {kernel} kernel never launched on the sharded path")
    return out


def sharded_ranks2_one_card(torch, world1: dict, device: str = "cuda") -> dict:
    from sparseharness_tpu_torch.parallel import run_world

    t0 = time.perf_counter()
    ranks = run_world(_sharded_ranks2_rank, 2, backend="gloo", device=device, timeout_s=600,
                      args=(device == "cuda",))
    seconds = time.perf_counter() - t0
    for r in ranks:
        for app, want in world1["band16"].items():
            got = r[app]
            if (got["iterations"], got["converged"]) != (want["iterations"], want["converged"]):
                raise AssertionError(f"two ranks {app}: {got['iterations']} steps against "
                                     f"{want['iterations']}")
            if got["x"].tobytes() != want["x"].tobytes():
                raise AssertionError(f"two ranks {app}: x differs from world 1's")
            if want["aux"] is not None and got["aux"].tobytes() != want["aux"].tobytes():
                raise AssertionError(f"two ranks {app}: levels differ from world 1's")
    if device == "cuda" and (ranks[0]["launches"]["staged"] <= 0
                             or ranks[0]["launches"]["sell2"] <= 0):
        raise AssertionError(f"two ranks: launches {ranks[0]['launches']}")
    summary = {app: {k: v for k, v in ranks[0][app].items() if k not in ("x", "aux")}
               for app in world1["band16"]}
    return {"world_seconds": seconds, "mesh": [r["mesh"] for r in ranks],
            "exchange": ("gloo, every exchanged buffer copied through the host (the "
                         "backend's rule for ranks on a card)" if ranks[0]["mesh"]["host_copy"]
                         else "gloo"),
            "runs": summary, "launches": [r["launches"] for r in ranks]}


def weak_scaling_phase(torch, device: str = "cuda") -> dict:
    from sparseharness_tpu_torch.harness.scaling import report, weak_scaling_spmv

    pts = weak_scaling_spmv(base_rows=FULL_N, avg_degree=2 * BAND, device_counts=[1],
                            kernel="band", inner_iters=50, device=device, timeout_s=600)
    if any(p.efficiency is not None for p in pts):
        raise AssertionError("one card: the report must give no efficiency")
    return {"points": [dataclasses.asdict(p) for p in pts],
            "ms_per_op": [p.seconds_per_op * 1e3 for p in pts], "report": report(pts)}


def sharded_cli(torch, d: str, device: str = "cuda") -> dict:
    """spmv and sssp --mesh 1 --sharded-mode band (JAX's single-device
    path: --mesh 1 shards nothing), sssp --devices 0 --sharded-mode band
    (the sharded path at world size 1, one NCCL rank), and spmv --mesh 2,
    which one card refuses with JAX's error."""
    import contextlib
    import io

    from sparseharness_tpu_torch.cli import main as cli
    from sparseharness_tpu_torch.formats import banded_coo, write_mtx

    path, jsonl = os.path.join(d, "cli_band.mtx"), os.path.join(d, "cli.jsonl")
    write_mtx(path, banded_coo(CLI_BAND_N, BAND, seed=1))
    runs = []
    want = {("spmv", "--mesh 1"): "ell",
            ("sssp", "--mesh 1 --sharded-mode band"): "sssp:ell",
            ("sssp", "--devices 0 --sharded-mode band"): "sssp:sharded1:band"}
    for (app, flags), kernel in want.items():
        if os.path.exists(jsonl):
            os.remove(jsonl)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.COMMANDS[app](["-m", path, "-n", "2", "--jsonl", jsonl, "--device", device]
                                   + flags.split())
        with open(jsonl) as f:
            rows = [json.loads(line) for line in f]
        runs.append({"app": app, "flags": flags, "rc": rc, "seconds": time.perf_counter() - t0,
                     "kernels": sorted({r["kernel"] for r in rows}),
                     "correctness": sorted({r["correctness"] for r in rows})})
        if rc != 0 or runs[-1]["kernels"] != [kernel] or runs[-1]["correctness"] != ["correct"]:
            raise AssertionError(f"cli {app} {flags}: {runs[-1]}")
    if device != "cuda":  # gloo ranks on the CPU: no card to refuse
        return {"runs": runs}
    try:
        cli.COMMANDS["spmv"](["-m", path, "-n", "1", "--mesh", "2"])
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("spmv --mesh 2 ran on one card")
    if refused != f"requested 2 devices, have {torch.cuda.device_count()}":
        raise AssertionError(f"spmv --mesh 2: {refused!r}")
    return {"runs": runs, "mesh2_refused": refused}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from sparseharness_tpu_torch.formats import (
        banded_coo, block_random_coo, native_io, power_law_coo, random_coo,
    )
    from sparseharness_tpu_torch.ops import LAUNCHES, _build

    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "card": card, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    with Phase("build") as f:
        t0 = time.perf_counter()
        # the host library (g++) builds beside the kernels (one nvcc each)
        with concurrent.futures.ThreadPoolExecutor(max_workers=1) as pool:
            host_lib = pool.submit(native_io.load)
            reports = _build.build()
            host_lib.result()
        f["build_seconds"] = time.perf_counter() - t0
        f["sources"] = sorted(_build.sources())
        f["host_library"] = str(native_io.library_path().relative_to(
            os.path.dirname(os.path.abspath(__file__))))
        log = "\n".join(reports.values())
        f["ptxas_max_registers"] = max(
            (int(m) for m in re.findall(r"Used (\d+) registers", log)), default=None)
        f["ptxas_spills"] = [ln.strip() for ln in log.splitlines()
                             if re.search(r"[1-9]\d* bytes spill", ln)]

    with Phase("data") as f:
        coo = banded_coo(FULL_N, BAND, seed=1)
        small = banded_coo(SMALL_N, SMALL_BAND, seed=3)
        bcoo = block_random_coo(BLOCK_N, 2, bm=8, bn=128, seed=BLOCK_SEED)
        f.update(rows=coo.shape[0], nnz=coo.nnz, block_rows=bcoo.shape[0],
                 block_nnz=bcoo.nnz)

    errs = {"staged": 0.0, "streamed": 0.0}
    with Phase("kernel_vs_plain_small") as f:
        f.update(kernel_vs_plain(torch, small, errs))
    with Phase("kernel_vs_plain_full") as f:
        f.update(kernel_vs_plain(torch, coo, errs))
        f["max_abs_err"] = errs

    for key in LAUNCHES:
        LAUNCHES[key] = 0
    spmv_lines, app_lines = [], []
    with Phase("main_path_spmv") as f:
        spmv_main_path(torch, coo, spmv_lines)
        f.update(card=card, nvidia_smi=smi, runs=spmv_lines)
    with Phase("main_path_fixpoints") as f:
        fixpoints_main_path(torch, coo, app_lines)
        f.update(card=card, nvidia_smi=smi, runs=app_lines)
    launches = dict(LAUNCHES)
    emit({"phase": "main_path_launches", "launches": launches})
    for path in ("staged", "streamed"):
        if launches[path] <= 0:
            raise AssertionError(f"the {path} kernel never launched on the main path")

    with Phase("small_apps_vs_gold") as f:
        f.update(small_apps(torch))

    with Phase("kernel_times") as f:
        times = kernel_times(torch, coo)
        f.update(card=card, nvidia_smi=smi, times=times)
    with Phase("band_span_probe") as f:
        f.update(card=card, nvidia_smi=smi, **band_span_probe())

    berrs = dict.fromkeys(BLOCKED, 0.0)
    with Phase("blocked_kernel_vs_plain_small") as f:
        checked = 0
        for m in (random_coo(1138, 1138, 4054, seed=0),
                  block_random_coo(4096, 2, seed=BLOCK_SEED), one_wide_row()):
            checked += blocked_vs_plain(torch, m, all_cases(torch), berrs,
                                        tiles_per_slab=(None, 20))
        f["comparisons"] = checked
    with Phase("blocked_kernel_vs_plain_full") as f:
        f["comparisons"] = blocked_vs_plain(
            torch, bcoo, [("plus_times", "float32"), ("plus_times", "bfloat16"),
                          ("min_plus", "float32"), ("or_and", "float32")], berrs)
        f["max_abs_err"] = berrs

    for key in LAUNCHES:
        LAUNCHES[key] = 0
    bspmv_lines, bapp_lines = [], []
    with Phase("main_path_blocked_spmv") as f:
        blocked_main_path(torch, bcoo, bspmv_lines)
        f.update(card=card, nvidia_smi=smi, runs=bspmv_lines)
    with Phase("main_path_blocked_fixpoints") as f:
        blocked_fixpoints(torch, bcoo, bapp_lines)
        f.update(card=card, nvidia_smi=smi, runs=bapp_lines)
    blaunches = dict(LAUNCHES)
    emit({"phase": "main_path_blocked_launches", "launches": blaunches})
    for kernel in BLOCKED:
        if blaunches[kernel] <= 0:
            raise AssertionError(f"the {kernel} kernel never launched on the blocked "
                                 "main path")
    launches.update({k: blaunches[k] for k in BLOCKED})

    with Phase("variant_gate") as f:
        f.update(variant_gate(torch))

    with Phase("blocked_kernel_times") as f:
        btimes = blocked_kernel_times(torch, bcoo)
        f.update(card=card, nvidia_smi=smi, times=btimes)

    rcoo = power_law_coo(RAGGED_N, RAGGED_NNZ, alpha=1.5, seed=RAGGED_SEED)
    launches["sell2"], rerrs, rtimes = ragged_phases(torch, card, smi, rcoo)

    serrs = {"spmm_band": 0.0, "spmm_tiles": 0.0}
    with Phase("spmm_kernel_vs_plain_small") as f:
        f["comparisons"] = spmm_vs_plain_small(torch, serrs)
    with Phase("spmm_band_nonfinite") as f:
        f.update(spmm_band_nonfinite(torch, coo, serrs))

    for key in LAUNCHES:
        LAUNCHES[key] = 0
    sp_lines, ms_lines, route_lines = [], [], []
    with Phase("main_path_spmm") as f:
        spmm_full_width(torch, coo, bcoo, sp_lines, serrs)
        f.update(card=card, nvidia_smi=smi, runs=sp_lines, max_abs_err=serrs)
    with Phase("main_path_multi_source") as f:
        multi_source_full_width(torch, bcoo, ms_lines)
        f.update(card=card, nvidia_smi=smi, runs=ms_lines)
    with Phase("main_path_multi_source_routes") as f:
        multi_source_routes(torch, rcoo, route_lines)
        f.update(card=card, nvidia_smi=smi, runs=route_lines)
    slaunches = dict(LAUNCHES)
    by_shape = {}
    for line in sp_lines + ms_lines + route_lines:
        for point, count in line.get("spmm_tiles_launches", {}).items():
            by_shape[point] = by_shape.get(point, 0) + count
    emit({"phase": "main_path_spmm_launches", "launches": slaunches,
          "spmm_tiles_by_shape": by_shape})
    if sum(by_shape.values()) != slaunches["spmm_tiles"]:
        raise AssertionError(f"spmm_tiles launches by shape {by_shape} do not add up to "
                             f"{slaunches['spmm_tiles']}")
    for kernel in ("spmm_band", "spmm_tiles"):
        if slaunches[kernel] <= 0:
            raise AssertionError(f"the {kernel} kernel never launched on the SpMM path")
        launches[kernel] = slaunches[kernel]

    with Phase("spmm_kernel_times") as f:
        stimes = spmm_kernel_times(torch, coo, bcoo)
        f.update(card=card, nvidia_smi=smi, times=stimes)

    lerrs = {"sell_fused": 0.0, "sell_level": 0.0}
    with Phase("sell_kernel_vs_plain_small") as f:
        f["comparisons"] = sum(sell_vs_plain(torch, m, kw, SEMIRINGS, lerrs)
                               for m, kw in sell_cases(torch))
    band16 = banded_coo(SELL_BAND_N, BAND, seed=1)
    with Phase("sell_kernel_vs_plain_band") as f:
        t0 = time.perf_counter()
        f["comparisons"] = sell_vs_plain(torch, band16, {}, ("min_plus", "or_and"), lerrs)
        f.update(rows=band16.shape[0], nnz=band16.nnz, build_and_check_seconds=(
            time.perf_counter() - t0), max_abs_err=lerrs)
    sell_coo = banded_coo(SELL_N, BAND, seed=1)

    for key in LAUNCHES:
        LAUNCHES[key] = 0
    sell_lines, sapp_lines, cli_lines = [], [], []
    with Phase("main_path_sell_spmv") as f:
        sell_prob = sell_main_path(torch, sell_coo, sell_lines)
        f.update(card=card, nvidia_smi=smi, runs=sell_lines)
    with Phase("main_path_sell_fixpoints") as f:
        sell_fixpoints(torch, band16, sapp_lines)
        f.update(card=card, nvidia_smi=smi, runs=sapp_lines)
    mtx_dir = tempfile.TemporaryDirectory()
    with Phase("main_path_cli") as f:
        cli_path(torch, band16, random_coo(1138, 1138, 4054, seed=0), mtx_dir.name,
                 cli_lines)
        f.update(card=card, nvidia_smi=smi, runs=cli_lines)
    llaunches = dict(LAUNCHES)
    emit({"phase": "main_path_sell_launches", "launches": llaunches})
    for kernel in ("sell_fused", "sell_level"):
        if llaunches[kernel] <= 0:
            raise AssertionError(f"the {kernel} kernel never launched on the sell path")
        launches[kernel] = llaunches[kernel]

    with Phase("native_host") as f:
        f.update(card=card, nvidia_smi=smi,
                 **native_host(torch, rcoo, band16, os.path.join(mtx_dir.name, "band.mtx")))
    mtx_dir.cleanup()

    with Phase("sell_kernel_times") as f:
        ltimes = sell_kernel_times(torch, sell_prob.operand, sell_coo, lerrs)
        f.update(card=card, nvidia_smi=smi, times=ltimes, max_abs_err=lerrs)
    del sell_prob

    with Phase("sharded_world1") as f:
        world1 = sharded_world1(torch)
        f.update(card=card, nvidia_smi=smi,
                 **{k: v for k, v in world1.items() if k != "band16"})
    with Phase("sharded_ranks2_one_card") as f:
        f.update(card=card, nvidia_smi=smi, **sharded_ranks2_one_card(torch, world1))
    with Phase("weak_scaling") as f:
        f.update(card=card, nvidia_smi=smi, **weak_scaling_phase(torch))
    with tempfile.TemporaryDirectory() as cli_dir, Phase("sharded_cli") as f:
        f.update(card=card, nvidia_smi=smi, **sharded_cli(torch, cli_dir))

    dia_kernel = dia_phases(torch, card, smi)

    f32 = times["float32"]
    replaces = {"staged": "sparseharness_tpu/ops/pallas_bsr_band.py:180",
                "streamed": "sparseharness_tpu/ops/pallas_bsr_band.py:259"}
    kernels = [{
        "name": f"bsr_band_{path}",
        "route": "cuda",
        "source": "sparseharness_tpu_torch/ops/csrc/bsr_band.cu",
        "replaces": replaces[path],
        "launches": launches[path],
        "max_abs_err": errs[path],
        "ms": f32[f"{path}_ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
    } for path in ("staged", "streamed")]
    sources = {"bsr_fused": "sparseharness_tpu_torch/ops/csrc/bsr_strips.cu",
               "bsr_ell": "sparseharness_tpu_torch/ops/csrc/bsr_strips.cu",
               "bsr_pallas": "sparseharness_tpu_torch/ops/csrc/bsr_tiles.cu"}
    replaces = {"bsr_fused": "sparseharness_tpu/ops/pallas_bsr_fused.py:105",
                "bsr_ell": "sparseharness_tpu/ops/pallas_bsr_ell.py:173",
                "bsr_pallas": "sparseharness_tpu/ops/pallas_bsr.py:231"}
    for kernel in BLOCKED:
        t = btimes["float32"][kernel]
        kernels.append({
            "name": kernel, "route": "cuda", "source": sources[kernel],
            "replaces": replaces[kernel], "launches": launches[kernel],
            "max_abs_err": berrs[kernel], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": btimes["library_ms"],
        })
    t = rtimes["float32"]
    kernels.append({
        "name": "sell2", "route": "cuda",
        "source": "sparseharness_tpu_torch/ops/csrc/sell2.cu",
        "replaces": "sparseharness_tpu/ops/pallas_sell2.py:926",
        "launches": launches["sell2"], "max_abs_err": rerrs["sell2"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": rtimes["library_ms"],
        "points": {"kron20": {k: rtimes["kron20"][k] for k in (
            "degree", "as_is", "bound_ms", "bound_by", "library_ms", "max_abs_err",
            "launches")}},
    })
    t = stimes["band float32 m=128"]
    kernels.append({
        "name": "spmm_band", "route": "cuda",
        "source": "sparseharness_tpu_torch/ops/csrc/spmm_band.cu",
        "replaces": "sparseharness_tpu/ops/pallas_bsr_band.py:334",
        "launches": launches["spmm_band"], "max_abs_err": serrs["spmm_band"], "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": t["library_ms"], "layout_bound_ms": t["layout_bound_ms"],
    })
    # spmm_tiles at the shape where most of its main-path launches run, and
    # in `points` beside it the blocked m = 128 points, each with its own
    # launches, error, times and bound (the band's launches are min_plus and
    # or_and together)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err")
    points = {point: {"launches": by_shape.get(shape, 0), **{k: stimes[point][k] for k in keys}}
              for point, shape in (("band min_plus m=8", "band m=8"),
                                   ("blocked plus_times m=128", "blocked plus_times m=128"),
                                   ("blocked min_plus m=128", "blocked min_plus m=128"))}
    points["band min_plus m=8"]["layout_bound_ms"] = stimes["band min_plus m=8"]["layout_bound_ms"]
    for point in ("blocked plus_times m=128", "blocked min_plus m=128"):
        points[point]["x_read_bytes"] = stimes[point]["x_read_bytes"]
        points[point]["x_read_GBps"] = stimes[point]["x_read_GBps"]
    t = points["band min_plus m=8"]
    kernels.append({
        "name": "spmm_tiles", "route": "cuda",
        "source": "sparseharness_tpu_torch/ops/csrc/spmm_tiles.cu",
        "replaces": "sparseharness_tpu/ops/spmm_tiles.py:130",
        "launches": launches["spmm_tiles"], "point": "band min_plus m=8",
        **{k: t[k] for k in keys}, "points": points,
    })
    # sell_fused also replaces level 0 of pallas_sell.py:361, sell_level its
    # depths 1 and more in one launch; the level launch's time is the
    # card's (profiler, launched alone), since the host enqueues it slower
    # than it runs, and tail_ms what it adds past the fused launch in a dp
    for name, line in (("sell_fused", 330), ("sell_level", 361)):
        t = ltimes[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "sparseharness_tpu_torch/ops/csrc/sell.cu",
            "replaces": f"sparseharness_tpu/ops/pallas_sell.py:{line}",
            "launches": launches[name], "max_abs_err": lerrs[name],
            "ms": t.get("device_ms", t["ms"]),
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": ltimes["library_ms"],
            **({"tail_ms": t["tail_ms"]} if "tail_ms" in t else {}),
        })
    kernels.append(dia_kernel)
    emit({"kernels": kernels})
    print(nvidia_smi())
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

Run from the repository root with one CUDA card and nvcc present:

    python3 chip_smoke.py

It imports only the port (``sparseharness_tpu_torch``), never JAX. Each
phase prints one JSON line with its seconds; any failure raises, so the
script exits non-zero, and without a card it exits 1 before printing any
result. Phases:

1. device and build: the card, its power limit, torch and CUDA versions,
   and the nvcc build of every kernel source;
2. kernel vs plain: both paths of the bsr_band kernel (x staged in shared
   memory, x streamed) against the plain torch version on the same CUDA
   tensors, for all seven semirings and every strip type, at a small and at
   the full bench width; bit-exact except plus_times, held within
   1e-5 · max(1, |plain|, Σ|a·x|) because its sum order differs;
3. the main path, with the launch counters reset just before and read just
   after: the 524,288-row band SpMV (bench.py's headline, 66,580,544 nnz)
   through make_spmv_problem and benchmark_spmv, gold-gated in f32 and bf16
   on both kernel paths; then the sssp, bfs and pagerank fixpoints at that
   width, each with a certificate that is cheap at full width;
4. the same apps on a small band against the port's NumPy golds;
5. kernel timing at the main path's f32 shape (CUDA events): each kernel
   path, the plain version, torch.mv on a CSR tensor of the same matrix as
   the library yardstick, and the bytes/operations bound;
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
   banded_coo(1138, 8, seed=0);
9. kernel timing at the blocked shape: each blocked kernel, its plain
   version, torch.mv on a CSR tensor of the same matrix, and the bound;
10. the sell2 kernel against its plain version: all seven semirings and
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
   device time per launch of each of its kernels from torch.profiler, with
   the launches it recorded), its plain
   version, torch.mv on a CSR tensor of the same matrix, the bound, and
   the seconds of each build;
13. the SpMM kernels against their plain versions: spmm_tiles for all
   seven semirings and strip types over bsr_ell and bsr_fused strips of
   random_coo(300, 257, 2500, seed=3) and random_coo(64, 4096, 6000,
   seed=5) (K > 8) and the explicit columns of banded_coo(96, 40,
   seed=53), spmm_band in f32 and bf16, at m up to 200; bit for bit except
   plus_times (within the tolerance above, and the same bits twice);
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
   solved with reorder="rcm", which must resolve bsr_band and equal the
   unshuffled solve;
17. SpMM kernel times at the full-width points: the median of five 20-call
   windows, the plain version, torch.sparse.mm on a CSR tensor (cuSPARSE,
   f32 plus_times only) and the bound;
18. the sell kernels (phase A and the gather-reduce level) against the
   plain dp: all seven semirings on the matrices of tests/test_torch_sell.py
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
   one phase-A launch a step, certified as in phase 3;
21. the CLI: the 1 << 16 band and the gate's matrix written with write_mtx
   into a temporary directory, then the nine commands run in process as
   ``python -m sparseharness_tpu_torch.cli <app>`` runs them (spmv and sssp
   with -k sell on the band; the sweep, a stepped sssp, bfs from three
   roots, pr, scc --full, eigenvector, cc, widest_path and just_parser -k
   sell on the small matrix), every return code 0, every JSONL row parsed
   and none gold-checked incorrect, the band's spmv and sssp rows and the
   sweep's sell row correct, and one spmv -k sell as a subprocess, correct;
22. sell kernel times at the 1 << 18 band: the whole dp, phase A alone and
   the levels alone (median of five 20-call windows of CUDA events), the
   plain versions, torch.mv on a CSR tensor of the same matrix and the
   bounds; phase A's contrib stream and the dp held against the plain
   version bit for bit.

Then the kernels line, the nvidia-smi line and, last, the ok line.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
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


def kernel_vs_plain(torch, coo, errs) -> dict:
    """Both kernel paths against the plain version on one matrix; the worst
    plus_times error per path goes into ``errs``."""
    from sparseharness_tpu_torch.ops import bsr_band
    from sparseharness_tpu_torch.semiring import PLUS_TIMES, get_semiring

    rng = np.random.default_rng(7)
    n = coo.shape[0]
    checked = 0
    for name in SEMIRINGS:
        sr = get_semiring(name)
        for vd in (("float32", "bfloat16") if sr.dtype == torch.float32 else ("float32",)):
            op = bsr_band.build_bsr_band(coo, sr, value_dtype=vd, device="cuda")
            x = random_x(torch, sr, n, rng)
            x2d = bsr_band.pad_x(op, x, sr)
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
                                            k_win=op.k_win, stage_x=stage_x, kc=kc)
                ref = bsr_band.band_dp_plain(op.strips, x2d, sr, c0=op.c0,
                                             k_win=op.k_win, kc=kc)
                errs[path] = max(errs[path], check_kernel(
                    torch, f"{path} {name}/{vd}/kc={kc}", got, ref, bound))
                checked += 1
            del op, x2d
    return {"rows": n, "nnz": coo.nnz, "comparisons": checked}


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
    library yardstick's ms and the bound, for f32 (and the kernels' bf16)."""
    from sparseharness_tpu_torch.harness import device_hbm_bandwidth
    from sparseharness_tpu_torch.ops import bsr_band
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    card = torch.cuda.get_device_name(0)
    bw = device_hbm_bandwidth(card)
    n = coo.shape[0]
    x = random_x(torch, PLUS_TIMES, n, np.random.default_rng(11))
    res = {}
    for vd in ("float32", "bfloat16"):
        op = bsr_band.build_bsr_band(coo, PLUS_TIMES, value_dtype=vd, device="cuda")
        x2d = bsr_band.pad_x(op, x, PLUS_TIMES)
        n_bytes = (op.strips.numel() * op.strips.element_size()
                   + x2d.numel() * 4 + op.strips.shape[0] * op.strips.shape[1] * 4)
        n_ops = 2 * op.strips.numel()  # one ⊗ and one ⊕ per strip slot
        bytes_ms, ops_ms = n_bytes / bw * 1e3, n_ops / F32_PEAK_OPS * 1e3
        entry = {"bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                 "bytes": n_bytes}
        for path, stage_x in (("staged", True), ("streamed", False)):
            kc = bsr_band.chunk_slots(op, stage_x)
            entry[f"{path}_ms"] = time_ms(torch, lambda: bsr_band.band_dp_cuda(
                op.strips, x2d, PLUS_TIMES, c0=op.c0, k_win=op.k_win,
                stage_x=stage_x, kc=kc), 50)
        entry["plain_ms"] = time_ms(torch, lambda: bsr_band.band_dp_plain(
            op.strips, x2d, PLUS_TIMES, c0=op.c0, k_win=op.k_win, kc=op.k_win), 5)
        res[vd] = entry
        del op, x2d
    # library yardstick: cuSPARSE SpMV through torch.mv on a CSR tensor of
    # the same matrix (plus_times, f32)
    csr = csr_of(torch, coo)
    res["float32"]["library_ms"] = time_ms(torch, lambda: torch.mv(csr, x), 20)
    return res


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
    gold-checked CORRECT on the card."""
    from sparseharness_tpu_torch.algorithms import make_spmv_problem
    from sparseharness_tpu_torch.formats import banded_coo, random_coo
    from sparseharness_tpu_torch.gold import Correctness, spmv_gold
    from sparseharness_tpu_torch.harness import BenchmarkConfig, benchmark_spmv
    from sparseharness_tpu_torch.ops import VARIANTS
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    small = random_coo(1138, 1138, 4054, seed=0)
    band = banded_coo(1138, 8, seed=0)
    gate = [(v, small) for v in sorted(VARIANTS) if v not in ("bsr_band", "dia")]
    gate += [("bsr_band", band), ("dia", band)]
    for variant, m in gate:
        prob = make_spmv_problem(m, variant=variant, seed=1)
        gold = spmv_gold(m, prob.x0.cpu().numpy(), prob.y.cpu().numpy(), PLUS_TIMES)
        res = benchmark_spmv(prob, gold=gold, config=BenchmarkConfig(trials=1))
        if res.correctness is not Correctness.CORRECT:
            raise AssertionError(f"gate: {variant} is {res.correctness}")
    return {"variants": [v for v, _ in gate], "correct": len(gate)}


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
    bytes_ms, ops_ms = n_bytes / bw * 1e3, n_ops / F32_PEAK_OPS * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": n_bytes}


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
        ref = sell2.dp_sell2_plain(op, x, sr, n_rows=m.shape[0])
        bound = None
        if name == "plus_times":
            again = sell2.sell2_dp_cuda(op, x, sr)
            torch.cuda.synchronize()
            if not torch.equal(again.view(torch.int32), got.view(torch.int32)):
                raise AssertionError(f"sell2 {name}/{vd}: two runs differ")
            if not torch.equal(got, ref):
                aop = sell2.build_sell2(m.with_values(np.abs(m.vals)), sr, value_dtype=vd,
                                        device="cuda")
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
        op = build_operand(m, sr, "sell2")
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


def ragged_kernel_times(torch, coo) -> dict:
    """The sell2 kernel's ms at the ragged shape (f32 and bf16), its plain
    version's ms, the bound, the seconds of each build and the library
    yardstick's ms. The bound counts the panel stream, piece_owner and
    virt_blocks, x and the output once each; the run table the kernel
    derives from the stream is reported beside it but not counted."""
    from sparseharness_tpu_torch.harness import device_hbm_bandwidth
    from sparseharness_tpu_torch.ops import sell2
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    bw = device_hbm_bandwidth(torch.cuda.get_device_name(0))
    x = random_x(torch, PLUS_TIMES, coo.shape[1], np.random.default_rng(13))
    res = {}
    for vd in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        op = sell2.build_sell2(coo, PLUS_TIMES, value_dtype=vd, device="cuda")
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        stream = [t for s in op.slabs if s is not None for t in s.values()]
        extra = [t for t in (op.piece_owner, op.virt_blocks) if t is not None]
        plan = op.plan
        n_slots = sum(s["vals"].numel() for s in op.slabs if s is not None)
        out_rows = op.base_pad if op.piece_owner is not None else plan.n_out
        entry = bound(tensor_bytes(*stream, *extra) + x.numel() * 4 + out_rows * 4,
                      2 * n_slots, bw)
        entry.update(
            build_seconds=build_s, panels=plan.n_panels, layouts=len(op.layouts),
            runs=plan.n_runs, slots=n_slots, pieces=0 if op.piece_owner is None
            else int(op.piece_owner.numel()),
            virtual_chunks=0 if op.virt_blocks is None else int(op.virt_blocks.shape[0]),
            stream_bytes=tensor_bytes(*stream),
            plan_bytes=tensor_bytes(*(getattr(plan, f.name) for f in dataclasses.fields(plan)
                                      if isinstance(getattr(plan, f.name), torch.Tensor))),
            **time_windows(torch, lambda: sell2.sell2_dp_cuda(op, x, PLUS_TIMES)),
            plain_ms=time_ms(torch, lambda: sell2.dp_sell2_plain(
                op, x, PLUS_TIMES, n_rows=coo.shape[0]), 3))
        entry["stages"] = stage_ms(torch, lambda: sell2.sell2_dp_cuda(op, x, PLUS_TIMES),
                                   r"sell2_\w+?_kernel")
        res[vd] = entry
        del op
    csr = csr_of(torch, coo)
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
    """Both sell kernels (one sell_dp_cuda call) against dp_sell_plain on
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
        errs["sell_phase_a"] = max(errs["sell_phase_a"], err)
        errs["sell_level"] = max(errs["sell_level"], err)
        del op, x2d
    return len(names)


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
    """sssp and bfs with variant="sell" on the 1 << 16 band: one phase-A
    launch a step. Certificates as phase 3's, with the plain band dp."""
    from sparseharness_tpu_torch.algorithms import bfs, sssp
    from sparseharness_tpu_torch.ops import LAUNCHES, build_operand, dp_bsr_band_plain, fold_dp
    from sparseharness_tpu_torch.semiring import MIN_PLUS

    n = band.shape[0]

    def run(app):
        before = LAUNCHES["sell_phase_a"]
        t0 = time.perf_counter()
        r = app(band, 0, variant="sell")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if LAUNCHES["sell_phase_a"] - before != r.iterations:
            raise AssertionError(f"{app.__name__}: {LAUNCHES['sell_phase_a'] - before} sell "
                                 f"phase-A launches for {r.iterations} steps")
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


def cli_path(torch, band, small, out) -> None:
    """The nine CLI commands in process, as python -m
    sparseharness_tpu_torch.cli runs them, on .mtx files written by the
    port's write_mtx; then spmv -k sell as a subprocess. Every return code
    must be 0, every JSONL row must parse, no row may be gold-checked
    incorrect, and the rows of spmv -k sell and sssp -k sell on the band,
    the sweep's sell row on the small matrix and the subprocess must read
    correct."""
    import contextlib
    import io
    import os
    import tempfile

    from sparseharness_tpu_torch.cli import main as cli
    from sparseharness_tpu_torch.formats import write_mtx

    with tempfile.TemporaryDirectory() as d:
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
                ("just_parser", ["-m", small_path, "-k", "sell", "-n", "2"])]
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


def sell_kernel_times(torch, op, coo, errs) -> dict:
    """The sell kernels at the 1 << 18 band: the whole dp, phase A alone and
    the levels alone (CUDA events), their plain versions, torch.mv on a CSR tensor of the same
    matrix, and the bounds. Whole dp: the operand's arrays, x and the output
    (variant_bytes) and 2 ops per nonzero. Phase A as a function: lanesel,
    vals, blocksel and x in, the contrib stream out, one ⊗ per nonzero. The
    levels: the contrib stream and every idx array in, the dp out, one ⊕
    per nonzero but the first of each row. Phase A's contrib stream and the
    dp are held against the plain version bit for bit first."""
    from sparseharness_tpu_torch.harness import device_hbm_bandwidth, variant_bytes
    from sparseharness_tpu_torch.ops import sell
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    bw = device_hbm_bandwidth(torch.cuda.get_device_name(0))
    n = coo.shape[0]
    sr = PLUS_TIMES
    x = random_x(torch, sr, coo.shape[1], np.random.default_rng(16))
    x2d = sell.pad_x2d(op, x, sr)
    work = torch.empty((op.work_rows, 128), dtype=torch.float32, device="cuda")
    dp = torch.empty(op.n_pad, dtype=torch.float32, device="cuda")
    sell.phase_a_cuda(op, x2d, sr, work)
    contribs = [sell.phase_a_plain(slab, x2d, sr) for slab in op.slabs]
    ta_rows = op.lanesel.shape[0]
    errs["sell_phase_a"] = max(errs["sell_phase_a"], check_kernel(
        torch, "sell phase A at full width", work[:ta_rows], torch.cat(contribs), None))
    sell.levels_cuda(op, sr, work, dp)
    errs["sell_level"] = max(errs["sell_level"], check_kernel(
        torch, "sell dp at full width", dp, sell.dp_sell_plain(op, x, sr, n_rows=n), None))

    def plain_levels():
        for slab, lay, src in zip(op.slabs, op.layouts, contribs):
            for li, level in enumerate(lay.levels):
                src = sell.level_plain(src, slab[f"idx{li}"], level, sr)

    f32 = 4
    contrib_bytes = ta_rows * 128 * f32
    rows_used = int(np.count_nonzero(np.bincount(coo.rows, minlength=n)))
    res = {
        "dp": {**bound(variant_bytes("sell", op, x.numel() * f32, n * f32), 2 * coo.nnz, bw),
               **time_windows(torch, lambda: sell.sell_dp_cuda(op, x2d, sr)),
               "plain_ms": time_ms(torch, lambda: sell.dp_sell_plain(op, x, sr, n_rows=n), 3)},
        "sell_phase_a": {
            **bound(tensor_bytes(op.lanesel, op.vals, op.blocksel, x2d) + contrib_bytes,
                    coo.nnz, bw),
            **time_windows(torch, lambda: sell.phase_a_cuda(op, x2d, sr, work)),
            "plain_ms": time_ms(torch, lambda: [sell.phase_a_plain(s, x2d, sr)
                                                for s in op.slabs], 3)},
        "sell_level": {
            **bound(tensor_bytes(op.idx) + contrib_bytes + op.n_pad * f32,
                    coo.nnz - rows_used, bw),
            **time_windows(torch, lambda: sell.levels_cuda(op, sr, work, dp)),
            "plain_ms": time_ms(torch, plain_levels, 3)},
        "depth_rows": list(op.depth_rows), "work_rows": op.work_rows,
    }
    csr = csr_of(torch, coo)
    res["library_ms"] = time_ms(torch, lambda: torch.mv(csr, x), 20)
    del csr, work, dp, contribs
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
    columns of banded_coo(96, 40, seed=53), at m in (1, 5, 40, 200);
    spmm_band in f32 and bf16 at m in (1, 40, 200). Bit for bit but
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
            for m in (1, 5, 40, 200):
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
                got = bsr_band.band_spmm_cuda(op.strips, x2d, **args)
                check_same_bits(torch, f"spmm_band {coo.shape} {vd} m={m}", got,
                                bsr_band.band_spmm_cuda(op.strips, x2d, **args))
                ref = bsr_band.band_spmm_plain(op.strips, x2d, **args)
                bound = bsr_band.band_spmm_plain(op.strips.abs(), x2d, **args)
                errs["spmm_band"] = max(errs["spmm_band"], check_kernel(
                    torch, f"spmm_band {coo.shape} {vd} m={m}", got, ref, bound))
                checked += 1
    return checked


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
                                                            if j < x.shape[1])})

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
        return r, dt

    t0 = time.perf_counter()
    ell_op = build_operand(bcoo, MIN_PLUS, "bsr_ell")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    for variant in ("bsr_ell", "auto"):
        kw = {} if variant == "bsr_ell" else {"variant": "auto"}
        r, dt = run(multi_sssp, **kw)
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
                    "reached": int((r.x < 3e38).sum())})
        if not (cert and singles and resolved == ("bsr_ell" if variant == "bsr_ell"
                                                  else "bsr_fused")):
            raise AssertionError(f"multi_sssp ({variant} -> {resolved}) certificate failed")
        del r, ax, off_root

    r, dt = run(multi_bfs)
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
                "certified": cert, "columns_equal_single_source": singles})
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
        return r, dt

    r_sssp, dt = run("spmm_tiles", 1, multi_sssp, band, roots, variant="bsr_band")
    op = ell_operand_from_band(build_operand(band, MIN_PLUS, "bsr_band"))
    ax = fold_dp(spmm_bsr_ell_plain(op, r_sssp.x, MIN_PLUS, n_rows=n), None, MIN_PLUS,
                 None, None)
    off_root = torch.ones_like(r_sssp.x, dtype=torch.bool)
    off_root[torch.as_tensor(roots, device="cuda"), torch.arange(8, device="cuda")] = False
    cert = bool(r_sssp.converged and torch.equal(ax[off_root], r_sssp.x[off_root]))
    out.append({"app": "multi_sssp", "matrix": f"banded{n}", "variant": "bsr_band",
                "roots": 8, "iterations": r_sssp.iterations, "seconds": dt,
                "certificate": "A⊗X == X off the roots", "certified": cert})
    if not cert:
        raise AssertionError("band multi_sssp certificate failed")
    del op, ax, off_root

    r, dt = run("spmm_tiles", 1, multi_bfs, band, roots, variant="bsr_band")
    # the band is complete, so a vertex is ceil(|i − root| / BAND) levels out
    dist = (torch.arange(n, device="cuda")[:, None]
            - torch.as_tensor(roots, device="cuda")[None, :]).abs()
    want = ((dist + BAND - 1) // BAND).to(torch.int32)
    cert = bool(r.converged and torch.equal(r.aux, want))
    out.append({"app": "multi_bfs", "matrix": f"banded{n}", "variant": "bsr_band",
                "roots": 8, "iterations": r.iterations, "seconds": dt,
                "certificate": f"levels == ceil(|i − root| / {BAND}), every column",
                "certified": cert})
    if not cert:
        raise AssertionError("band multi_bfs certificate failed")

    rroots = np.random.default_rng(31).choice(rcoo.shape[0], 8, replace=False)
    r, dt = run("sell2", 8, multi_bfs, rcoo, rroots, variant="auto")
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
    try:
        t0 = time.perf_counter()
        r = multi_sssp(shuffled, inv_scramble[roots], variant="auto", reorder="rcm")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        apps.rcm_permutation = rcm_permutation
    reordered = permute_coo(shuffled, seen["perm"])
    resolved = build_operand_auto(reordered, MIN_PLUS)[0]
    # shuffled vertex i is band vertex scramble[i]
    same = torch.equal(r.x, r_sssp.x[torch.as_tensor(scramble, device="cuda").long()])
    out.append({"app": "multi_sssp", "matrix": f"shuffled banded{n}",
                "variant": f"auto, reorder=rcm -> {resolved}", "roots": 8,
                "iterations": r.iterations, "seconds": dt, "rcm_seconds": seen["seconds"],
                "bandwidth_before": bandwidth(shuffled), "bandwidth_after": bandwidth(reordered),
                "certificate": "resolves bsr_band; x == the unshuffled band's x, un-permuted",
                "certified": bool(same and resolved == "bsr_band")})
    if not (same and resolved == "bsr_band"):
        raise AssertionError(f"rcm multi_sssp: resolved {resolved}, equal {same}")


def spmm_kernel_times(torch, coo, bcoo) -> dict:
    """Both SpMM kernels at the full-width points: the median of five
    20-call windows, the chunked plain version, torch.sparse.mm on a CSR
    tensor of the same matrix (cuSPARSE SpMM, plus_times in f32 only: no
    library call computes the other semirings) and the bound. The bound
    counts the strips (and tile_cols), X once and Y once, and 2 operations
    per nonzero per column: the strips' pad slots are bytes the kernel must
    read but no work the product needs."""
    from sparseharness_tpu_torch.harness import device_hbm_bandwidth
    from sparseharness_tpu_torch.ops import Geometry, bsr_band, build_operand, spmm_tiles
    from sparseharness_tpu_torch.semiring import MIN_PLUS, PLUS_TIMES

    bw = device_hbm_bandwidth(torch.cuda.get_device_name(0))
    gen = torch.Generator(device="cuda").manual_seed(41)
    res = {}
    n = coo.shape[0]
    x256 = random_block(torch, PLUS_TIMES, n, 256, gen)
    csr = csr_of(torch, coo)
    for vd, m in (("float32", 128), ("float32", 256), ("bfloat16", 128)):
        op = build_operand(coo, PLUS_TIMES, "bsr_band", Geometry(8, 128, vd))
        x2d = bsr_band.pad_x_block(op, x256 if m == 256 else x256[:, :m].contiguous())
        out_bytes = op.strips.shape[0] * op.strips.shape[1] * m * 4
        entry = bound(tensor_bytes(op.strips, x2d) + out_bytes, 2 * coo.nnz * m, bw)
        args = dict(c0=op.c0, k_win=op.k_win)
        entry.update(time_windows(torch, lambda: bsr_band.band_spmm_cuda(op.strips, x2d,
                                                                         **args)))
        entry["plain_ms"] = time_ms(torch, lambda: bsr_band.band_spmm_plain(op.strips, x2d,
                                                                            **args), 2)
        if vd == "float32":
            entry["library_ms"] = time_ms(torch, lambda: torch.sparse.mm(csr, x2d[:n]), 10)
        res[f"band {vd} m={m}"] = entry
        del op, x2d
    del x256, csr

    n = bcoo.shape[0]
    x128 = random_block(torch, PLUS_TIMES, n, 128, gen)
    csr = csr_of(torch, bcoo)
    for sr, m in ((PLUS_TIMES, 128), (PLUS_TIMES, 8), (MIN_PLUS, 128)):
        op = build_operand(bcoo, sr, "bsr_ell")
        bn = op.tiles.shape[2] // op.tile_cols.shape[1]
        x2d = spmm_tiles.pad_x_block(x128 if m == 128 else x128[:, :m].contiguous(), bn, sr)
        out_bytes = op.tiles.shape[0] * op.tiles.shape[1] * m * 4
        entry = bound(tensor_bytes(op.tiles, op.tile_cols, x2d) + out_bytes,
                      2 * bcoo.nnz * m, bw)
        entry.update(time_windows(torch, lambda: spmm_tiles.spmm_tiles_cuda(
            op.tiles, op.tile_cols, x2d, sr)))
        entry["plain_ms"] = time_ms(torch, lambda: spmm_tiles.spmm_tiles_plain(
            op.tiles, op.tile_cols, x2d, sr), 2)
        entry["library_ms"] = (time_ms(torch, lambda: torch.sparse.mm(csr, x2d[:n]), 10)
                               if sr is PLUS_TIMES else None)
        res[f"blocked {sr.name} m={m}"] = entry
        del op, x2d
    del csr
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from sparseharness_tpu_torch.formats import (
        banded_coo, block_random_coo, power_law_coo, random_coo,
    )
    from sparseharness_tpu_torch.ops import LAUNCHES, _build

    card = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "card": card, "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})

    with Phase("build") as f:
        t0 = time.perf_counter()
        reports = _build.build()
        f["build_seconds"] = time.perf_counter() - t0
        f["sources"] = sorted(_build.sources())
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
    launches["sell2"] = rlaunches["sell2"]

    with Phase("ragged_kernel_times") as f:
        rtimes = ragged_kernel_times(torch, rcoo)
        f.update(card=card, nvidia_smi=smi, times=rtimes)

    serrs = {"spmm_band": 0.0, "spmm_tiles": 0.0}
    with Phase("spmm_kernel_vs_plain_small") as f:
        f["comparisons"] = spmm_vs_plain_small(torch, serrs)

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
    emit({"phase": "main_path_spmm_launches", "launches": slaunches})
    for kernel in ("spmm_band", "spmm_tiles"):
        if slaunches[kernel] <= 0:
            raise AssertionError(f"the {kernel} kernel never launched on the SpMM path")
        launches[kernel] = slaunches[kernel]

    with Phase("spmm_kernel_times") as f:
        stimes = spmm_kernel_times(torch, coo, bcoo)
        f.update(card=card, nvidia_smi=smi, times=stimes)

    lerrs = {"sell_phase_a": 0.0, "sell_level": 0.0}
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
    with Phase("main_path_cli") as f:
        cli_path(torch, band16, random_coo(1138, 1138, 4054, seed=0), cli_lines)
        f.update(card=card, nvidia_smi=smi, runs=cli_lines)
    llaunches = dict(LAUNCHES)
    emit({"phase": "main_path_sell_launches", "launches": llaunches})
    for kernel in ("sell_phase_a", "sell_level"):
        if llaunches[kernel] <= 0:
            raise AssertionError(f"the {kernel} kernel never launched on the sell path")
        launches[kernel] = llaunches[kernel]

    with Phase("sell_kernel_times") as f:
        ltimes = sell_kernel_times(torch, sell_prob.operand, sell_coo, lerrs)
        f.update(card=card, nvidia_smi=smi, times=ltimes, max_abs_err=lerrs)
    del sell_prob

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
    })
    for name, point, replaces in (
            ("spmm_band", "band float32 m=128", "sparseharness_tpu/ops/pallas_bsr_band.py:334"),
            ("spmm_tiles", "blocked plus_times m=128", "sparseharness_tpu/ops/spmm_tiles.py:130")):
        t = stimes[point]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"sparseharness_tpu_torch/ops/csrc/{name}.cu", "replaces": replaces,
            "launches": launches[name], "max_abs_err": serrs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    for name, line in (("sell_phase_a", 330), ("sell_level", 361)):
        t = ltimes[name]
        kernels.append({
            "name": name, "route": "cuda", "source": "sparseharness_tpu_torch/ops/csrc/sell.cu",
            "replaces": f"sparseharness_tpu/ops/pallas_sell.py:{line}",
            "launches": launches[name], "max_abs_err": lerrs[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": ltimes["library_ms"],
        })
    emit({"kernels": kernels})
    print(nvidia_smi())
    emit({"ok": True, "device": {"platform": "gpu", "kind": card,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Compare thread maps of the port's spmm_tiles kernel on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/probe_spmm_tiles_cuda.py

The maps, each forced through the probe's own C entry ``sh_spmm_tiles_map``
whatever m is:

- ``tiles``: the kernel's tile map (csrc/spmm_tiles.cu), one block per
  (block-row, column tile), the slot's tile and X rows staged in shared
  memory, a thread to one column and 4 rows (at bm = 8 and m = 8, 16 of a
  block's 256 threads compute);
- ``one_s1`` (candidate a): a thread to one output, its slots in order, the
  strip row read straight from device memory with 4-slot loads, 8 of them
  in flight, one X value a slot (this probe's own kernel, PROBE_SOURCE);
- ``one_s2``, ``one_s4`` (candidate b): the same with each output's slots
  split over 2 or 4 lanes, folded by xor shuffles;
- ``rows_s8``, ``rows_s4``, ``rows_s2``: the kernel's row map, a thread to
  8 rows of one block-row and 8 columns, the slots split over 8, 4 or 2
  lanes (the kernel takes 8 up to m = 8 and 4 above).

The probe source (PROBE_SOURCE) includes csrc/spmm_tiles.cu and is built
with one nvcc, for plus_times, min_plus and or_and only.

Shapes: the band-routed multi-source solves' operand,
ell_operand_from_band of banded_coo(1 << 16, 63, seed=1) (strips (8192, 8,
384), K = 3) at m = 8 in min_plus, or_and and plus_times; and the blocked
matrix, bsr_ell of block_random_coo(131072, 2, bm=8, bn=128, seed=5), in
plus_times at m = 8, 16, 32, 64 and 128. Each map is first checked against
spmm_tiles_plain (bit for bit, plus_times within 1e-5 · max(1, |plain|,
Σ|a·x|)), then the maps are timed in turns (each in order, then again in
reverse; CUDA events, the median of five 20-call windows each turn) beside
the bound: the larger of the bytes these inputs need over the card's
memory rate and 2 operations per nonzero per column over 67 TFLOP/s. The
bytes are tile_cols, X and Y once and, of the strips, the band's values in
each row's occupied span (its pads' products are ⊕ identities, or for
plus_times come from X alone) and every slot of the blocked matrix's full
tiles; ``layout_bound_ms`` counts every strip slot. A map that cannot take
a shape prints null. Last, the band-routed solves themselves (multi_sssp
and multi_bfs from chip_smoke.py's 8 roots, variant "bsr_band"), with the
kernel's shipped map and with the tile map forced, in turns: ms a step on
the host's clock, and from torch.profiler over one more solve the
device's busy ms a step, spmm_tiles' ms a step and the device's idle
share. The card's name and power limit come first, from nvidia-smi, then
one JSON line a shape and one a solve. Imports only the port. About a
minute and a half of command.
"""

import ctypes
import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

F32_PEAK_OPS = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
#: map name -> (kernel, lanes an output); None for the tile map. Its
#: position is the map's code in sh_spmm_tiles_map.
MAPS = {"tiles": None, "one_s1": ("one", 1), "one_s2": ("one", 2), "one_s4": ("one", 4),
        "rows_s8": ("rows", 8), "rows_s4": ("rows", 4), "rows_s2": ("rows", 2)}
BLOCKED_M = (8, 16, 32, 64, 128)

PROBE_SOURCE = r"""
#include "spmm_tiles.cu"

namespace {

// Candidates (a) and (b): a thread to one output (row, column), its 4-slot
// chunks split over SPLIT adjacent lanes (every SPLIT-th chunk of a tile,
// in order), 8 chunks of its strip row loaded before any is used, one X
// value a slot; the lanes fold with xor shuffles.
template <int SR, typename S, int SPLIT>
__global__ void __launch_bounds__(kThreads, 2)
one_output_kernel(const S* __restrict__ strips, const int* __restrict__ cols,
                  const typename Op<SR>::T* __restrict__ x,
                  typename Op<SR>::T* __restrict__ out, int64_t n_rows, int bm, int kbn,
                  int bn, int k, int m, int groups_per_block, int c_blocks) {
  using O = Op<SR>;
  using T = typename O::T;
  constexpr int U = 8;  // chunks in flight
  const int local = threadIdx.x / (m * SPLIT);
  const int within = threadIdx.x - local * m * SPLIT;
  const int s = within % SPLIT;
  const int col = within / SPLIT;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * groups_per_block + local;
  const bool live = local < groups_per_block && row < n_rows;
  T acc = O::identity();
  if (live) {
    const int64_t r = row / bm;
    const int n_chunks = bn / 4;
    for (int kk = 0; kk < k; ++kk) {
      const int xb = min(max(__ldg(cols + r * k + kk), 0), c_blocks - 1);
      const T* xt = x + static_cast<int64_t>(xb) * bn * m + col;
      const S* st = strips + row * kbn + kk * bn;
      for (int q0 = s; q0 < n_chunks; q0 += U * SPLIT) {
        T a[U][4];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (q0 + u * SPLIT < n_chunks) load_strip4(st + (q0 + u * SPLIT) * 4, a[u]);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int q = q0 + u * SPLIT;
          if (q < n_chunks) {
#pragma unroll
            for (int w = 0; w < 4; ++w)
              acc = O::add(acc, O::mul(__ldg(xt + static_cast<int64_t>(q * 4 + w) * m), a[u][w]));
          }
        }
      }
    }
  }
#pragma unroll
  for (int d = 1; d < SPLIT; d <<= 1) acc = O::add(acc, __shfl_xor_sync(0xffffffffu, acc, d));
  if (live && s == 0) out[row * m + col] = acc;
}

template <int SPLIT>
struct OneLaunch {
  Args a;

  template <int SR, typename S>
  int run() const {
    using T = typename Op<SR>::T;
    const int groups_per_block = kThreads / (a.m * SPLIT);
    const int64_t n_rows = a.r_blocks * a.bm;
    one_output_kernel<SR, S, SPLIT>
        <<<static_cast<unsigned>((n_rows + groups_per_block - 1) / groups_per_block),
           kThreads, 0, a.stream>>>(
            static_cast<const S*>(a.strips), a.cols, static_cast<const T*>(a.x),
            static_cast<T*>(a.out), n_rows, a.bm, a.kbn, a.kbn / a.k, a.k, a.m,
            groups_per_block, a.c_blocks);
    return cudaSuccess;
  }
};

template <typename L>
int probe_dispatch(int semiring, const L& launch) {
  switch (semiring) {
    case PLUS_TIMES: return launch.template run<PLUS_TIMES, float>();
    case MIN_PLUS: return launch.template run<MIN_PLUS, float>();
    case OR_AND: return launch.template run<OR_AND, int>();
    default: return cudaErrorInvalidValue;
  }
}

template <int SPLIT>
int probe_one(const Args& a, int semiring) {
  if ((a.kbn / a.k) % 4 != 0 || reinterpret_cast<uintptr_t>(a.strips) % 16 != 0 ||
      a.m * SPLIT > kThreads)
    return cudaErrorInvalidValue;
  return probe_dispatch(semiring, OneLaunch<SPLIT>{a});
}

template <int SPLIT>
int probe_rows(const Args& a, int semiring) {
  RowsLaunch<SPLIT> launch;
  const int rc = rows_launch(a, STRIP_F32, &launch);
  return rc != cudaSuccess ? rc : probe_dispatch(semiring, launch);
}

}  // namespace

// sh_spmm_tiles with the map forced: 0 the tile map, i > 0 MAPS' entry i.
// f32 strips for plus_times and min_plus, int32 for or_and.
extern "C" int sh_spmm_tiles_map(int device, const void* strips, const void* cols,
                                 const void* x, void* out, long long r_blocks, int bm,
                                 int kbn, int k, int m, int c_blocks, int semiring, int map,
                                 void* stream) {
  const Args a{strips, static_cast<const int*>(cols), x, out, r_blocks, bm, kbn, k, m,
               c_blocks, static_cast<cudaStream_t>(stream)};
  bool done;
  int rc = check_args(a, &done);
  if (rc != cudaSuccess || done) return rc;
  rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  switch (map) {
    case 0: {
      TilesLaunch launch;
      rc = tiles_launch(a, &launch);
      if (rc == cudaSuccess) rc = probe_dispatch(semiring, launch);
      break;
    }
@CASES@
    default: rc = cudaErrorInvalidValue;
  }
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}
""".replace("@CASES@", "\n".join(
    f"    case {i}: rc = probe_{v[0]}<{v[1]}>(a, semiring); break;"
    for i, v in enumerate(MAPS.values()) if v))


def windows_ms(torch, fn, windows: int = 5, n: int = 20) -> float:
    fn()
    fn()
    out = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end) / n)
    return float(np.median(out))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def build_probe():
    """PROBE_SOURCE with one nvcc into build/probe_spmm_tiles/<digest>/; the
    loaded library."""
    from sparseharness_tpu_torch.ops import _build

    csrc = str(_build.CSRC)
    digest = hashlib.sha256((_build._digest() + PROBE_SOURCE).encode()).hexdigest()[:16]
    out_dir = os.path.join(ROOT, "build", "probe_spmm_tiles", digest)
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "spmm_tiles_probe.cu")
    lib = os.path.join(out_dir, "libspmm_tiles_probe.so")
    with open(src, "w") as f:
        f.write(PROBE_SOURCE)
    if not os.path.exists(lib):
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", lib, src],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the spmm_tiles probe:\n{log}")
        regs, entry = {}, None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1][:90]
            elif "Used " in line and entry is not None:
                regs[entry] = line.split("Used ")[1].strip()
        emit({"ptxas": regs, "spills": [ln.strip() for ln in log.splitlines()
                                        if "bytes spill" in ln and " 0 bytes spill" not in ln]})
    return ctypes.CDLL(lib)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_spmm_tiles_cuda: no CUDA device is available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from sparseharness_tpu_torch.algorithms import multi_bfs, multi_sssp
    from sparseharness_tpu_torch.formats import banded_coo, block_random_coo
    from sparseharness_tpu_torch.harness import device_hbm_bandwidth
    from sparseharness_tpu_torch.ops import _build, build_operand, spmm_tiles
    from sparseharness_tpu_torch.semiring import MIN_PLUS, OR_AND, PLUS_TIMES

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip(), flush=True)
    bw = device_hbm_bandwidth(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    lib = build_probe()
    emit({"build_seconds": time.perf_counter() - t0})
    fn = lib.sh_spmm_tiles_map
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(43)

    def x_block(sr, n, m):
        u = torch.rand((n, m), generator=gen, device="cuda")
        if sr.dtype == torch.bool:
            return u < 0.3
        return u * 0.9 + 0.1

    def caller(code, op, x2d, sr, out):
        r_blocks, bm, kbn = op.tiles.shape
        k = op.tile_cols.shape[1]
        args = (op.tiles.device.index, op.tiles.data_ptr(), op.tile_cols.data_ptr(),
                x2d.data_ptr(), out.data_ptr(), r_blocks, bm, kbn, k, x2d.shape[1],
                x2d.shape[0] // (kbn // k), _build.SR_CODES[sr.name], code, stream)

        def call():
            rc = fn(*args)
            if rc:
                raise RuntimeError(f"map {code} launch failed: {rc}")
        return call

    def shape(label, op, sr, m, n_cols, nnz, strip_bytes=None):
        """Check every map that takes the shape, time them in turns and
        print one line. ``strip_bytes``: the strip bytes the product needs,
        every slot when None."""
        bn = op.tiles.shape[2] // op.tile_cols.shape[1]
        x2d = spmm_tiles.pad_x_block(x_block(sr, n_cols, m), bn, sr)
        ref = spmm_tiles.spmm_tiles_plain(op.tiles, op.tile_cols, x2d, sr)
        tol = None
        if sr is PLUS_TIMES:  # values and X are positive: Σ|a·x| is the sum itself
            tol = 1e-5 * torch.clamp(ref.abs(), min=1.0)
        out = torch.empty_like(ref)
        calls = {}
        for code, name in enumerate(MAPS):
            if out.dtype == torch.int32:
                out.fill_(-7)
            else:
                out.fill_(float("nan"))
            call = caller(code, op, x2d, sr, out)
            try:
                call()
            except RuntimeError:
                continue  # this map cannot take the shape
            torch.cuda.synchronize()
            ok = (bool(((out - ref).abs() <= tol).all()) if tol is not None
                  else torch.equal(out, ref))
            if not ok:
                raise AssertionError(f"{label} m={m}: {name} differs from the plain version")
            calls[name] = call
        ms = {name: [] for name in calls}
        for name in list(calls) + list(calls)[::-1]:
            ms[name].append(windows_ms(torch, calls[name]))
        slots = op.tiles.numel() * op.tiles.element_size()
        rest = (op.tile_cols.numel() * 4 + x2d.numel() * x2d.element_size()
                + ref.numel() * ref.element_size())
        n_bytes = (slots if strip_bytes is None else strip_bytes) + rest
        bytes_ms, ops_ms = n_bytes / bw * 1e3, 2 * nnz * m / F32_PEAK_OPS * 1e3
        emit({"shape": label, "semiring": sr.name, "m": m,
              "tiles": list(op.tiles.shape), "bound_ms": max(bytes_ms, ops_ms),
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
              "layout_bound_ms": max((slots + rest) / bw * 1e3, ops_ms),
              "median_ms": {name: (float(np.median(ms[name])) if name in ms else None)
                            for name in MAPS},
              "turns_ms": ms})

    band = banded_coo(1 << 16, 63, seed=1)
    for sr in (MIN_PLUS, OR_AND, PLUS_TIMES):
        bop = build_operand(band, sr, "bsr_band")
        shape("band", spmm_tiles.ell_operand_from_band(bop), sr, 8, band.shape[1], band.nnz,
              strip_bytes=bop.spans.lanes * bop.strips.element_size())
        del bop
    bcoo = block_random_coo(131072, 2, bm=8, bn=128, seed=5)
    op = build_operand(bcoo, PLUS_TIMES, "bsr_ell")
    for m in BLOCKED_M:
        shape("blocked", op, PLUS_TIMES, m, bcoo.shape[1], bcoo.nnz)
    del op, bcoo

    shipped = spmm_tiles.spmm_tiles_cuda

    def tile_map(tiles, tile_cols, x2d, sr):
        out = torch.empty((tiles.shape[0] * tiles.shape[1], x2d.shape[1]),
                          dtype=x2d.dtype, device=x2d.device)
        caller(0, spmm_tiles.BsrEllOperand(tiles, tile_cols), x2d, sr, out)()
        return out

    roots = np.random.default_rng(29).choice(band.shape[0], 8, replace=False)
    for app in (multi_sssp, multi_bfs):
        for kernel in ("shipped", "tiles", "tiles", "shipped"):
            spmm_tiles.spmm_tiles_cuda = shipped if kernel == "shipped" else tile_map
            try:
                app(band, roots, variant="bsr_band")
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = app(band, roots, variant="bsr_band")
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3 / r.iterations
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    app(band, roots, variant="bsr_band")
                    torch.cuda.synchronize()
            finally:
                spmm_tiles.spmm_tiles_cuda = shipped
            busy = spmm = 0.0
            for evt in prof.key_averages():
                us = getattr(evt, "device_time_total", None) or getattr(evt, "cuda_time_total", 0)
                busy += us
                if "spmm_rows_kernel" in evt.key or "spmm_tiles_kernel" in evt.key:
                    spmm += us
            emit({"solve": app.__name__, "kernel": kernel, "steps": r.iterations,
                  "ms_per_step": wall, "device_busy_ms_per_step": busy / 1e3 / r.iterations,
                  "spmm_tiles_ms_per_step": spmm / 1e3 / r.iterations,
                  "device_idle_share": 1.0 - busy / 1e3 / r.iterations / wall})
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Compare designs of the port's sell level launch on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/probe_sell_levels_cuda.py

On sell's full-width band, banded_coo(1 << 18, 63, seed=1), in f32
plus_times, after the fused depth-0 launch (ops/sell.py:fused_cuda), the
later levels run as:

- ``shipped``: csrc/sell.cu's level launch as built (a block of 256
  threads per (slab, 32-lane slice), every later depth chained in shared
  memory, programmatic dependent launch behind the fused launch);
- ``no_pdl``: the same kernel launched without the PDL attribute;
- ``work_path``: the shipped launch with every slab on its work path
  (ops/sell.py:relevel(op, 0));
- ``per_depth``: the design it replaced, one launch per later depth of
  one 128-thread block per output row, each finding its entry by a
  binary search of the launch table (the work path's table carries what
  it reads);
- ``wait_only``: a kernel of the same grid that only waits for the fused
  launch: the least a dependent launch can cost.

The variants' entries are below (PROBE_SOURCE); it includes csrc/sell.cu
and is built with one nvcc. Each variant's dp is checked against
dp_sell_plain bit for bit, then 20 back-to-back dp calls are traced with
torch.profiler in turns (each variant in order, then again in reverse):
from the trace's kernel spans (chip_smoke.py's kernel_spans and
call_metrics), per call, the fused launch's device ms (``first_ms``), the
level launches' (``rest_ms``, from their first start to their last end),
how far the last level kernel ends past the fused launch's end
(``tail_ms``), the gap to the next call's fused launch, and the whole
call from the fused launch's start to the next one's; and the level
launches alone, back to back. Last, a copy of the shipped kernel with per-block stamps
(``%globaltimer`` and ``clock64`` at its phases, made from the kernel's
text by stamped_kernel()) runs behind the fused launch: when each block
started against the wait's release, and each phase's cycles. The card's
name and power limit come first, from nvidia-smi. Imports only the port
and chip_smoke.py's trace helpers.
About a minute of command.
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

from chip_smoke import call_metrics, kernel_spans  # noqa: E402

PROBE_SOURCE = r"""
#include "sell.cu"

namespace {

template <int SR>
__global__ void __launch_bounds__(kLanes)
per_depth_kernel(const int* __restrict__ table, int e0, int n_entries,
                 const int* __restrict__ idx, typename Op<SR>::T* work,
                 typename Op<SR>::T* __restrict__ dp) {
  using O = Op<SR>;
  using T = typename O::T;
  const int b = blockIdx.x;
  int lo = e0, hi = e0 + n_entries - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(table + static_cast<int64_t>(mid) * kEntryWords + ROW_BEGIN) <= b) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int* e = table + static_cast<int64_t>(lo) * kEntryWords;
  const int r = b - __ldg(e + ROW_BEGIN);
  const int n_regions = __ldg(e + N_REGIONS);
  int k = 0;
  while (k + 1 < n_regions && r >= __ldg(e + REGIONS + 4 * k + 3)) ++k;
  const int w = __ldg(e + REGIONS + 4 * k);
  const int s0 = __ldg(e + REGIONS + 4 * k + 1);
  const int q = r - __ldg(e + REGIONS + 4 * k + 2);
  const int j = threadIdx.x;
  const int src_rows = __ldg(e + SRC_ROWS);
  const T* src = work + static_cast<int64_t>(__ldg(e + SRC_OFF)) * kLanes + j;
  const int* ix = idx + (static_cast<int64_t>(__ldg(e + IDX_OFF)) + s0
                         + static_cast<int64_t>(q) * w) * kLanes + j;
  int row = __ldcs(ix);
  T acc = row < src_rows ? src[static_cast<int64_t>(row) * kLanes] : O::zero();
  for (int t = 1; t < w; ++t) {
    row = __ldcs(ix + static_cast<int64_t>(t) * kLanes);
    acc = O::add(acc, row < src_rows ? src[static_cast<int64_t>(row) * kLanes] : O::zero());
  }
  T* out = __ldg(e + FINAL) ? dp : work;
  out[(static_cast<int64_t>(__ldg(e + OUT_OFF)) + r) * kLanes + j] = acc;
}

// per-block timestamps: the global timer (ns) at slot k, the SM's clock at
// slot 8 + k
__device__ __forceinline__ void stamp(unsigned long long* st, int k) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  st[k] = t;
  st[8 + k] = clock64();
}

// csrc/sell.cu's level kernel with thread 0 of each block stamping: start
// (0), table entries read (1), idx staged (2), past the wait (3), level-0
// rows staged (4), then the end of each depth (5, 6, 7); made from the
// kernel's text by stamped_kernel()
@STAMPED@

// the dependent launch's least cost: the same grid, which only waits
__global__ void __launch_bounds__(kThreads) wait_only_kernel() { grid_dependency_wait(); }

int launch_levels(const int* chains, const int* table, const int* idx, float* work, float* dp,
                  int n_chains, int level_rows, cudaStream_t stream, int pdl) {
  const size_t smem = static_cast<size_t>(level_rows) * kGroupLanes * 4;
  if (smem > 48 * 1024) {
    const int rc = cudaFuncSetAttribute(sell_level_kernel<PLUS_TIMES>,
                                        cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(n_chains * kSlices));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = pdl ? 1 : 0;
  return cudaLaunchKernelEx(&config, sell_level_kernel<PLUS_TIMES>, chains, table, idx, work,
                            dp);
}

int launch_wait_only(int n_chains, cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(n_chains * kSlices));
  config.blockDim = dim3(kThreads);
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, wait_only_kernel);
}

int launch_stamped(const int* chains, const int* table, const int* idx, float* work,
                   float* dp, int n_chains, int level_rows, unsigned long long* stamps,
                   cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned>(n_chains * kSlices));
  config.blockDim = dim3(kThreads);
  config.dynamicSmemBytes = static_cast<size_t>(level_rows) * kGroupLanes * 4;
  config.stream = stream;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, stamped_level_kernel<PLUS_TIMES>, stamps, chains, table,
                            idx, work, dp);
}

}  // namespace

extern "C" {

// the shipped level launch with per-block timestamps into stamps (16 a block)
int probe_stamped(const void* chains, const void* table, const void* idx, void* work,
                  void* dp, int n_chains, int level_rows, void* stamps, void* stream) {
  const int rc = launch_stamped(static_cast<const int*>(chains), static_cast<const int*>(table),
                                static_cast<const int*>(idx), static_cast<float*>(work),
                                static_cast<float*>(dp), n_chains, level_rows,
                                static_cast<unsigned long long*>(stamps),
                                static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}


// the shipped level kernel (plus_times, f32), with or without the PDL
// attribute; kind 0: the kernel that only waits
int probe_levels(const void* chains, const void* table, const void* idx, void* work,
                 void* dp, int n_chains, int level_rows, int kind, int pdl, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int rc = kind == 0
                     ? launch_wait_only(n_chains, s)
                     : launch_levels(static_cast<const int*>(chains),
                                     static_cast<const int*>(table),
                                     static_cast<const int*>(idx), static_cast<float*>(work),
                                     static_cast<float*>(dp), n_chains, level_rows, s, pdl);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

// one depth of the replaced design: n_rows blocks over entries [e0, e0 + n)
int probe_per_depth(const void* table, const void* idx, void* work, void* dp, int e0,
                    int n_entries, int n_rows, void* stream) {
  per_depth_kernel<PLUS_TIMES><<<n_rows, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(table), e0, n_entries, static_cast<const int*>(idx),
      static_cast<float*>(work), static_cast<float*>(dp));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
"""

#: (text of csrc/sell.cu's level kernel, what the stamped copy has there)
STAMPS = (
    ("template <int SR>\n__global__ void __launch_bounds__(kThreads, 4)\nsell_level_kernel(",
     "template <int SR>\n__global__ void __launch_bounds__(kThreads, 4)\n"
     "stamped_level_kernel(unsigned long long* __restrict__ stamps, "),
    ("  const int* c = chains +",
     "  unsigned long long* st = stamps + static_cast<int64_t>(blockIdx.x) * 16;\n"
     "  if (threadIdx.x == 0) stamp(st, 0);\n  const int* c = chains +"),
    ("    idx_base[n_later] = base;\n  }\n  __syncthreads();",
     "    idx_base[n_later] = base;\n  }\n  __syncthreads();\n"
     "  if (threadIdx.x == 0) stamp(st, 1);"),
    ("  grid_dependency_wait();\n",
     "  __syncthreads();\n  if (threadIdx.x == 0) stamp(st, 2);\n  grid_dependency_wait();\n"
     "  if (threadIdx.x == 0) stamp(st, 3);\n"),
    ("  __syncthreads();\n  const int lane = threadIdx.x & 31;",
     "  __syncthreads();\n  if (threadIdx.x == 0) stamp(st, 4);\n"
     "  const int lane = threadIdx.x & 31;"),
    ("    if (d + 1 < n_later) __syncthreads();\n  }\n}",
     "    if (d + 1 < n_later) __syncthreads();\n"
     "    if (threadIdx.x == 0) stamp(st, min(5 + d, 7));\n  }\n}"),
)

VARIANTS = ("shipped", "no_pdl", "work_path", "per_depth", "wait_only")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def stamped_kernel(sell_cu: str) -> str:
    """The level kernel's text from csrc/sell.cu, renamed and with STAMPS
    applied; raises when the kernel no longer has a stamp's anchor."""
    kernel = sell_cu[sell_cu.index(STAMPS[0][0]):sell_cu.index("struct FusedLaunch")]
    for anchor, stamped in STAMPS:
        if kernel.count(anchor) != 1:
            raise RuntimeError(f"sell.cu's level kernel changed: no single {anchor!r}")
        kernel = kernel.replace(anchor, stamped)
    return kernel


def build_probe():
    """PROBE_SOURCE with the stamped kernel, with one nvcc into
    build/probe_sell_levels/<digest>/; the loaded library."""
    from sparseharness_tpu_torch.ops import _build

    csrc = str(_build.CSRC)
    source = PROBE_SOURCE.replace("@STAMPED@", stamped_kernel(
        (_build.CSRC / "sell.cu").read_text()))
    digest = hashlib.sha256((_build._digest() + source).encode()).hexdigest()[:16]
    out_dir = os.path.join(ROOT, "build", "probe_sell_levels", digest)
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "sell_levels_probe.cu")
    lib = os.path.join(out_dir, "libsell_levels_probe.so")
    with open(src, "w") as f:
        f.write(source)
    if not os.path.exists(lib):
        t0 = time.perf_counter()
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", lib, src],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the sell levels probe:\n{log}")
        used, name = [], ""
        for line in log.splitlines():
            if "Compiling entry function" in line:
                name = line.split("'")[1]
            elif "Used " in line and ("level_kernel" in name or "per_depth" in name):
                used.append(f"{name[-60:]}: {line.split('Used ')[1]}")
            elif "spill" in line and "level_kernel" in name and " 0 bytes spill stores" not in line:
                used.append(f"{name[-60:]}: {line.strip()}")
        emit({"build_seconds": time.perf_counter() - t0, "ptxas": used[:40]})
    lib = ctypes.CDLL(lib)
    lib.probe_levels.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.probe_per_depth.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.probe_stamped.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
    lib.probe_levels.restype = lib.probe_per_depth.restype = ctypes.c_int
    lib.probe_stamped.restype = ctypes.c_int
    return lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_sell_levels_cuda: no CUDA device is available", file=sys.stderr)
        return 1
    from sparseharness_tpu_torch.formats import banded_coo
    from sparseharness_tpu_torch.ops import _build, sell
    from sparseharness_tpu_torch.semiring import PLUS_TIMES

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib = build_probe()
    sr = PLUS_TIMES
    coo = banded_coo(1 << 18, 63, seed=1)
    op = sell.build_sell(coo, sr, device="cuda")
    work_op = sell.relevel(op, 0)
    x = torch.from_numpy(np.random.default_rng(16).uniform(0.1, 1.0, coo.shape[1])
                         .astype(np.float32)).cuda()
    x2d = sell.pad_x2d(op, x, sr)
    ref = sell.dp_sell_plain(op, x, sr, n_rows=coo.shape[0])
    stream = torch.cuda.current_stream().cuda_stream

    def levels(variant, lop, work, dp):
        if variant == "per_depth":
            for d in range(1, len(lop.depth_rows)):
                e0, e1 = lop.depth_entries[d], lop.depth_entries[d + 1]
                _build.check_launch("sell", lib.probe_per_depth(
                    lop.table.data_ptr(), lop.idx.data_ptr(), work.data_ptr(), dp.data_ptr(),
                    e0, e1 - e0, lop.depth_rows[d], stream))
            return
        _build.check_launch("sell", lib.probe_levels(
            lop.chains.data_ptr(), lop.table.data_ptr(), lop.idx.data_ptr(), work.data_ptr(),
            dp.data_ptr(), lop.chains.shape[0], lop.level_rows, int(variant != "wait_only"),
            int(variant != "no_pdl"), stream))

    def dp_call(variant):
        lop = work_op if variant in ("work_path", "per_depth") else op
        work = torch.empty((lop.work_rows, 128), dtype=torch.float32, device="cuda")
        dp = torch.empty(lop.n_pad, dtype=torch.float32, device="cuda")
        sell.fused_cuda(lop, x2d, sr, work, dp)
        levels(variant, lop, work, dp)
        return dp, work, lop

    rows = {}
    for v in VARIANTS:
        got = dp_call(v)[0]
        torch.cuda.synchronize()
        if v != "wait_only" and not torch.equal(got.view(torch.int32), ref.view(torch.int32)):
            raise AssertionError(f"{v}: dp != dp_sell_plain")
        rows[v] = {"variant": v, "calls": [], "alone": []}
    for v in list(VARIANTS) + list(reversed(VARIANTS)):
        rows[v]["calls"].append(call_metrics(kernel_spans(torch, lambda: dp_call(v)),
                                              "sell_fused"))
        _, work, lop = dp_call(v)
        dp = torch.empty(lop.n_pad, dtype=torch.float32, device="cuda")
        spans = kernel_spans(torch, lambda: levels(v, lop, work, dp))
        per_launch = [(s[2] - s[1]) / 1e3 for s in spans]
        rows[v]["alone"].append(float(np.median(per_launch)) * (2 if v == "per_depth" else 1))
    for row in rows.values():
        emit(row)

    # the shipped launch's phases, block by block, after a fused launch (the
    # band's slabs have two depths past 0: stamps 0 to 6)
    stamps = torch.zeros((op.chains.shape[0] * 4, 16), dtype=torch.int64, device="cuda")
    for _ in range(5):
        work = torch.empty((op.work_rows, 128), dtype=torch.float32, device="cuda")
        dp = torch.empty(op.n_pad, dtype=torch.float32, device="cuda")
        sell.fused_cuda(op, x2d, sr, work, dp)
        _build.check_launch("sell", lib.probe_stamped(
            op.chains.data_ptr(), op.table.data_ptr(), op.idx.data_ptr(), work.data_ptr(),
            dp.data_ptr(), op.chains.shape[0], op.level_rows, stamps.data_ptr(), stream))
        torch.cuda.synchronize()
    if not torch.equal(dp.view(torch.int32), ref.view(torch.int32)):
        raise AssertionError("stamped: dp != dp_sell_plain")
    st = stamps.cpu().numpy().astype(np.int64)
    ns, clk = st[:, :8], st[:, 8:]
    release = ns[:, 3].min()
    names = ["table", "stage", "wait", "level0", "depth1", "depth2"]
    emit({"stamped_blocks": len(st),
          "started_after_release": int((ns[:, 0] > release).sum()),
          "release_spread_us": float(ns[:, 3].max() - release) / 1e3,
          "post_wait_span_us": float(ns[:, 6].max() - release) / 1e3,
          "end_after_release_us": [float(np.percentile(ns[:, 6] - release, q)) / 1e3
                                   for q in (0, 50, 90, 100)],
          "start_before_release_us": [float(np.percentile(release - ns[:, 0], q)) / 1e3
                                      for q in (0, 50, 100)],
          "phase_cycles_median": {n: float(np.median(clk[:, i + 1] - clk[:, i]))
                                  for i, n in enumerate(names)},
          "phase_cycles_max": {n: float(np.max(clk[:, i + 1] - clk[:, i]))
                               for i, n in enumerate(names)}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

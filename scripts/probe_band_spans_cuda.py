#!/usr/bin/env python3
"""Compare designs of the port's bsr_band span kernel on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/probe_band_spans_cuda.py

Both designs read only each row's occupied span of the strips
(ops/bsr_band.py:band_spans) and take the pads' products from scans of the
x window (csrc/bsr_band.cu):

- ``registers``: the kernel of csrc/bsr_band.cu, where L lanes take a row
  and each lane issues its 16-byte loads (5 chunks) before it uses any.
  ``auto`` is its C interface as shipped (L by the source's rule from the
  longest span); ``lanes4`` to ``lanes32`` force L = 4, 8, 16 and 32 (a
  warp a row) on the same kernel template, staged path;
- ``bulk``: one lane of each warp copies each row's span with one
  cp.async.bulk (L2 evict-first) into a ring of SLOTS row buffers in
  shared memory, an mbarrier a slot, and the warp reduces from there,
  staged path only, at SLOTS = 2 and 4.

The forced-L entry and the bulk kernel are below (PROBE_SOURCE); it
includes csrc/bsr_band.cu for the kernel template, the set-up, the pad
scans and the semirings, and is built with one nvcc.

On bench.py's band, banded_coo(1 << 19, 63, seed=1), in plus_times with
f32 and bf16 strips, it builds the operand, checks every variant against
band_dp_plain (plus_times' tolerance) and against the shipped kernel in
min_plus (bit for bit), then times each (CUDA events, the median of five
20-call windows, the variants in turns: each in order, then again in
reverse) beside the bound of the least traffic (variant_bytes) and the
bytes by design (band_traffic). Then the streamed path, torch.mv on a CSR
tensor of the same matrix, and the layout's bound (every strip slot).
Last, on the wider bands banded_coo(1 << 17, b, seed=1) for b in
WIDE_BANDS (spans of 64–65 and 128–129 f32 chunks), the register variants
alone in the same way: whether L above 8 pays on long spans. The card's
name and power limit come first, from nvidia-smi. Imports only the port.
About a minute and a half of command.
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

HBM_BPS = 3.35e12  # H100 SXM device memory (data sheet)
SLOTS = (2, 4)
#: the register variants: the shipped rule, then L forced
REG_VARIANTS = ("auto", "lanes4", "lanes8", "lanes16", "lanes32")
#: half-widths of the wider bands, at WIDE_N rows
WIDE_BANDS = (127, 255)
WIDE_N = 1 << 17

PROBE_SOURCE = r"""
#include "bsr_band.cu"

namespace {

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n .reg .pred p;\n"
                 " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 " selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// The staged set-up of band_span_kernel, then each warp's rows
// warp, warp + 8, ... through a ring of SLOTS buffers of slot_bytes.
template <int SR, typename S, int SLOTS>
__global__ void __launch_bounds__(kThreads)
band_bulk_kernel(const S* __restrict__ strips, const typename Op<SR>::T* __restrict__ x,
                 const unsigned* __restrict__ spans, typename Op<SR>::T* __restrict__ out,
                 int rows_per_group, int kbn, int bn, int k, int c0, int c_blocks,
                 typename Op<SR>::T pad, int slot_bytes) {
  using B = Ieee<SR>;
  using T = typename B::T;
  constexpr int N = Chunk<S>::N;
  const int nc = kbn / N;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* pre = xs + kbn;
  T* suf = pre + nc + 1;
  unsigned* span = reinterpret_cast<unsigned*>(suf + nc + 1);
  const size_t head = (sizeof(T) * (kbn + 2 * (nc + 1)) + 4 * rows_per_group + 15) & ~size_t(15);
  unsigned char* ring = smem + head;
  uint64_t* bars = reinterpret_cast<uint64_t*>(ring + size_t(kWarps) * SLOTS * slot_bytes);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = blockIdx.x;
  const int w0 = min(max(g + c0, 0), max(c_blocks - k, 0));
  const T* xwin = x + static_cast<int64_t>(w0) * bn;
  const int64_t row0 = static_cast<int64_t>(g) * rows_per_group;
  for (int i = threadIdx.x * 4; i < kbn; i += kThreads * 4) {
    T v[4];
    load_x4<false>(xwin + i, v);
    xs[i] = v[0]; xs[i + 1] = v[1]; xs[i + 2] = v[2]; xs[i + 3] = v[3];
  }
  for (int i = threadIdx.x; i < rows_per_group; i += kThreads) span[i] = spans[row0 + i];
  if (lane == 0) {
    for (int s = 0; s < SLOTS; ++s) {
      const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(bars + warp * SLOTS + s));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(b) : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  pad_scans<SR, true, N>(xs, nc, pad, pre, suf);
  __syncthreads();

  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  const S* gstrips = strips + row0 * kbn;
  const int n_mine = warp < rows_per_group ? (rows_per_group - warp + kWarps - 1) / kWarps : 0;
  auto issue = [&](int j) {
    const int r = warp + j * kWarps;
    const unsigned sp = span[r];
    const int lo = sp & 0xffff, len = static_cast<int>(sp >> 16) - lo;
    if (len <= 0) return;
    const int s = j % SLOTS;
    const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(bars + warp * SLOTS + s));
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(
        ring + (size_t(warp) * SLOTS + s) * slot_bytes));
    const S* src = gstrips + static_cast<int64_t>(r) * kbn + lo * N;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(b), "r"(len * 16) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n"
                 :: "r"(dst), "l"(src), "r"(len * 16), "r"(b), "l"(policy) : "memory");
  };
  if (lane == 0)
    for (int j = 0; j < min(SLOTS, n_mine); ++j) issue(j);
  unsigned phases = 0;
  for (int j = 0; j < n_mine; ++j) {
    const int r = warp + j * kWarps;
    const unsigned sp = span[r];
    const int lo = sp & 0xffff, len = static_cast<int>(sp >> 16) - lo;
    const int s = j % SLOTS;
    T acc = B::identity();
    if (len > 0) {
      mbar_wait(static_cast<uint32_t>(__cvta_generic_to_shared(bars + warp * SLOTS + s)),
                (phases >> s) & 1u);
      phases ^= 1u << s;
      const uint4* slot = reinterpret_cast<const uint4*>(ring + (size_t(warp) * SLOTS + s) * slot_bytes);
      for (int c = lane; c < len; c += 32) {
        T a[N], xv[N];
        unpack(slot[c], a, static_cast<const S*>(nullptr));
        load_xn<true>(xs + (lo + c) * N, xv);
#pragma unroll
        for (int q = 0; q < N; ++q) acc = B::add(acc, B::mul(xv[q], a[q]));
      }
    }
    acc = group_reduce<SR, 32>(acc);
    if (lane == 0) out[row0 + r] = B::add(B::add(acc, pre[lo]), suf[lo + len]);
    __syncwarp();
    if (lane == 0 && j + SLOTS < n_mine) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(j + SLOTS);
    }
  }
}

struct BulkLaunch {
  const void* strips;
  const void* x;
  const void* spans;
  void* out;
  int n_groups, rows_per_group, kbn, bn, k, c0, c_blocks, pad_bits, slots;
  cudaStream_t stream;

  template <int SR, typename S, int SLOTS>
  int launch() const {
    using T = typename Op<SR>::T;
    constexpr int N = Chunk<S>::N;
    T pad;
    std::memcpy(&pad, &pad_bits, sizeof(pad));
    const int nc = kbn / N;
    const int slot_bytes = (kbn * static_cast<int>(sizeof(S)) + 15) & ~15;
    const size_t head = (sizeof(T) * (kbn + 2 * (nc + 1)) + 4 * rows_per_group + 15) & ~size_t(15);
    const size_t smem = head + size_t(kWarps) * SLOTS * slot_bytes + 8 * kWarps * SLOTS;
    auto kernel = band_bulk_kernel<SR, S, SLOTS>;
    if (smem > 48 * 1024) {
      const int rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(smem));
      if (rc != cudaSuccess) return rc;
    }
    kernel<<<n_groups, kThreads, smem, stream>>>(
        static_cast<const S*>(strips), static_cast<const T*>(x),
        static_cast<const unsigned*>(spans), static_cast<T*>(out), rows_per_group, kbn, bn,
        k, c0, c_blocks, pad, slot_bytes);
    return cudaSuccess;
  }

  template <int SR, typename S>
  int run() const {
    if constexpr (SR == PLUS_TIMES || SR == MIN_PLUS) {
      return slots == 2 ? launch<SR, S, 2>() : launch<SR, S, 4>();
    } else {
      return cudaErrorInvalidValue;
    }
  }
};

// the shipped kernel template with L = row_lanes forced, staged path
struct LanesLaunch : BandLaunch {
  template <int SR, typename S>
  int run() const {
    switch (row_lanes) {
      case 4: return launch<SR, S, true, 4>();
      case 8: return launch<SR, S, true, 8>();
      case 16: return launch<SR, S, true, 16>();
      case 32: return launch<SR, S, true, 32>();
      default: return cudaErrorInvalidValue;
    }
  }
};

}  // namespace

extern "C" int sh_band_dp_lanes(int device, const void* strips, const void* x,
                                const void* spans, void* out, int r_rows, int bm, int kbn,
                                int k, int c0, int c_blocks, int semiring, int strip_dtype,
                                int pad_bits, int row_lanes, void* stream) {
  const int bn = kbn / k;
  const int gs = bn / bm;
  int rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  LanesLaunch launch;
  static_cast<BandLaunch&>(launch) = BandLaunch{
      strips, x, spans, out, r_rows / gs, gs * bm, kbn, bn, k, kbn, c0, c_blocks, row_lanes,
      true, pad_bits, static_cast<cudaStream_t>(stream)};
  rc = dispatch(semiring, strip_dtype, launch);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sh_band_dp_bulk(int device, const void* strips, const void* x,
                               const void* spans, void* out, int r_rows, int bm, int kbn,
                               int k, int c0, int c_blocks, int semiring, int strip_dtype,
                               int pad_bits, int slots, void* stream) {
  const int bn = kbn / k;
  const int gs = bn / bm;
  int rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  const BulkLaunch launch{strips, x, spans, out, r_rows / gs, gs * bm, kbn, bn, k, c0,
                          c_blocks, pad_bits, slots, static_cast<cudaStream_t>(stream)};
  rc = dispatch(semiring, strip_dtype, launch);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}
"""


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
    """PROBE_SOURCE with one nvcc into build/probe_band/<digest>/; the
    loaded library."""
    from sparseharness_tpu_torch.ops import _build

    csrc = str(_build.CSRC)
    digest = hashlib.sha256((_build._digest() + PROBE_SOURCE).encode()).hexdigest()[:16]
    out_dir = os.path.join(ROOT, "build", "probe_band", digest)
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "band_probe.cu")
    lib = os.path.join(out_dir, "libband_probe.so")
    with open(src, "w") as f:
        f.write(PROBE_SOURCE)
    if not os.path.exists(lib):
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc, "-o", lib, src],
                              capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the band probe:\n{log}")
        emit({"ptxas": [line.split("Used ")[1] for line in log.splitlines() if "Used " in line]})
    return ctypes.CDLL(lib)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_band_spans_cuda: no CUDA device is available", file=sys.stderr)
        return 1
    from sparseharness_tpu_torch.formats import banded_coo
    from sparseharness_tpu_torch.harness import variant_bytes
    from sparseharness_tpu_torch.ops import _build, bsr_band
    from sparseharness_tpu_torch.semiring import MIN_PLUS, PLUS_TIMES

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    lib = build_probe()
    emit({"build_seconds": time.perf_counter() - t0})
    stream = torch.cuda.current_stream().cuda_stream
    shipped = lib.sh_band_dp
    shipped.restype = ctypes.c_int
    shipped.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 12 + [
        ctypes.c_void_p]
    forced = {}
    for name in ("sh_band_dp_lanes", "sh_band_dp_bulk"):
        forced[name] = getattr(lib, name)
        forced[name].restype = ctypes.c_int
        forced[name].argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [
            ctypes.c_void_p]

    def caller(variant, op, x2d, sr, out):
        strips, spans = op.strips, op.spans
        common = (strips.device.index, strips.data_ptr(), x2d.data_ptr(),
                  spans.table.data_ptr(), out.data_ptr())
        r_rows, bm, kbn = strips.shape
        codes = (_build.SR_CODES[sr.name], _build.STRIP_CODES[strips.dtype])
        if variant == "auto":
            fn = shipped
            args = common + (r_rows, bm, kbn, op.k_win, op.k_win, op.c0, x2d.shape[0],
                             *codes, 1, spans.pad_bits, spans.max_chunks, stream)
        else:
            kind = variant.rstrip("0123456789")  # lanes<L> or bulk<SLOTS>
            count = int(variant[len(kind):])
            fn = forced[f"sh_band_dp_{kind}"]
            args = common + (r_rows, bm, kbn, op.k_win, op.c0, x2d.shape[0], *codes,
                             spans.pad_bits, count, stream)

        def call():
            rc = fn(*args)
            if rc:
                raise RuntimeError(f"{variant} launch failed: {rc}")
        return call

    def checked_calls(op, x2d, variants, mop=None):
        """Each variant's call on plus_times, checked against the plain
        version within its tolerance, and with ``mop`` in min_plus bit for
        bit against the shipped kernel."""
        ref = bsr_band.band_dp_plain(op.strips, x2d, PLUS_TIMES, c0=op.c0, k_win=op.k_win,
                                     kc=op.k_win)
        tol = 1e-5 * torch.clamp(ref.abs(), min=1.0)  # x and values are positive
        mref = None if mop is None else bsr_band.band_dp_cuda(
            mop.strips, x2d, MIN_PLUS, c0=mop.c0, k_win=mop.k_win, stage_x=True,
            kc=mop.k_win, spans=mop.spans)
        out = torch.empty_like(ref)
        calls = {}
        for v in variants:
            if mop is not None:
                out.fill_(float("nan"))
                caller(v, mop, x2d, MIN_PLUS, out)()
                torch.cuda.synchronize()
                if not torch.equal(out.view(torch.int32), mref.view(torch.int32)):
                    raise AssertionError(f"{v}: min_plus differs from the shipped kernel")
            out.fill_(float("nan"))
            calls[v] = caller(v, op, x2d, PLUS_TIMES, out)
            calls[v]()
            torch.cuda.synchronize()
            if not bool(((out - ref).abs() <= tol).all()):
                raise AssertionError(f"{v}: plus_times outside tolerance")
        return calls

    def in_turns(calls):
        """Each variant's window medians, in order and then in reverse."""
        ms = {v: [] for v in calls}
        for v in list(calls) + list(calls)[::-1]:
            ms[v].append(windows_ms(torch, calls[v]))
        return ms

    coo = banded_coo(1 << 19, 63, seed=1)
    n = coo.shape[0]
    x = torch.from_numpy(np.random.default_rng(11).uniform(0.1, 1.0, n)
                         .astype(np.float32)).cuda()
    variants = list(REG_VARIANTS) + [f"bulk{s}" for s in SLOTS]
    summary = {}
    for vd in ("float32", "bfloat16"):
        op = bsr_band.build_bsr_band(coo, PLUS_TIMES, value_dtype=vd, device="cuda")
        mop = bsr_band.build_bsr_band(coo, MIN_PLUS, value_dtype=vd, device="cuda")
        x2d = bsr_band.pad_x(op, x, PLUS_TIMES)
        ms = in_turns(checked_calls(op, x2d, variants, mop))
        least = variant_bytes("bsr_band", op, n * 4, n * 4)
        traffic = bsr_band.band_traffic(op)
        layout = op.strips.numel() * op.strips.element_size() + x2d.numel() * 4 + n * 4
        for v in variants:
            emit({"strips": vd, "variant": v, "ms": ms[v], "median_ms": float(np.median(ms[v])),
                  "bound_ms": least / HBM_BPS * 1e3,
                  "design_bound_ms": traffic["bytes"] / HBM_BPS * 1e3})
        streamed = windows_ms(torch, lambda: bsr_band.band_dp_cuda(
            op.strips, x2d, PLUS_TIMES, c0=op.c0, k_win=op.k_win, stage_x=False,
            kc=bsr_band.chunk_slots(op, False), spans=op.spans))
        summary[vd] = {"least_bytes": least, "design_bytes": traffic["bytes"],
                       "layout_bytes": layout, "layout_bound_ms": layout / HBM_BPS * 1e3,
                       "max_chunks": op.spans.max_chunks, "streamed_ms": streamed}
        del op, mop, x2d
    counts = np.bincount(coo.rows, minlength=n)
    crow = torch.from_numpy(np.concatenate([[0], np.cumsum(counts)]).astype(np.int32))
    order = np.lexsort((coo.cols, coo.rows))
    csr = torch.sparse_csr_tensor(crow, torch.from_numpy(coo.cols[order]),
                                  torch.from_numpy(coo.vals[order]), size=coo.shape).cuda()
    summary["torch_mv_ms"] = windows_ms(torch, lambda: torch.mv(csr, x))
    emit(summary)
    del coo, csr
    for band in WIDE_BANDS:
        coo = banded_coo(WIDE_N, band, seed=1)
        x = x[:WIDE_N]
        for vd in ("float32", "bfloat16"):
            op = bsr_band.build_bsr_band(coo, PLUS_TIMES, value_dtype=vd, device="cuda")
            x2d = bsr_band.pad_x(op, x, PLUS_TIMES)
            ms = in_turns(checked_calls(op, x2d, REG_VARIANTS))
            least = variant_bytes("bsr_band", op, WIDE_N * 4, WIDE_N * 4)
            for v in REG_VARIANTS:
                emit({"band": band, "rows": WIDE_N, "strips": vd, "k_win": op.k_win,
                      "max_chunks": op.spans.max_chunks, "variant": v, "ms": ms[v],
                      "median_ms": float(np.median(ms[v])),
                      "bound_ms": least / HBM_BPS * 1e3})
            del op, x2d
    return 0


if __name__ == "__main__":
    sys.exit(main())

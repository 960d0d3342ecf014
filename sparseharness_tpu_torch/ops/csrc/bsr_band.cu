// Banded semiring SpMV dp over bsr_band strips, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   STAGE_X = true   sparseharness_tpu/ops/pallas_bsr_band.py:dp_bsr_band
//                    (x resident: the block stages its x window in shared
//                    memory once);
//   STAGE_X = false  sparseharness_tpu/ops/pallas_bsr_band.py:_dp_windowed
//                    (x streamed: each warp reads x straight from global
//                    memory, through L1/L2, and keeps ⊕-partials at kc·bn
//                    window boundaries).
//
// What it computes, for every padded row R of the (r_rows, bm, K·bn) strips:
//   g  = R / (gs·bm), gs = bn / bm           (the row's group)
//   w0 = clamp(g + c0, 0, c_blocks − K)      (the group's first x block)
//   dp[R] = ⊕_{e < K·bn} mul(x[w0·bn + e], strip[R, e])
// The window of slot k lane l is x[(w0 + k)·bn + l] = x[w0·bn + k·bn + l],
// so a group's whole window is the contiguous slice x[w0·bn, w0·bn + K·bn).
//
// What bounds it: the bytes of the strips read from device memory. A band's
// strips are mostly pad: a row of banded_coo(n, 63) holds 127 values in a
// window of 384 lanes, so a pass over every slot reads two pad bytes for
// each byte it needs. The design reads only each row's occupied span, the
// 16-byte chunks [lo, hi) from its first to its last stored value (the span
// table, ops/bsr_band.py:band_spans, 4 bytes a row). The pads outside the
// span still take part in the dp: ⊗(x, 0̄) is not the ⊕-identity (0·x is
// −0 for a negative x under max_times, 0·inf is NaN, x + FLT_MAX decides a
// min_plus row whose span x is +inf). So each block scans its x window once
// for them: pre[c] = ⊕ of ⊗(x_l, 0̄) over the window lanes before chunk c,
// suf[c] over the lanes from chunk c on, and a row's dp is
//   (⊕ over its span of ⊗(x, strip)) ⊕ pre[lo] ⊕ suf[hi].
// For min, max and or this is exact whatever the order; the float min and
// max are the IEEE 754-2019 minimum and maximum (NaN propagates, −0 < +0),
// as XLA's are, so a row's value does not depend on the order either.
//
// The stream: one block per group of bn rows, and L lanes a row, so a warp
// step takes 32 / L rows. L is 4 where kUnroll = 5 chunks a lane cover the
// longest span in one pass, else 8, and longer spans take more passes (8 in
// f32 and 4 in bf16 on the bench band, whose spans are 32–33 and 16–17
// chunks). Each lane issues its kUnroll 16-byte streaming loads (__ldcs:
// the strips are read once and should not evict x from L2) before it uses
// any, about 2.5 KB a warp in flight, and a row's lanes ⊕ their partials
// with log2(L) shuffles. More lanes a row pay more shuffles and idler tail
// loads: a warp a row (L = 32) ran 1.14× (f32) to 1.9× (bf16) slower on the
// bench band, and on spans of 64–129 chunks L = 16 and 32 were no faster
// than 8 taking two to four passes. x comes from
// shared memory (staged) or L1/L2 (streamed). 40 registers hold 6 blocks
// (48 warps) an SM, which hides the blocks' set-up (x window, spans, pad
// scans). scripts/probe_band_spans_cuda.py times this kernel with L forced,
// and a design that copies each span with cp.async.bulk into a ring of
// shared-memory buffers instead, which was slower (PERF.md, PR 8).
//
// Semirings, loads and the dispatch: semiring.cuh.

#include "semiring.cuh"

#include <cstring>

namespace {

using namespace sh;

constexpr int kUnroll = 5;  // chunks a lane loads per pass, all before use

// the lanes of one 16-byte chunk of strip, in the compute type
template <typename S>
struct Chunk {
  static constexpr int N = 16 / static_cast<int>(sizeof(S));
};

__device__ __forceinline__ void unpack(const uint4& r, float (&v)[4], const float*) {
  v[0] = __uint_as_float(r.x); v[1] = __uint_as_float(r.y);
  v[2] = __uint_as_float(r.z); v[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(const uint4& r, int (&v)[4], const int*) {
  v[0] = static_cast<int>(r.x); v[1] = static_cast<int>(r.y);
  v[2] = static_cast<int>(r.z); v[3] = static_cast<int>(r.w);
}

// bf16 → f32 is the bf16 bits in the upper half; little endian: the lower
// half of each word is the earlier lane
__device__ __forceinline__ void unpack(const uint4& r, float (&v)[8], const __nv_bfloat16*) {
  const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// N consecutive x entries (N a multiple of 4), 16-byte aligned, from shared
// memory or through the read-only cache
template <bool SHARED, typename T, int N>
__device__ __forceinline__ void load_xn(const T* p, T (&v)[N]) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    T t[4];
    load_x4<SHARED>(p + j, t);
    v[j] = t[0]; v[j + 1] = t[1]; v[j + 2] = t[2]; v[j + 3] = t[3];
  }
}

// ⊕ across each aligned group of L lanes; every lane of a group gets its
// group's result
template <int SR, int L>
__device__ __forceinline__ typename Ieee<SR>::T group_reduce(typename Ieee<SR>::T v) {
#pragma unroll
  for (int m = L / 2; m > 0; m >>= 1) v = Ieee<SR>::add(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// ⊕ of ⊗(x_l, pad) over the N lanes of window chunk c
template <int SR, bool SHARED, int N>
__device__ __forceinline__ typename Ieee<SR>::T pad_chunk(const typename Ieee<SR>::T* xsrc,
                                                          int c, typename Ieee<SR>::T pad) {
  using B = Ieee<SR>;
  typename B::T xv[N];
  load_xn<SHARED>(xsrc + c * N, xv);
  typename B::T v = B::identity();
#pragma unroll
  for (int j = 0; j < N; ++j) v = B::add(v, B::mul(xv[j], pad));
  return v;
}

// The block's pad scans over its nc window chunks: pre[c] = ⊕ of the pad
// products of chunks < c, suf[c] of chunks ≥ c (pre[0] = suf[nc] = the
// identity). Thread t takes a run of consecutive chunks; warp shuffles and
// one exchange of warp totals give each run what lies before and after it.
template <int SR, bool SHARED, int N>
__device__ void pad_scans(const typename Ieee<SR>::T* xsrc, int nc, typename Ieee<SR>::T pad,
                          typename Ieee<SR>::T* pre, typename Ieee<SR>::T* suf) {
  using B = Ieee<SR>;
  using T = typename B::T;
  __shared__ T totals[2][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (nc + kThreads - 1) / kThreads;
  const int c_begin = min(static_cast<int>(threadIdx.x) * per, nc);
  const int c_end = min(c_begin + per, nc);
  T v = B::identity();
  for (int c = c_begin; c < c_end; ++c) v = B::add(v, pad_chunk<SR, SHARED, N>(xsrc, c, pad));
  // inclusive scans within the warp, forwards and backwards
  T fwd = v, bwd = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const T f = __shfl_up_sync(0xffffffffu, fwd, d);
    const T b = __shfl_down_sync(0xffffffffu, bwd, d);
    if (lane >= d) fwd = B::add(f, fwd);
    if (lane + d < 32) bwd = B::add(bwd, b);
  }
  if (lane == 31) totals[0][warp] = fwd;
  if (lane == 0) totals[1][warp] = bwd;
  T before = __shfl_up_sync(0xffffffffu, fwd, 1);
  T after = __shfl_down_sync(0xffffffffu, bwd, 1);
  if (lane == 0) before = B::identity();
  if (lane == 31) after = B::identity();
  __syncthreads();
  for (int w = 0; w < warp; ++w) before = B::add(totals[0][w], before);
  for (int w = warp + 1; w < kWarps; ++w) after = B::add(after, totals[1][w]);
  for (int c = c_begin; c < c_end; ++c) {
    pre[c] = before;
    before = B::add(before, pad_chunk<SR, SHARED, N>(xsrc, c, pad));
  }
  if (c_begin < c_end && c_end == nc) pre[nc] = before;
  for (int c = c_end - 1; c >= c_begin; --c) {
    after = B::add(after, pad_chunk<SR, SHARED, N>(xsrc, c, pad));
    suf[c] = after;
  }
  if (threadIdx.x == 0) suf[nc] = B::identity();
}

// One block per group of gs·bm = bn rows. Shared memory: the staged x
// window (STAGE_X), pre and suf (nc + 1 each), the group's spans.
// part_lanes = kc·bn: the streamed path's ⊕-partials (= K·bn when staged).
// L lanes take a row, so a warp step takes 32 / L rows; each lane loads
// chunks sub, sub + L, ... of its row's span, kUnroll of them before it uses
// any, and the row's L lanes ⊕ their partials with log2(L) shuffles.
template <int SR, typename S, bool STAGE_X, int L>
__global__ void __launch_bounds__(kThreads, 6)
band_span_kernel(const S* __restrict__ strips, const typename Op<SR>::T* __restrict__ x,
                 const unsigned* __restrict__ spans, typename Op<SR>::T* __restrict__ out,
                 int rows_per_group, int kbn, int bn, int k, int part_lanes, int c0,
                 int c_blocks, typename Op<SR>::T pad) {
  using B = Ieee<SR>;
  using T = typename B::T;
  constexpr int N = Chunk<S>::N;
  constexpr int kStepRows = 32 / L;
  const int nc = kbn / N;
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* pre = xs + (STAGE_X ? kbn : 0);
  T* suf = pre + nc + 1;
  unsigned* span = reinterpret_cast<unsigned*>(suf + nc + 1);

  const int g = blockIdx.x;
  const int w0 = min(max(g + c0, 0), max(c_blocks - k, 0));
  const T* xwin = x + static_cast<int64_t>(w0) * bn;
  const int64_t row0 = static_cast<int64_t>(g) * rows_per_group;
  if (STAGE_X) {
    for (int i = threadIdx.x * 4; i < kbn; i += kThreads * 4) {
      T v[4];
      load_x4<false>(xwin + i, v);
      xs[i] = v[0]; xs[i + 1] = v[1]; xs[i + 2] = v[2]; xs[i + 3] = v[3];
    }
  }
  for (int i = threadIdx.x; i < rows_per_group; i += kThreads) span[i] = spans[row0 + i];
  if (STAGE_X) __syncthreads();
  const T* xsrc = STAGE_X ? xs : xwin;
  pad_scans<SR, STAGE_X, N>(xsrc, nc, pad, pre, suf);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % L;
  const S* gstrips = strips + row0 * kbn;
  for (int r = warp * kStepRows + lane / L; r - lane / L < rows_per_group;
       r += kWarps * kStepRows) {
    const unsigned s = r < rows_per_group ? span[r] : 0u;
    const int lo = static_cast<int>(s & 0xffffu);
    const int len = static_cast<int>(s >> 16) - lo;
    const int longest = __reduce_max_sync(0xffffffffu, len);
    const uint4* row = reinterpret_cast<const uint4*>(gstrips + static_cast<int64_t>(r) * kbn) + lo;
    T acc = B::identity(), part = B::identity();
    int region = 0;
    for (int base = sub; base < longest; base += L * kUnroll) {
      // every load of the pass first, then the arithmetic
      uint4 raw[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = base + u * L;
        raw[u] = c < len ? __ldcs(row + c) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int c = base + u * L;
        if (c < len) {
          const int chunk = lo + c;
          T a[N], xv[N];
          unpack(raw[u], a, static_cast<const S*>(nullptr));
          load_xn<STAGE_X>(xsrc + chunk * N, xv);
          if (!STAGE_X) {
            const int rg = chunk * N / part_lanes;
            if (rg != region) {
              acc = B::add(acc, part);
              part = B::identity();
              region = rg;
            }
          }
#pragma unroll
          for (int j = 0; j < N; ++j) part = B::add(part, B::mul(xv[j], a[j]));
        }
      }
    }
    const T v = group_reduce<SR, L>(B::add(acc, part));
    if (sub == 0 && r < rows_per_group)
      out[row0 + r] = B::add(B::add(v, pre[lo]), suf[lo + len]);
  }
}

// the launch for one (semiring, strip type) instantiation, as dispatch
// calls it
struct BandLaunch {
  const void* strips;
  const void* x;
  const void* spans;
  void* out;
  int n_groups, rows_per_group, kbn, bn, k, part_lanes, c0, c_blocks, row_lanes;
  bool stage_x;
  int pad_bits;
  cudaStream_t stream;

  template <int SR, typename S, bool STAGE_X, int L>
  int launch() const {
    using T = typename Op<SR>::T;
    constexpr int N = Chunk<S>::N;
    if (kbn % N != 0) return cudaErrorInvalidValue;
    T pad;
    std::memcpy(&pad, &pad_bits, sizeof(pad));
    const int nc = kbn / N;
    const size_t smem = sizeof(T) * ((STAGE_X ? kbn : 0) + 2 * (nc + 1))
                        + sizeof(unsigned) * rows_per_group;
    auto kernel = band_span_kernel<SR, S, STAGE_X, L>;
    if (smem > 48 * 1024) {
      const int rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(smem));
      if (rc != cudaSuccess) return rc;
    }
    kernel<<<n_groups, kThreads, smem, stream>>>(
        static_cast<const S*>(strips), static_cast<const T*>(x),
        static_cast<const unsigned*>(spans), static_cast<T*>(out), rows_per_group, kbn, bn,
        k, part_lanes, c0, c_blocks, pad);
    return cudaSuccess;
  }

  template <int SR, typename S, bool STAGE_X>
  int lanes() const {
    return row_lanes == 4 ? launch<SR, S, STAGE_X, 4>() : launch<SR, S, STAGE_X, 8>();
  }

  template <int SR, typename S>
  int run() const {
    return stage_x ? lanes<SR, S, true>() : lanes<SR, S, false>();
  }
};

}  // namespace

extern "C" {

// dp over the padded rows: out[r_rows·bm] (float32, or int32 for the int
// semirings and the or_and carrier). x is the padded (c_blocks, bn) window
// source in the same type; spans the (r_rows·bm, 2) int16 table of each
// row's span [lo, hi) in 16-byte chunks, the longest max_chunks; pad_bits
// the bits of 0̄ as the strips store it, in the compute type. Launches on `stream` and returns
// the launch's cudaError_t (0 on success); it does not synchronise.
int sh_band_dp(int device, const void* strips, const void* x, const void* spans, void* out,
               int r_rows, int bm, int kbn, int k, int kc, int c0, int c_blocks,
               int semiring, int strip_dtype, int stage_x, int pad_bits, int max_chunks,
               void* stream) {
  if (bm <= 0 || k <= 0 || kc <= 0 || kbn % k != 0 || k % kc != 0)
    return cudaErrorInvalidValue;
  const int bn = kbn / k;
  if (bn % bm != 0 || bn % 4 != 0 || c_blocks < k) return cudaErrorInvalidValue;
  const int gs = bn / bm;
  if (r_rows % gs != 0) return cudaErrorInvalidValue;
  const int n_groups = r_rows / gs;
  if (n_groups == 0) return cudaSuccess;
  int rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  // 4 lanes a row where they take the longest span in one pass, else 8
  const int row_lanes = max_chunks <= 4 * kUnroll ? 4 : 8;
  const BandLaunch launch{strips, x, spans, out, n_groups, gs * bm, kbn, bn, k,
                          stage_x ? kbn : kc * bn, c0, c_blocks, row_lanes, stage_x != 0,
                          pad_bits, static_cast<cudaStream_t>(stream)};
  rc = dispatch(semiring, strip_dtype, launch);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* sh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Band SpMM Y = A·X over bsr_band strips (plus_times), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
//   sparseharness_tpu/ops/pallas_bsr_band.py:spmm_band (kernel body :334-352).
//
// What it computes: group g of the (r_rows, bm, K·bn) strips is a dense
// (gs·bm, K·bn) matrix A_g (gs = bn / bm block-rows, contiguous), and its X
// window is the K·bn contiguous rows of X (c_blocks·bn, m) that start at
//   w0 = clamp(g + c0, 0, c_blocks − K) · bn,
// as in bsr_band.cu. Then Y[g·gs·bm + i, c] = Σ_e A_g[i, e] · X[w0 + e, c],
// accumulated in float32 with plain FP32 FMAs: bf16 strips are upcast, and no
// tensor core (no TF32) touches an f32 product, as the JAX kernel forces
// Precision.HIGHEST for f32 strips.
//
// What bounds it: the operations. A band's strips are mostly pad: a row of
// banded_coo(n, 63) holds 127 values in a window of 384 lanes, so a product
// over every slot (the first port's kernel) issues 51.5 Gop at the bench
// band and m = 128 where the values need 17.0. This design multiplies only
// each warp tile's span of the band. Each row's occupied span, in 16-byte
// chunks [lo, hi), comes from the operand's span table
// (ops/bsr_band.py:band_spans);
// a warp owns 16 consecutive rows and multiplies only the window lanes of
// the union of their spans (142 of 384 on the bench band, so 19 Gop), a
// warp-uniform skip of each 4-lane step outside it. The pads inside a warp's
// union are multiplied as they are stored.
//
// The pads outside it still count: 0 · ±inf and 0 · NaN are NaN, so the
// plain version's Y is NaN wherever a skipped pad meets a non-finite X value
// of its window. The block records, for each of its columns, the first and
// last window row that holds one (from shared memory as each chunk lands,
// and from a scan of the window rows it does not stage), and an output whose
// warp skipped such a row is NaN. Otherwise a skipped 0 · x is ±0, which
// changes no sum but the sign of a zero.
//
// The block: 256 threads, 128 rows (8 warps of 16) × 64 columns of Y, the
// column tiles of a group launched one after the other, so that the second
// finds the group's strips in L2. The block stages, kStep = 16 window lanes
// at a time, the union of its warps' spans through shared memory with
// cp.async (L2 only, no L1) into a ring of kStages chunks, three in flight
// while one is multiplied: the X chunk (16 × 64) for the whole block, and
// each warp only the 4-lane pieces of its own rows that lie in its union.
// One __syncthreads a chunk: the chunk refilled is the one every thread
// finished before it. A thread holds 4 rows (r, r + 4, ...) × 8 columns (4
// at cg·4, 4 at 32 + cg·4) of accumulators and reads per two lanes 4
// float4s of X (8 addresses a warp) and 4 strip pairs (LDS.64, 4 addresses
// a warp): 32 sums and 16 X values live, for three blocks an SM. Each output
// is one thread's sum over e in order, with no atomics, so the same call
// gives the same bits twice.
//
// Where its time goes (NVIDIA H100 80GB HBM3, 700 W, f32 strips, m = 128,
// scripts/probe_spmm_wide_cuda.py): 0.83 ms; 0.39 without the products,
// 0.75 without the copies, 0.71 without the non-finite scans. The FP32
// products run at about 40% of the card's FP32 rate, fed from shared
// memory; 32-lane chunks were slower, and in earlier versions of the probe
// double buffering, 8 × 8 accumulators a thread and 128 registers (two
// blocks an SM) were no faster. The same tiles on
// TF32 tensor cores (3 passes for f32 strips, as the JAX kernel's HIGHEST)
// took 0.80 ms there, within 10% of this kernel, and stay in the probe.

#include "semiring.cuh"

namespace {

using namespace sh;

constexpr int kBlockRows = 128;  // output rows per block: 8 warps of 16
constexpr int kWarpRows = 16;
constexpr int kBlockCols = 64;   // output columns per block
constexpr int kXStride = kBlockCols + 8;  // floats a staged X row: 8 apart in banks per row
constexpr int kStep = 16;        // window lanes per staged chunk
constexpr int kStages = 4;       // chunks in the ring: 3 in flight while one is multiplied
constexpr int kSub = 4;          // lanes per warp-uniform step (a f32 span chunk)
constexpr int kRowGroups = 4;    // a warp's lanes: 4 row groups × 8 column groups
constexpr int kTileRows = 4;     // rows per thread: rg, rg + 4, rg + 8, rg + 12
constexpr int kTileCols = 8;     // columns per thread: cg·4 + 0..3 and 32 + cg·4 + 0..3

// A shared-memory strip row: kStep lanes and a pad, 16-byte aligned, so that
// the four rows one read touches (r to r + 3) fall in different banks
template <typename S>
struct AStage;
template <>
struct AStage<float> {
  using Raw = float;                         // as shared memory holds it
  static constexpr int kStride = kStep + 4;  // 80 bytes
  static constexpr int kPieceLanes = 4;      // lanes of one 16-byte copy
};
template <>
struct AStage<__nv_bfloat16> {
  using Raw = unsigned short;
  static constexpr int kStride = kStep + 8;  // 48 bytes
  static constexpr int kPieceLanes = 8;
};

template <typename S>
struct __align__(16) BandSmem {
  typename AStage<S>::Raw a[kStages][kBlockRows * AStage<S>::kStride];  // the strips' chunks
  float x[kStages][kStep * kXStride];  // the X chunks
  int nf_first[kBlockCols];  // per column: first window row with a non-finite X
  int nf_last[kBlockCols];   // and the last
  int warp_lo[kWarps];       // each warp's union of spans, in window lanes
  int warp_hi[kWarps];
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, bypassing L1; src_bytes < 16 fills the rest
// with zeros (0: nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

// 4 bytes global → shared; src_bytes 0 writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ bool non_finite(float v) {
  return (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;
}

// two consecutive strip lanes from shared memory, in float32
__device__ __forceinline__ void load_a2(const float* p, float& a0, float& a1) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  a0 = t.x;
  a1 = t.y;
}

__device__ __forceinline__ void load_a2(const unsigned short* p, float& a0, float& a1) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  a0 = __uint_as_float(w << 16);  // little endian: the lower half comes first
  a1 = __uint_as_float(w & 0xffff0000u);
}

// What the kernel and a probe's variant share: the block's coordinates, its
// warps' unions of spans and the chunks it stages.
struct BandBlock {
  int64_t grow0;   // the block's first padded row
  int rows;        // its rows within the group (≤ kBlockRows)
  int col0;        // its first column
  int64_t xrow0;   // the window's first X row, w0·bn
  int wlo, whi;    // this warp's union, in window lanes (kbn, 0 when empty)
  int c_lo, n_steps;  // the staged chunks: [c_lo, c_lo + n_steps·kStep)
};

// The block's coordinates and unions, from the table's (lo, hi) pair of
// each padded row (in 16-byte chunks of S). All threads must call it: it
// holds a __syncthreads.
template <typename S>
__device__ __forceinline__ BandBlock band_block(BandSmem<S>& sm, const short2* __restrict__ table,
                                                int rows_per_group, int row_tiles, int n_ct,
                                                int kbn, int bn, int k, int c0, int c_blocks) {
  BandBlock b;
  const int tile = blockIdx.x / n_ct;
  const int g = tile / row_tiles;
  const int row0 = (tile % row_tiles) * kBlockRows;
  b.grow0 = static_cast<int64_t>(g) * rows_per_group + row0;
  b.rows = min(kBlockRows, rows_per_group - row0);
  b.col0 = (blockIdx.x % n_ct) * kBlockCols;
  b.xrow0 = static_cast<int64_t>(min(max(g + c0, 0), max(c_blocks - k, 0))) * bn;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  constexpr int kChunkLanes = 16 / static_cast<int>(sizeof(S));
  int lo = kbn, hi = 0;
  const int r = warp * kWarpRows + lane;
  if (lane < kWarpRows && r < b.rows) {
    const short2 span = table[b.grow0 + r];
    if (span.x < span.y) {
      lo = span.x * kChunkLanes;
      hi = span.y * kChunkLanes;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, d));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, d));
  }
  b.wlo = lo;
  b.whi = hi;
  if (lane == 0) {
    sm.warp_lo[warp] = lo;
    sm.warp_hi[warp] = hi;
  }
  if (threadIdx.x < kBlockCols) {
    sm.nf_first[threadIdx.x] = kbn;
    sm.nf_last[threadIdx.x] = -1;
  }
  __syncthreads();
  int ulo = kbn, uhi = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    ulo = min(ulo, sm.warp_lo[w]);
    uhi = max(uhi, sm.warp_hi[w]);
  }
  b.c_lo = ulo / kStep * kStep;
  b.n_steps = ulo < uhi ? ((uhi + kStep - 1) / kStep * kStep - b.c_lo) / kStep : 0;
  return b;
}

// Issues the copies of chunk e0 into buffer buf: the X chunk for the block
// (16-byte copies when m is a multiple of 4, else 4-byte ones; columns past
// m read as zero) and this warp's pieces of its rows that lie in its union.
template <typename S>
__device__ __forceinline__ void stage_chunk(BandSmem<S>& sm, int buf, int e0, const BandBlock& b,
                                            const S* __restrict__ strips,
                                            const float* __restrict__ x, int kbn, int m,
                                            bool vec) {
  const float* xsrc = x + (b.xrow0 + e0) * m;
  float* xs = sm.x[buf];
  if (vec) {
#pragma unroll
    for (int j = 0; j < kStep * kBlockCols / 4 / kThreads; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      const int r = idx / (kBlockCols / 4);
      const int c = (idx % (kBlockCols / 4)) * 4;
      const bool in = b.col0 + c < m;
      cp_async16(xs + r * kXStride + c, in ? xsrc + static_cast<int64_t>(r) * m + b.col0 + c : x,
                 in ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kStep * kBlockCols / kThreads; ++j) {
      const int idx = threadIdx.x + j * kThreads;
      const int r = idx / kBlockCols;
      const int c = idx % kBlockCols;
      const bool in = b.col0 + c < m;
      cp_async4(xs + r * kXStride + c, in ? xsrc + static_cast<int64_t>(r) * m + b.col0 + c : x,
                in ? 4 : 0);
    }
  }
  if (e0 + kStep <= b.wlo || e0 >= b.whi) return;  // warp-uniform: no lane of this warp here
  constexpr int kStride = AStage<S>::kStride;
  constexpr int kPiece = AStage<S>::kPieceLanes;
  constexpr int kPieces = kWarpRows * (kStep / kPiece);  // 64 (f32) or 32 (bf16) a warp
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  auto* as = sm.a[buf] + warp * kWarpRows * kStride;
  const S* src = strips + (b.grow0 + warp * kWarpRows) * kbn + e0;
#pragma unroll
  for (int j = 0; j < kPieces / 32; ++j) {
    const int idx = lane + 32 * j;
    const int r = idx / (kStep / kPiece);
    const int p = (idx % (kStep / kPiece)) * kPiece;
    if (e0 + p >= b.wlo && e0 + p < b.whi)
      cp_async16(as + r * kStride + p, src + static_cast<int64_t>(r) * kbn + p, 16);
  }
}

// Records the non-finite X values of staged chunk e0 (in buffer buf) in the
// block's per-column first and last rows; every thread takes a share after
// its products (one idle warp scanning alone made the others wait for it).
template <typename S>
__device__ __forceinline__ void scan_chunk(BandSmem<S>& sm, int buf, int e0) {
  constexpr int kQuads = kBlockCols / 4;
  const int c = (threadIdx.x % kQuads) * 4;
#pragma unroll
  for (int h = 0; h < kStep * kQuads / kThreads; ++h) {
    const int r = threadIdx.x / kQuads + h * (kThreads / kQuads);
    const float4 v = *reinterpret_cast<const float4*>(sm.x[buf] + r * kXStride + c);
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (non_finite(vs[q])) {
        atomicMin(&sm.nf_first[c + q], e0 + r);
        atomicMax(&sm.nf_last[c + q], e0 + r);
      }
    }
  }
}

// The same for the window rows the block does not stage, read from device
// memory.
template <typename S>
__device__ __forceinline__ void scan_unstaged(BandSmem<S>& sm, const BandBlock& b,
                                              const float* __restrict__ x, int kbn, int m,
                                              bool vec) {
  constexpr int kQuads = kBlockCols / 4;
  const int c = (threadIdx.x % kQuads) * 4;
  const int s_lo = b.c_lo;
  const int s_hi = b.c_lo + b.n_steps * kStep;
  const int n_out = kbn - (s_hi - s_lo);
  const int cols = min(4, m - b.col0 - c);
  if (cols <= 0) return;
#pragma unroll 8  // a thread's loads all in flight at once on the bench band
  for (int i = threadIdx.x / kQuads; i < n_out; i += kThreads / kQuads) {
    const int e = i < s_lo ? i : i + (s_hi - s_lo);
    const float* p = x + (b.xrow0 + e) * m + b.col0 + c;
    float vs[4];
    if (vec) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p));
      vs[0] = v.x; vs[1] = v.y; vs[2] = v.z; vs[3] = v.w;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) vs[q] = q < cols ? __ldg(p + q) : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (non_finite(vs[q])) {
        atomicMin(&sm.nf_first[c + q], e);
        atomicMax(&sm.nf_last[c + q], e);
      }
    }
  }
}

// Writes this thread's 4 × 8 outputs: the sums, or NaN in a column whose
// window holds a non-finite X value in a row this warp skipped. Call after a
// __syncthreads that follows the last scan.
template <typename S>
__device__ __forceinline__ void write_tile(const BandSmem<S>& sm, const BandBlock& b,
                                           float* __restrict__ out, int m, bool vec,
                                           const float (&acc)[kTileRows][kTileCols]) {
  const int lane = threadIdx.x % 32;
  const int rg = lane / (32 / kRowGroups);
  const int cg = lane % (32 / kRowGroups);
  const int warp = threadIdx.x / 32;
  bool nan_col[kTileCols];
#pragma unroll
  for (int j = 0; j < kTileCols; ++j) {
    const int c = (j / 4) * (kBlockCols / 2) + cg * 4 + j % 4;
    nan_col[j] = sm.nf_first[c] < b.wlo || sm.nf_last[c] >= b.whi;
  }
#pragma unroll
  for (int i = 0; i < kTileRows; ++i) {
    const int r = warp * kWarpRows + rg + kRowGroups * i;
    if (r >= b.rows) continue;
    float* orow = out + (b.grow0 + r) * m;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = b.col0 + h * (kBlockCols / 2) + cg * 4;
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        v[q] = nan_col[h * 4 + q] ? __int_as_float(0x7fc00000) : acc[i][h * 4 + q];
      if (vec) {
        if (c < m) *reinterpret_cast<float4*>(orow + c) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (c + q < m) orow[c + q] = v[q];
      }
    }
  }
}

// One 4-lane step q of a staged chunk: per pair of lanes 4 float4s of X (16
// values held), then per row one strip pair and 16 FMAs, so that few values
// beside the 32 sums are live.
template <typename S>
__device__ __forceinline__ void multiply_step(const typename AStage<S>::Raw* as,
                                              const float* xs, int q,
                                              float (&acc)[kTileRows][kTileCols]) {
  constexpr int kStride = AStage<S>::kStride;
#pragma unroll
  for (int h = 0; h < kSub; h += 2) {
    float xv[2][kTileCols];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float* xr = xs + (q * kSub + h + u) * kXStride;
      const float4 x0 = *reinterpret_cast<const float4*>(xr);
      const float4 x1 = *reinterpret_cast<const float4*>(xr + kBlockCols / 2);
      xv[u][0] = x0.x; xv[u][1] = x0.y; xv[u][2] = x0.z; xv[u][3] = x0.w;
      xv[u][4] = x1.x; xv[u][5] = x1.y; xv[u][6] = x1.z; xv[u][7] = x1.w;
    }
#pragma unroll
    for (int i = 0; i < kTileRows; ++i) {
      float a[2];
      load_a2(as + kRowGroups * i * kStride + q * kSub + h, a[0], a[1]);
#pragma unroll
      for (int u = 0; u < 2; ++u)  // lane e before lane e + 1: each sum in order
#pragma unroll
        for (int j = 0; j < kTileCols; ++j) acc[i][j] = fmaf(a[u], xv[u][j], acc[i][j]);
    }
  }
}

// This warp's products over staged chunk e0: each 4-lane step in its union
// (a warp-uniform test), or, when the chunk lies wholly in it, every step
// with no test between them, so that the next step's loads can be issued
// before this step's products.
template <typename S>
__device__ __forceinline__ void multiply_chunk(const BandSmem<S>& sm, int buf, int e0,
                                               const BandBlock& b,
                                               float (&acc)[kTileRows][kTileCols]) {
  const int lane = threadIdx.x % 32;
  const int rg = lane / (32 / kRowGroups);
  const int cg = lane % (32 / kRowGroups);
  const auto* as = sm.a[buf] + ((threadIdx.x / 32) * kWarpRows + rg) * AStage<S>::kStride;
  const float* xs = sm.x[buf] + cg * 4;
  if (e0 >= b.wlo && e0 + kStep <= b.whi) {
#pragma unroll
    for (int q = 0; q < kStep / kSub; ++q) multiply_step<S>(as, xs, q, acc);
    return;
  }
#pragma unroll
  for (int q = 0; q < kStep / kSub; ++q) {
    const int e = e0 + q * kSub;
    if (e >= b.wlo && e < b.whi) multiply_step<S>(as, xs, q, acc);
  }
}

// The block's whole product on FP32 FMAs, from the staging of its first
// chunk to the writing of its outputs, recording the non-finite X values on
// the way.
template <typename S>
__device__ __forceinline__ void fma_pass(BandSmem<S>& sm, const BandBlock& b,
                                         const S* __restrict__ strips,
                                         const float* __restrict__ x, float* __restrict__ out,
                                         int kbn, int m, bool vec) {
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {  // one commit a chunk, empty or not
    if (st < b.n_steps) stage_chunk(sm, st, b.c_lo + st * kStep, b, strips, x, kbn, m, vec);
    cp_async_commit();
  }
  scan_unstaged(sm, b, x, kbn, m, vec);  // while the first chunks are in flight

  float acc[kTileRows][kTileCols];
#pragma unroll
  for (int i = 0; i < kTileRows; ++i)
#pragma unroll
    for (int j = 0; j < kTileCols; ++j) acc[i][j] = 0.0f;

  for (int s = 0; s < b.n_steps; ++s) {
    const int e0 = b.c_lo + s * kStep;
    cp_async_wait<kStages - 2>();  // chunk s has landed
    __syncthreads();               // for every thread; and chunk s − 1 is done with
    const int next = s + kStages - 1;
    if (next < b.n_steps)
      stage_chunk(sm, next % kStages, b.c_lo + next * kStep, b, strips, x, kbn, m, vec);
    cp_async_commit();
    if (e0 + kStep > b.wlo && e0 < b.whi) multiply_chunk(sm, s % kStages, e0, b, acc);
    scan_chunk(sm, s % kStages, e0);  // after the products: off their path
  }
  cp_async_wait<0>();
  __syncthreads();
  write_tile(sm, b, out, m, vec, acc);
}

// Three blocks an SM: 80 registers a thread (ptxas spills 60–76 bytes);
// with two blocks and 128 registers, no spill, it ran 1–5% slower
// (scripts/probe_spmm_wide_cuda.py, an earlier version).
template <typename S>
__global__ void __launch_bounds__(kThreads, 3)
spmm_band_kernel(const S* __restrict__ strips, const float* __restrict__ x,
                 const short2* __restrict__ table, float* __restrict__ out,
                 int rows_per_group, int row_tiles, int n_ct, int kbn, int bn, int k, int c0,
                 int c_blocks, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  BandSmem<S>& sm = *reinterpret_cast<BandSmem<S>*>(smem);
  const BandBlock b = band_block(sm, table, rows_per_group, row_tiles, n_ct, kbn, bn, k, c0,
                                 c_blocks);
  fma_pass(sm, b, strips, x, out, kbn, m, m % 4 == 0);
}

// Launches kernel with sizeof(BandSmem<S>) + extra bytes of dynamic shared
// memory, opting in above 48 KB.
template <typename S, typename K, typename... A>
int launch_band(K kernel, const dim3& grid, size_t extra, cudaStream_t s, A... args) {
  const size_t bytes = sizeof(BandSmem<S>) + extra;
  if (bytes > 48 * 1024) {
    const int rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        static_cast<int>(bytes));
    if (rc != cudaSuccess) return rc;
  }
  kernel<<<grid, kThreads, bytes, s>>>(args...);
  return cudaSuccess;
}

// The launch of sh_spmm_band, or cudaErrorInvalidValue for a shape the
// kernel does not take.
struct BandLaunch {
  dim3 grid;
  int rows_per_group, row_tiles, n_ct, bn;
};

inline int band_launch(int r_rows, int bm, int kbn, int k, int c_blocks, int m, BandLaunch* l) {
  if (bm <= 0 || k <= 0 || kbn % k != 0 || m < 0 || r_rows < 0) return cudaErrorInvalidValue;
  const int bn = kbn / k;
  if (bn % bm != 0 || bn % kWarpRows != 0 || bn % kStep != 0 || c_blocks < k)
    return cudaErrorInvalidValue;
  const int gs = bn / bm;
  if (r_rows % gs != 0) return cudaErrorInvalidValue;
  const int n_groups = r_rows / gs;
  l->bn = bn;
  l->rows_per_group = gs * bm;
  l->row_tiles = (l->rows_per_group + kBlockRows - 1) / kBlockRows;
  l->n_ct = (m + kBlockCols - 1) / kBlockCols;
  const int64_t blocks = static_cast<int64_t>(n_groups) * l->row_tiles * l->n_ct;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  l->grid = dim3(static_cast<unsigned>(blocks));
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Y over the padded rows: out (r_rows·bm, m), row-major float32. x is X
// padded with zero rows to (c_blocks·bn, m), row-major float32, with
// c_blocks ≥ K; table the int16 (r_rows·bm, 2) span table of the strips
// under a pad of +0 (ops/bsr_band.py:band_spans). strip_dtype is float32 or
// bfloat16 (semiring.cuh:StripCode). Launches on `stream` and returns the
// launch's cudaError_t (0 on success); it does not synchronise.
int sh_spmm_band(int device, const void* strips, const void* x, const void* table, void* out,
                 int r_rows, int bm, int kbn, int k, int c0, int c_blocks, int m,
                 int strip_dtype, void* stream) {
  BandLaunch l;
  int rc = band_launch(r_rows, bm, kbn, k, c_blocks, m, &l);
  if (rc != cudaSuccess) return rc;
  if (l.grid.x == 0) return cudaSuccess;
  rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const short2* tp = static_cast<const short2*>(table);
  float* o = static_cast<float*>(out);
  if (strip_dtype == STRIP_F32) {
    rc = launch_band<float>(spmm_band_kernel<float>, l.grid, 0, s,
                            static_cast<const float*>(strips), xp, tp, o, l.rows_per_group,
                            l.row_tiles, l.n_ct, kbn, l.bn, k, c0, c_blocks, m);
  } else if (strip_dtype == STRIP_BF16) {
    rc = launch_band<__nv_bfloat16>(spmm_band_kernel<__nv_bfloat16>, l.grid, 0, s,
                                    static_cast<const __nv_bfloat16*>(strips), xp, tp, o,
                                    l.rows_per_group, l.row_tiles, l.n_ct, kbn, l.bn, k, c0,
                                    c_blocks, m);
  } else {
    return cudaErrorInvalidValue;
  }
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* sh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

// Semiring SpMM dp over ELL-of-tiles strips, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package
//   sparseharness_tpu/ops/spmm_tiles.py:spmm_bsr_ell (kernel body :130-160).
//
// What it computes, for every padded row R = r·bm + i of the
// (R_blocks, bm, K·bn) strips and every column c < m of X (c_pad, m):
//   dp[R, c] = ⊕_{k < K, l < bn} mul(X[cols[r, k]·bn + l, c], strip[R, k·bn + l])
// for all seven semirings (semiring.cuh); or_and runs on its int32 carrier
// (⊕ = max, ⊗ = min on {0, 1}) and the wrapper takes dp > 0. Each partial
// starts from the true ⊕ identity, as the SpMV strip kernel's do. The
// TPU kernel's K-chunk and slab padding are rules of its grid and are left
// out; the operand's own pad tiles are read as they are.
//
// What bounds it: at m columns the strips (4 or 2 bytes per slot) are read
// once, while every tile pulls its (bn, m) block of X: a block-row reads
// K·bn·m elements of X for bm·K·bn·m operations, so X, not the strips, is
// the large stream unless the tiles that share a column block are adjacent
// and X stays in L2. The kernel is simple: one block per (block-row, column
// tile of tn ≤ 128 columns), and for each slot the (bm, bn) tile, transposed,
// and the tile's X rows, up to kXChunk elements at a time, are staged in
// shared memory by all threads at once, so that the loads of X are
// coalesced and many are in flight. Each thread then takes one column of
// the tile and kRows consecutive rows, its partials in registers; a thread's
// ⊕ runs over the slots in order (k, then l), so the bits do not depend on
// tn. No atomics: the same call gives the same bits twice. X reuse across
// block-rows and tensor cores are left to a later version.
//
// Semirings and bit-exactness: semiring.cuh.

#include <algorithm>

#include "semiring.cuh"

namespace {

using namespace sh;

constexpr int kRows = 4;        // consecutive tile rows each thread ⊕-accumulates
constexpr int kXChunk = 4096;   // X elements staged at a time: 16 KB
constexpr int kMaxTn = 128;     // columns per block

// One block per (block-row r, column tile ct of tn columns), ct fastest so
// that the column tiles of a block-row read its strip from L2. Thread t takes
// column t % tn of the tile and rows i0 + 4·g .. i0 + 4·g + 3 (g = t / tn) of
// each pass of 4·(256 / tn) rows. The tile is held transposed, (bn, bm4) with
// bm4 = bm rounded up to 4, so a thread's four rows are one 16-byte load.
template <int SR, typename S>
__global__ void __launch_bounds__(kThreads)
spmm_tiles_kernel(const S* __restrict__ strips, const int* __restrict__ cols,
                  const typename Op<SR>::T* __restrict__ x,
                  typename Op<SR>::T* __restrict__ out, int bm, int bm4, int kbn, int bn,
                  int k, int m, int tn_log2, int n_ct, int c_blocks) {
  using O = Op<SR>;
  using T = typename O::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* tile = reinterpret_cast<T*>(smem);  // (bn, bm4): the current slot, transposed
  T* xs = tile + bn * bm4;               // (chunk rows, tn): X rows of the slot

  const int tn = 1 << tn_log2;
  const int64_t r = blockIdx.x / n_ct;
  const int col0 = (blockIdx.x % n_ct) * tn;
  const int lane_c = threadIdx.x & (tn - 1);
  const int g = threadIdx.x >> tn_log2;
  const int rows_per_pass = (kThreads >> tn_log2) * kRows;
  const int chunk = min(bn, kXChunk >> tn_log2);  // X rows staged at a time
  const int col = col0 + lane_c;
  const bool active = col < m;
  const S* srow = strips + r * bm * kbn;

  for (int i0 = 0; i0 < bm; i0 += rows_per_pass) {
    const int row = i0 + g * kRows;  // this thread's first row
    const bool rows_live = active && row < bm;
    T acc[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) acc[q] = O::identity();
    for (int kk = 0; kk < k; ++kk) {
      // a column beyond X's blocks is clamped into range, as the TPU's
      // block index is
      const int xb = min(max(__ldg(cols + r * k + kk), 0), c_blocks - 1);
      const T* xblock = x + static_cast<int64_t>(xb) * bn * m;
      for (int l0 = 0; l0 < bn; l0 += chunk) {
        const int rows = min(chunk, bn - l0);
        __syncthreads();  // the previous chunk (and tile) is consumed
        if (l0 == 0) {
#pragma unroll 4
          for (int e = threadIdx.x; e < bm * bn; e += kThreads) {
            const int i = e / bn;
            const int l = e - i * bn;
            tile[l * bm4 + i] = load_strip1(srow + static_cast<int64_t>(i) * kbn + kk * bn + l);
          }
        }
#pragma unroll 4
        for (int e = threadIdx.x; e < rows << tn_log2; e += kThreads) {
          const int c = col0 + (e & (tn - 1));
          xs[e] = c < m ? __ldg(xblock + static_cast<int64_t>(l0 + (e >> tn_log2)) * m + c)
                        : O::identity();
        }
        __syncthreads();
        if (rows_live) {
#pragma unroll 4
          for (int l = 0; l < rows; ++l) {
            const T xv = xs[(l << tn_log2) + lane_c];
            T a[kRows];
            load_x4<true>(tile + (l0 + l) * bm4 + row, a);
#pragma unroll
            for (int q = 0; q < kRows; ++q) acc[q] = O::add(acc[q], O::mul(xv, a[q]));
          }
        }
      }
    }
    if (rows_live) {
#pragma unroll
      for (int q = 0; q < kRows; ++q)
        if (row + q < bm) out[(r * bm + row + q) * m + col] = acc[q];
    }
  }
}

struct TilesLaunch {
  const void* strips;
  const int* cols;
  const void* x;
  void* out;
  int64_t r_blocks;
  int bm, kbn, bn, k, m, tn_log2, c_blocks;
  cudaStream_t stream;

  template <int SR, typename S>
  int run() const {
    using T = typename Op<SR>::T;
    const int tn = 1 << tn_log2;
    const int n_ct = (m + tn - 1) / tn;
    const int bm4 = (bm + kRows - 1) / kRows * kRows;
    const int chunk = std::min(bn, kXChunk / tn);
    const size_t smem = (static_cast<size_t>(bn) * bm4 + static_cast<size_t>(chunk) * tn) *
                        sizeof(T);
    if (smem > 48 * 1024) {
      const int rc = cudaFuncSetAttribute(spmm_tiles_kernel<SR, S>,
                                          cudaFuncAttributeMaxDynamicSharedMemorySize,
                                          static_cast<int>(smem));
      if (rc != cudaSuccess) return rc;
    }
    spmm_tiles_kernel<SR, S><<<static_cast<unsigned>(r_blocks * n_ct), kThreads, smem, stream>>>(
        static_cast<const S*>(strips), cols, static_cast<const T*>(x),
        static_cast<T*>(out), bm, bm4, kbn, bn, k, m, tn_log2, n_ct, c_blocks);
    return cudaSuccess;
  }
};

}  // namespace

extern "C" {

// dp over the padded rows: out (r_blocks·bm, m), row-major, in the carrier
// type (float32, or int32 for the int semirings and the or_and carrier). x is
// X padded to (c_blocks·bn, m), row-major, in the same type; cols the int32
// (r_blocks, K) block-columns. Launches on `stream` and returns the launch's
// cudaError_t (0 on success); it does not synchronise.
int sh_spmm_tiles(int device, const void* strips, const void* cols, const void* x,
                  void* out, long long r_blocks, int bm, int kbn, int k, int m,
                  int c_blocks, int semiring, int strip_dtype, void* stream) {
  if (bm <= 0 || k <= 0 || kbn % k != 0 || r_blocks < 0 || m < 0 || c_blocks <= 0)
    return cudaErrorInvalidValue;
  const int bn = kbn / k;
  if (static_cast<size_t>(bm) * bn * 4 > 48 * 1024) return cudaErrorInvalidValue;
  if (r_blocks == 0 || m == 0) return cudaSuccess;
  int tn_log2 = 0;  // the column tile: m rounded up to a power of two, at most kMaxTn
  while ((1 << tn_log2) < std::min(m, kMaxTn)) ++tn_log2;
  if (r_blocks * ((m + (1 << tn_log2) - 1) >> tn_log2) > INT_MAX) return cudaErrorInvalidValue;
  int rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  const TilesLaunch launch{strips, static_cast<const int*>(cols), x, out, r_blocks,
                           bm, kbn, bn, k, m, tn_log2, c_blocks,
                           static_cast<cudaStream_t>(stream)};
  rc = dispatch(semiring, strip_dtype, launch);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* sh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

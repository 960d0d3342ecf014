// Gen-1 BSR semiring SpMV dp over slabbed (bm, bn) tiles, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel sparseharness_tpu/ops/pallas_bsr.py:dp_bsr.
// That kernel takes one tile per grid step, in order, and ⊕-accumulates it
// into the out block of its slab-local block-row, which it zeroes to 0̄ at
// the row's first tile (row_start == 1). Its grid is sequential, so the
// accumulation order is the tile order; here the rows are independent.
//
// What it computes, for padded row R of slab s, local block-row r and
// in-tile row i (R = (s·rps + r)·bm + i), over the row's tile segment
// [seg[s, r], seg[s, r + 1]) of the slab's tiles:
//   dp[R] = 0̄ ⊕ ⊕_{t in segment} ⊕_{l < bn} mul(x2d[cols[s, t], l], tiles[s, t, i, l])
// The segment of a block-row is its run of tiles, from the tile with
// row_start == 1 through the padding tiles that the build appends to the
// slab's last row (they ⊕ the pad value's products into it, as on the TPU).
// A row with no tile (past the last real block-row of the last slab) comes
// out as 0̄.
//
// What bounds it: the bytes of the tiles (one pass). A warp takes one row
// and walks its segment: each tile row is bn contiguous elements, 16 bytes
// per lane per load, read with streaming loads; the tile's x block comes
// from L2/L1. For plus_times each lane sums across the whole segment before
// the warp reduce, so the sum order differs from the TPU's per-tile sums;
// plus_times is held to a tolerance.
//
// Semirings, loads and bit-exactness: semiring.cuh.

#include "semiring.cuh"

namespace {

using namespace sh;

template <int SR, typename S>
__global__ void __launch_bounds__(kThreads)
tile_dp_kernel(const S* __restrict__ tiles, const typename Op<SR>::T* __restrict__ x,
               const int* __restrict__ cols, const int* __restrict__ seg,
               typename Op<SR>::T* __restrict__ out, int64_t n_rows, int bm,
               int bn, int rps, int slab_tiles) {
  using O = Op<SR>;
  using T = typename O::T;
  const int lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int64_t block_row = row / bm;  // over all slabs
  const int i = static_cast<int>(row - block_row * bm);
  const int64_t s = block_row / rps;
  const int r = static_cast<int>(block_row - s * rps);
  const int* sseg = seg + s * (rps + 1);
  const int lo = __ldg(sseg + r), hi = __ldg(sseg + r + 1);
  T acc = O::identity();
  for (int t = lo; t < hi; ++t) {
    const int64_t tile = s * slab_tiles + t;
    const S* trow = tiles + (tile * bm + i) * bn;
    const T* xb = x + static_cast<int64_t>(__ldg(cols + tile)) * bn;
#pragma unroll 4
    for (int e = lane * 4; e < bn; e += 128) {
      T a[4], xv[4];
      load_strip4(trow + e, a);
      load_x4<false>(xb + e, xv);
      acc = mul_add4<SR>(acc, xv, a);
    }
  }
  acc = warp_reduce<SR>(acc);
  if (lane == 0) out[row] = O::add(O::zero(), acc);
}

struct TileLaunch {
  const void* tiles;
  const void* x;
  const int* cols;
  const int* seg;
  void* out;
  int64_t n_rows;
  int bm, bn, rps, slab_tiles;
  cudaStream_t stream;

  template <int SR, typename S>
  int run() const {
    using T = typename Op<SR>::T;
    const unsigned blocks = static_cast<unsigned>((n_rows + kWarps - 1) / kWarps);
    tile_dp_kernel<SR, S><<<blocks, kThreads, 0, stream>>>(
        static_cast<const S*>(tiles), static_cast<const T*>(x), cols, seg,
        static_cast<T*>(out), n_rows, bm, bn, rps, slab_tiles);
    return cudaSuccess;
  }
};

}  // namespace

extern "C" {

// dp over the padded rows of all slabs: out[n_slabs·rps·bm] (float32, or
// int32 for the int semirings and the or_and carrier). tiles is
// (n_slabs, slab_tiles, bm, bn), cols the int32 (n_slabs, slab_tiles)
// global block-columns, seg the int32 (n_slabs, rps + 1) segment starts,
// x the padded (c_blocks, bn) vector. Launches on `stream` and returns
// the launch's cudaError_t (0 on success); it does not synchronise.
int sh_tile_dp(int device, const void* tiles, const void* x, const void* cols,
               const void* seg, void* out, int n_slabs, int slab_tiles, int rps,
               int bm, int bn, int semiring, int strip_dtype, void* stream) {
  if (n_slabs < 0 || slab_tiles <= 0 || rps <= 0 || bm <= 0 || bn <= 0 || bn % 4 != 0)
    return cudaErrorInvalidValue;
  const int64_t n_rows = static_cast<int64_t>(n_slabs) * rps * bm;
  if (n_rows == 0) return cudaSuccess;
  if ((n_rows + kWarps - 1) / kWarps > INT_MAX) return cudaErrorInvalidValue;
  int rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  const TileLaunch launch{tiles, x, static_cast<const int*>(cols),
                          static_cast<const int*>(seg), out, n_rows, bm, bn,
                          rps, slab_tiles, static_cast<cudaStream_t>(stream)};
  rc = dispatch(semiring, strip_dtype, launch);
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}

const char* sh_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

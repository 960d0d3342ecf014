#!/usr/bin/env python3
"""Time the designs of the port's two SpMM kernels at wide m on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 scripts/probe_spmm_wide_cuda.py [band | tiles]

(an argument runs that half alone).

It builds two sources of its own, each with one nvcc, both at once:

- BAND_SOURCE includes csrc/spmm_band.cu and adds ``sh_spmm_band_variant``,
  which runs one of four designs of the band SpMM (plus_times) on the same
  arguments: ``slots``, the first port's kernel kept here as it was
  (every strip slot of the window multiplied on FP32 FMAs, 8 × 4
  accumulators a thread, 64 columns a block); ``spans`` (step 1), the
  shipped kernel (each 16-row warp tile multiplies only its union of the
  rows' spans, cp.async staging through a ring of 4 chunks, 4 × 8
  accumulators a thread); ``tf32`` (step
  2), the same warp tiles and staging on tensor cores, mma.sync.m16n8k8 in
  TF32 with the operands split into high and low TF32 parts (f32 strips
  a_hi·x_hi + a_hi·x_lo + a_lo·x_hi, bf16 strips, exact in TF32, a·x_hi +
  a·x_lo), X split once a block as each chunk lands, a warp's 16 rows × 64
  columns; ``tf32_pair``, the same with warps w and w ^ 1 sharing the union
  of their 32 rows, each taking 32 columns, so that each B fragment serves
  two tiles. A block whose window holds a non-finite X value runs the FMA
  path instead (splitting inf gives inf − inf = NaN). Then the shipped
  kernel with a part left out, timed only (its results are wrong):
  ``no_stage`` (no copies), ``no_math`` (no products), ``no_scan`` (no
  non-finite scans) and ``no_unstaged_scan`` (no scan of the window rows
  the block does not stage).
- TILES_SOURCE includes csrc/spmm_tiles.cu and adds ``sh_spmm_tiles_map``,
  the kernel with its map forced: the tile map or the row map at S = 1, 2,
  4 or 8 lanes a group (plus_times and min_plus, f32 strips).

Shapes: the bench band, banded_coo(1 << 19, 63, seed=1) in f32 and bf16
strips at m = 128 and 256; the blocked matrix, bsr_ell of
block_random_coo(131072, 2, bm=8, bn=128, seed=5), in plus_times and
min_plus at m = 64, 128 and 256. Each design is first checked against the
plain version on the same inputs (X uniform in (0.1, 1); plus_times within
1e-5 · max(1, |plain|, Σ|a·x|), min_plus bit for bit) and the band designs
also on an X with ±inf and NaN in 48 places (NaN and ±inf where the plain
version has them, the finite outputs within the tolerance); then the
designs are timed in turns (each in order, then again in reverse; CUDA
events, the median of five 20-call windows each turn). Each line has the
bound: the larger of the bytes over the card's memory rate and the
operations over the rate of the units the shipped kernel uses (FP32, 67
TFLOP/s: 2 a nonzero a column); for the band the bytes count each row's
span of values, X and Y (``layout_bound_ms``: every strip slot), for the
blocked matrix tile_cols, every tile slot, X and Y, beside
``x_read_bytes``, the X bytes the row map and the tile map read by their
design (each tile slot's (bn, m) X block once an 8-row group, or once a
block-row and column tile). The card's name and power limit come first,
from nvidia-smi, then the compiler's registers and spills, then one JSON
line a shape. Imports only the port. About two minutes of command.
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
PT_DELTA = 1e-5
#: the band SpMM designs, checked and timed: name -> the code of
#: sh_spmm_band_variant
BAND_VARIANTS = {"slots": 0, "spans": 1, "tf32": 2, "tf32_pair": 3}
#: the same with 32-lane chunks, a ring of 3 and 2 blocks an SM (the
#: shipped source with those constants changed, built as its own library)
STEP32 = {"spans_s32": 1, "tf32_pair_s32": 3}
#: name -> (code, library: 0 the shipped constants, 1 STEP32's)
BAND_CHECKED = {**{k: (v, 0) for k, v in BAND_VARIANTS.items()},
                **{k: (v, 1) for k, v in STEP32.items()}}
#: the shipped kernel with a part left out (wrong results; timed only)
BAND_PARTS = {"no_stage": 4, "no_math": 5, "no_scan": 6, "no_unstaged_scan": 7}
#: the spmm_tiles maps; the position is the map's code (0 the tile map,
#: else the row map with that many lanes a group)
TILE_MAPS = {"tiles": 0, "rows_s1": 1, "rows_s2": 2, "rows_s4": 4, "rows_s8": 8}
BAND_M = (128, 256)
BLOCKED_M = (64, 128, 256)

BAND_SOURCE = r"""
#include "spmm_band.cu"

namespace {

// ---------------------------------------------------------------- slots
// The first port's kernel as it was: one block per (group of 128 rows, 64
// columns), every window entry of every row multiplied.
namespace slot {

constexpr int kBM = 128;  // output rows per block (a group at bn = 128)
constexpr int kBN = 64;   // output columns per block
constexpr int kBK = 16;   // window entries per staged chunk
constexpr int kTM = 8;    // rows per thread: 16 row groups of 8
constexpr int kTN = 4;    // columns per thread: 16 column groups of 4

// eight consecutive strip entries in float32, streaming loads; 32-byte (f32)
// or 16-byte (bf16) aligned
__device__ __forceinline__ void load_strip8(const float* p, float (&v)[8]) {
  float a[4], b[4];
  load_strip4(p, a);
  load_strip4(p + 4, b);
#pragma unroll
  for (int q = 0; q < 4; ++q) { v[q] = a[q]; v[q + 4] = b[q]; }
}

__device__ __forceinline__ void load_strip8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 t = __ldcs(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {  // little endian: the lower half comes first
    v[2 * q] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w[q] & 0xffffu)));
    v[2 * q + 1] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(w[q] >> 16)));
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
slot_kernel(const S* __restrict__ strips, const float* __restrict__ x,
                 float* __restrict__ out, int rows_per_group, int row_tiles, int kbn,
                 int bn, int k, int c0, int c_blocks, int m) {
  __shared__ __align__(16) float as[kBK][kBM];  // A chunk, transposed
  __shared__ __align__(16) float xs[kBK][kBN];  // X chunk

  const int g = blockIdx.x / row_tiles;
  const int row0 = (blockIdx.x % row_tiles) * kBM;  // first row within the group
  const int64_t grow0 = static_cast<int64_t>(g) * rows_per_group;
  const int col0 = blockIdx.y * kBN;
  const int w0 = min(max(g + c0, 0), max(c_blocks - k, 0));
  const int tx = threadIdx.x % 16;  // columns tx·4 .. tx·4 + 3
  const int ty = threadIdx.x / 16;  // rows ty·8 .. ty·8 + 7

  // A loader: thread t stages row t / 2 of the tile, chunk entries
  // (t % 2)·8 .. + 7
  const int la_row = threadIdx.x >> 1;
  const int la_e = (threadIdx.x & 1) * 8;
  const bool la_ok = row0 + la_row < rows_per_group;
  const S* a_src = strips + (grow0 + row0 + la_row) * kbn + la_e;
  // X loader: thread t stages chunk row t / 16, columns (t % 16)·4 .. + 3
  const int lx_e = threadIdx.x >> 4;
  const int lx_c = (threadIdx.x & 15) * 4;
  const float* x_src = x + (static_cast<int64_t>(w0) * bn + lx_e) * m;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;

  for (int e0 = 0; e0 < kbn; e0 += kBK) {
    float a[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (la_ok) load_strip8(a_src + e0, a);
#pragma unroll
    for (int q = 0; q < 8; ++q) as[la_e + q][la_row] = a[q];
    const float* xr = x_src + static_cast<int64_t>(e0) * m;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = col0 + lx_c + q;
      xs[lx_e][lx_c + q] = c < m ? __ldg(xr + c) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kBK; ++e) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[e][ty * kTM]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[e][ty * kTM + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&xs[e][tx * kTN]);
      const float av[kTM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = row0 + ty * kTM + i;
    if (row >= rows_per_group) continue;
    float* orow = out + (grow0 + row) * m;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int c = col0 + tx * kTN + j;
      if (c < m) orow[c] = acc[i][j];
    }
  }
}

}  // namespace slot

// ---------------------------------------------------------------- tf32
// Step 2: the shipped kernel's warp tiles and staging, the products on
// tensor cores. A warp's 16 rows × 64 columns are 8 m16n8 tiles; per
// 8-lane step of its union it loads one A fragment (4 values a thread) and
// per tile one B fragment (2), both split into high and low TF32 parts.
namespace tc {

__device__ __forceinline__ unsigned to_tf32(float v) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                    unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float a_value(const float* p) { return *p; }
__device__ __forceinline__ float a_value(const unsigned short* p) {
  return __uint_as_float(static_cast<unsigned>(*p) << 16);
}

// X of the landed chunk → its high TF32 part in place and the low part in
// xlo (4 values a thread for each 16 rows)
__device__ __forceinline__ void split_chunk(float* xs, float* xlo) {
  constexpr int kQuads = kBlockCols / 4;
  const int c = (threadIdx.x % kQuads) * 4;
#pragma unroll
  for (int h = 0; h < kStep * kQuads / kThreads; ++h) {
    const int r = threadIdx.x / kQuads + h * (kThreads / kQuads);
    float4* p = reinterpret_cast<float4*>(xs + r * kXStride + c);
    const float4 v = *p;
    const float vs[4] = {v.x, v.y, v.z, v.w};
    float hi[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      hi[q] = __uint_as_float(to_tf32(vs[q]));
      lo[q] = __uint_as_float(to_tf32(vs[q] - hi[q]));
    }
    *p = make_float4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<float4*>(xlo + r * kXStride + c) = make_float4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// PAIR false: the warp's own 16 rows × the block's 64 columns (8 tiles);
// PAIR true: warps w and w ^ 1 share their 32 rows and union, each taking
// 32 of the columns (2 × 4 tiles), so that a B fragment serves two tiles.
template <typename S, bool PAIR>
__device__ __forceinline__ void mma_chunk(const BandSmem<S>& sm, const float* xlo, int buf,
                                          int e0, const BandBlock& b, float (&acc)[8][4]) {
  constexpr int kStride = AStage<S>::kStride;
  constexpr bool kSplitA = std::is_same<S, float>::value;
  constexpr int kM = PAIR ? 2 : 1;  // m16 tiles a warp
  constexpr int kN = 8 / kM;        // n8 tiles a warp
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = PAIR ? (warp / 2) * 2 * kWarpRows : warp * kWarpRows;
  const int col0 = PAIR ? (warp % 2) * (kBlockCols / 2) : 0;
  const auto* as = sm.a[buf] + row0 * kStride;
  const float* xs = sm.x[buf];
#pragma unroll
  for (int kk = 0; kk < kStep; kk += 8) {
    if (e0 + kk < b.wlo || e0 + kk >= b.whi) continue;  // warp-uniform
    unsigned ahi[kM][4], alo[kM][4];
#pragma unroll
    for (int mt = 0; mt < kM; ++mt) {
      const auto* ar = as + (16 * mt + g) * kStride + kk + t;
      const float av[4] = {a_value(ar), a_value(ar + 8 * kStride), a_value(ar + 4),
                           a_value(ar + 8 * kStride + 4)};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        ahi[mt][q] = kSplitA ? to_tf32(av[q]) : __float_as_uint(av[q]);
        alo[mt][q] = kSplitA ? to_tf32(av[q] - __uint_as_float(ahi[mt][q])) : 0u;
      }
    }
    const int x0 = (kk + t) * kXStride + col0 + g;
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const int o = x0 + 8 * j;
      const unsigned h0 = __float_as_uint(xs[o]), h1 = __float_as_uint(xs[o + 4 * kXStride]);
      const unsigned l0 = __float_as_uint(xlo[o]), l1 = __float_as_uint(xlo[o + 4 * kXStride]);
#pragma unroll
      for (int mt = 0; mt < kM; ++mt) {
        if (kSplitA) mma(acc[mt * kN + j], alo[mt], h0, h1);
        mma(acc[mt * kN + j], ahi[mt], l0, l1);
        mma(acc[mt * kN + j], ahi[mt], h0, h1);
      }
    }
  }
}

template <typename S, bool PAIR>
__global__ void __launch_bounds__(kThreads, 3)
tf32_kernel(const S* __restrict__ strips, const float* __restrict__ x,
            const short2* __restrict__ table, float* __restrict__ out, int rows_per_group,
            int row_tiles, int n_ct, int kbn, int bn, int k, int c0, int c_blocks, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  BandSmem<S>& sm = *reinterpret_cast<BandSmem<S>*>(smem);
  float* xlo = reinterpret_cast<float*>(smem + sizeof(BandSmem<S>));  // kStep × kXStride
  BandBlock b = band_block(sm, table, rows_per_group, row_tiles, n_ct, kbn, bn, k, c0,
                           c_blocks);
  if (PAIR) {  // the union of the warp pair's 32 rows
    const int other = (threadIdx.x / 32) ^ 1;
    b.wlo = min(b.wlo, sm.warp_lo[other]);
    b.whi = max(b.whi, sm.warp_hi[other]);
  }
  if (b.wlo < b.whi) {  // whole 8-lane steps: the extra lanes are pads of every row
    b.wlo &= ~7;
    b.whi = (b.whi + 7) & ~7;
  }
  const bool vec = m % 4 == 0;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < b.n_steps) stage_chunk(sm, st, b.c_lo + st * kStep, b, strips, x, kbn, m, vec);
    cp_async_commit();
  }
  scan_unstaged(sm, b, x, kbn, m, vec);
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.0f;
  for (int s = 0; s < b.n_steps; ++s) {
    const int e0 = b.c_lo + s * kStep;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = s + kStages - 1;
    if (next < b.n_steps)
      stage_chunk(sm, next % kStages, b.c_lo + next * kStep, b, strips, x, kbn, m, vec);
    cp_async_commit();
    scan_chunk(sm, s % kStages, e0);
    split_chunk(sm.x[s % kStages], xlo);
    __syncthreads();
    if (e0 + kStep > b.wlo && e0 < b.whi) mma_chunk<S, PAIR>(sm, xlo, s % kStages, e0, b, acc);
  }
  cp_async_wait<0>();
  __syncthreads();
  const int lane = threadIdx.x % 32;
  bool bad = false;
#pragma unroll
  for (int q = 0; q < 4; ++q) bad |= lane < kBlockCols / 4 && sm.nf_first[lane * 4 + q] < kbn;
  if (__syncthreads_or(bad)) {  // a non-finite X value: the FMA path, as shipped
    fma_pass(sm, b, strips, x, out, kbn, m, vec);
    return;
  }
  const int g = lane / 4;
  const int t = lane % 4;
  const int warp = threadIdx.x / 32;
  constexpr int kM = PAIR ? 2 : 1;
  constexpr int kN = 8 / kM;
  const int row0 = PAIR ? (warp / 2) * 2 * kWarpRows : warp * kWarpRows;
  const int col0 = b.col0 + (PAIR ? (warp % 2) * (kBlockCols / 2) : 0);
#pragma unroll
  for (int mt = 0; mt < kM; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 16 * mt + g + 8 * h;
      if (r >= b.rows) continue;
      float* orow = out + (b.grow0 + r) * m;
#pragma unroll
      for (int j = 0; j < kN; ++j) {
        const float* a = acc[mt * kN + j];
        const int c = col0 + 8 * j + 2 * t;
        if (vec) {
          if (c < m) *reinterpret_cast<float2*>(orow + c) = make_float2(a[2 * h], a[2 * h + 1]);
        } else {
          if (c < m) orow[c] = a[2 * h];
          if (c + 1 < m) orow[c + 1] = a[2 * h + 1];
        }
      }
    }
  }
}

}  // namespace tc

// ---------------------------------------------------------------- parts
// The shipped kernel with a part left out, to see what sets its time (the
// results are wrong): STAGE the cp.async staging, MATH the products, SCAN
// the scan of the window rows not staged, SCAN_IN that of the staged chunks.
template <typename S, bool STAGE, bool MATH, bool SCAN, bool SCAN_IN>
__global__ void __launch_bounds__(kThreads, 3)
parts_kernel(const S* __restrict__ strips, const float* __restrict__ x,
             const short2* __restrict__ table, float* __restrict__ out, int rows_per_group,
             int row_tiles, int n_ct, int kbn, int bn, int k, int c0, int c_blocks, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  BandSmem<S>& sm = *reinterpret_cast<BandSmem<S>*>(smem);
  const BandBlock b = band_block(sm, table, rows_per_group, row_tiles, n_ct, kbn, bn, k, c0,
                                 c_blocks);
  const bool vec = m % 4 == 0;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (STAGE && st < b.n_steps)
      stage_chunk(sm, st, b.c_lo + st * kStep, b, strips, x, kbn, m, vec);
    cp_async_commit();
  }
  if (SCAN) scan_unstaged(sm, b, x, kbn, m, vec);
  float acc[kTileRows][kTileCols];
#pragma unroll
  for (int i = 0; i < kTileRows; ++i)
#pragma unroll
    for (int j = 0; j < kTileCols; ++j) acc[i][j] = 0.0f;
  for (int s = 0; s < b.n_steps; ++s) {
    const int e0 = b.c_lo + s * kStep;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = s + kStages - 1;
    if (STAGE && next < b.n_steps)
      stage_chunk(sm, next % kStages, b.c_lo + next * kStep, b, strips, x, kbn, m, vec);
    cp_async_commit();
    if (MATH && e0 + kStep > b.wlo && e0 < b.whi) multiply_chunk(sm, s % kStages, e0, b, acc);
    if (SCAN_IN) scan_chunk(sm, s % kStages, e0);
  }
  cp_async_wait<0>();
  __syncthreads();
  write_tile(sm, b, out, m, vec, acc);
}

template <bool PAIR>
int launch_tf32(const BandLaunch& l, bool f32, size_t xlo, cudaStream_t s, const void* strips,
                const float* xp, const short2* tp, float* o, int kbn, int k, int c0,
                int c_blocks, int m) {
  if (f32)
    return launch_band<float>(tc::tf32_kernel<float, PAIR>, l.grid, xlo, s,
                              static_cast<const float*>(strips), xp, tp, o, l.rows_per_group,
                              l.row_tiles, l.n_ct, kbn, l.bn, k, c0, c_blocks, m);
  return launch_band<__nv_bfloat16>(tc::tf32_kernel<__nv_bfloat16, PAIR>, l.grid,
                                    xlo, s, static_cast<const __nv_bfloat16*>(strips), xp, tp,
                                    o, l.rows_per_group, l.row_tiles, l.n_ct, kbn, l.bn, k, c0,
                                    c_blocks, m);
}

template <bool STAGE, bool MATH, bool SCAN, bool SCAN_IN>
int launch_parts(const BandLaunch& l, bool f32, cudaStream_t s, const void* strips,
                 const float* xp, const short2* tp, float* o, int kbn, int k, int c0,
                 int c_blocks, int m) {
  if (f32)
    return launch_band<float>(parts_kernel<float, STAGE, MATH, SCAN, SCAN_IN>, l.grid, 0, s,
                              static_cast<const float*>(strips), xp, tp, o, l.rows_per_group,
                              l.row_tiles, l.n_ct, kbn, l.bn, k, c0, c_blocks, m);
  return launch_band<__nv_bfloat16>(parts_kernel<__nv_bfloat16, STAGE, MATH, SCAN, SCAN_IN>,
                                    l.grid, 0, s, static_cast<const __nv_bfloat16*>(strips), xp,
                                    tp, o, l.rows_per_group, l.row_tiles, l.n_ct, kbn, l.bn, k,
                                    c0, c_blocks, m);
}

}  // namespace

// sh_spmm_band's arguments with one of the probe's designs forced: 0 every
// slot (the first port's), 1 the shipped span kernel, 2 and 3 the span
// kernel on TF32 tensor cores (warps of 16 rows, warp pairs of 32), 4–7 the
// shipped kernel without its staging, its products, both scans, or the
// scan of the rows it does not stage.
extern "C" int sh_spmm_band_variant(int variant, int device, const void* strips,
                                    const void* x, const void* table, void* out, int r_rows,
                                    int bm, int kbn, int k, int c0, int c_blocks, int m,
                                    int strip_dtype, void* stream) {
  if (variant == 1)
    return sh_spmm_band(device, strips, x, table, out, r_rows, bm, kbn, k, c0, c_blocks, m,
                        strip_dtype, stream);
  BandLaunch l;
  int rc = band_launch(r_rows, bm, kbn, k, c_blocks, m, &l);
  if (rc != cudaSuccess || l.grid.x == 0) return rc;
  rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return rc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xp = static_cast<const float*>(x);
  const short2* tp = static_cast<const short2*>(table);
  float* o = static_cast<float*>(out);
  const bool f32 = strip_dtype == STRIP_F32;
  if (!f32 && strip_dtype != STRIP_BF16) return cudaErrorInvalidValue;
  const size_t xlo = sizeof(float) * kStep * kXStride;
  switch (variant) {
    case 0: {
      const int gs = l.bn / bm;
      const dim3 grid(static_cast<unsigned>(r_rows / gs * l.row_tiles),
                      static_cast<unsigned>((m + slot::kBN - 1) / slot::kBN));
      if (f32)
        slot::slot_kernel<float><<<grid, kThreads, 0, s>>>(
            static_cast<const float*>(strips), xp, o, l.rows_per_group, l.row_tiles, kbn, l.bn,
            k, c0, c_blocks, m);
      else
        slot::slot_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
            static_cast<const __nv_bfloat16*>(strips), xp, o, l.rows_per_group, l.row_tiles,
            kbn, l.bn, k, c0, c_blocks, m);
      break;
    }
    case 2:
    case 3: {
      const auto launch = variant == 2 ? launch_tf32<false> : launch_tf32<true>;
      rc = launch(l, f32, xlo, s, strips, xp, tp, o, kbn, k, c0, c_blocks, m);
      break;
    }
    case 4:
    case 5:
    case 6:
    case 7: {
      const auto launch = variant == 4   ? launch_parts<false, true, true, true>
                          : variant == 5 ? launch_parts<true, false, true, true>
                          : variant == 6 ? launch_parts<true, true, false, false>
                                         : launch_parts<true, true, false, true>;
      rc = launch(l, f32, s, strips, xp, tp, o, kbn, k, c0, c_blocks, m);
      break;
    }
    default: return cudaErrorInvalidValue;
  }
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}
"""

TILES_SOURCE = r"""
#include "spmm_tiles.cu"

namespace {

template <typename L>
int probe_dispatch(int semiring, const L& launch) {
  switch (semiring) {
    case PLUS_TIMES: return launch.template run<PLUS_TIMES, float>();
    case MIN_PLUS: return launch.template run<MIN_PLUS, float>();
    default: return cudaErrorInvalidValue;
  }
}

template <int SPLIT>
int probe_rows(const Args& a, int semiring) {
  RowsLaunch<SPLIT> launch;
  const int rc = rows_launch(a, STRIP_F32, &launch);
  return rc != cudaSuccess ? rc : probe_dispatch(semiring, launch);
}

}  // namespace

// sh_spmm_tiles with the map forced: 0 the tile map, 1, 2, 4 or 8 the row
// map with that many lanes a group. f32 strips, plus_times or min_plus.
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
    case 1: rc = probe_rows<1>(a, semiring); break;
    case 2: rc = probe_rows<2>(a, semiring); break;
    case 4: rc = probe_rows<4>(a, semiring); break;
    case 8: rc = probe_rows<8>(a, semiring); break;
    default: rc = cudaErrorInvalidValue;
  }
  if (rc != cudaSuccess) return rc;
  return static_cast<int>(cudaGetLastError());
}
"""


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def step32_source() -> str:
    """csrc/spmm_band.cu with 32-lane chunks, a ring of 3 and registers for
    2 blocks an SM."""
    from sparseharness_tpu_torch.ops import _build

    text = (_build.CSRC / "spmm_band.cu").read_text()
    for old, new in (("constexpr int kStep = 16;", "constexpr int kStep = 32;"),
                     ("constexpr int kStages = 4;", "constexpr int kStages = 3;"),
                     ("__launch_bounds__(kThreads, 3)", "__launch_bounds__(kThreads, 2)")):
        if old not in text:
            raise RuntimeError(f"spmm_band.cu no longer holds {old!r}")
        text = text.replace(old, new)
    return text


def windows_ms(torch, fn, windows: int = 5, n: int = 20) -> float:
    """The median over ``windows`` windows of ``n`` back-to-back calls of
    the ms a call (CUDA events), after two warm-up calls."""
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


def in_turns(torch, calls: dict) -> dict:
    """Each call timed in order, then in reverse: name -> [ms, ms]."""
    ms = {name: [] for name in calls}
    for name in list(calls) + list(calls)[::-1]:
        ms[name].append(windows_ms(torch, calls[name]))
    return ms


def start_build(name: str, source: str, files=None):
    """Start nvcc on ``source`` (beside it ``files``, name -> text, which it
    includes before csrc/) into build/probe_spmm_wide/<digest>/ unless it
    is built: (process or None, library path)."""
    from sparseharness_tpu_torch.ops import _build

    files = files or {}
    key = _build._digest() + source + "".join(files.values())
    digest = hashlib.sha256(key.encode()).hexdigest()[:16]
    out_dir = os.path.join(ROOT, "build", "probe_spmm_wide", digest)
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, f"{name}.cu")
    lib = os.path.join(out_dir, f"lib{name}.so")
    for fname, text in {f"{name}.cu": source, **files}.items():
        with open(os.path.join(out_dir, fname), "w") as f:
            f.write(text)
    if os.path.exists(lib):
        return None, lib
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", out_dir, "-I", str(_build.CSRC), "-o", lib,
           src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True), lib


def finish_build(name: str, proc, lib: str) -> ctypes.CDLL:
    """Wait for nvcc, print each kernel's registers and spills, load."""
    if proc is not None:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        kernels, entry = {}, None
        for line in log.splitlines():
            if "Compiling entry function" in line or "Function properties for" in line:
                entry = (line.split("'")[1] if "'" in line else line.split()[-1])[:100]
            elif entry is not None and ("Used " in line or "bytes spill" in line):
                kernels.setdefault(entry, []).append(line.split(":", 1)[-1].strip())
        emit({"build": name, "ptxas": kernels,
              "spills": [ln.strip() for ln in log.splitlines()
                         if "bytes spill" in ln and " 0 bytes spill stores" not in ln]})
    return ctypes.CDLL(lib)


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("probe_spmm_wide_cuda: no CUDA device is available", file=sys.stderr)
        return 1
    from sparseharness_tpu_torch.formats import banded_coo, block_random_coo
    from sparseharness_tpu_torch.harness import device_hbm_bandwidth
    from sparseharness_tpu_torch.ops import Geometry, _build, bsr_band, build_operand, spmm_tiles
    from sparseharness_tpu_torch.semiring import MIN_PLUS, PLUS_TIMES

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True, capture_output=True,
                         text=True).stdout.strip(), flush=True)
    bw = device_hbm_bandwidth(torch.cuda.get_device_name(0))
    t0 = time.perf_counter()
    builds = {"band_probe": start_build("band_probe", BAND_SOURCE),
              "band_step32": start_build("band_step32", BAND_SOURCE.replace(
                  '"spmm_band.cu"', '"spmm_band_step32.cu"').replace(
                  "(kThreads, 3)", "(kThreads, 2)"), {"spmm_band_step32.cu": step32_source()}),
              "tiles_probe": start_build("tiles_probe", TILES_SOURCE)}
    libs = {name: finish_build(name, *b) for name, b in builds.items()}
    emit({"build_seconds": time.perf_counter() - t0})
    band_fns = []
    for name in ("band_probe", "band_step32"):
        fn = libs[name].sh_spmm_band_variant
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        band_fns.append(fn)
    tiles_fn = libs["tiles_probe"].sh_spmm_tiles_map
    tiles_fn.restype = ctypes.c_int
    tiles_fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                         + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(47)

    def band_call(code, op, x2d, out, lib=0):
        r_rows, bm, kbn = op.strips.shape
        bn = kbn // op.k_win
        args = (code, op.strips.device.index, op.strips.data_ptr(), x2d.data_ptr(),
                op.spans.table.data_ptr(), out.data_ptr(), r_rows, bm, kbn, op.k_win, op.c0,
                x2d.shape[0] // bn, x2d.shape[1], _build.STRIP_CODES[op.strips.dtype], stream)

        def call():
            rc = band_fns[lib](*args)
            if rc:
                raise RuntimeError(f"band variant {code} launch failed: {rc}")
        return call

    def tol_of(ref, sum_abs):
        return PT_DELTA * torch.maximum(torch.maximum(ref.abs(), sum_abs), torch.ones_like(ref))

    coo = banded_coo(1 << 19, 63, seed=1)
    n = coo.shape[0]
    x256 = torch.rand((n, 256), generator=gen, device="cuda") * 0.9 + 0.1
    rng = np.random.default_rng(53)
    for vd in ("float32", "bfloat16") if "tiles" not in argv else ():
        op = build_operand(coo, PLUS_TIMES, "bsr_band", Geometry(8, 128, vd))
        abs_strips = op.strips.abs()
        args = dict(c0=op.c0, k_win=op.k_win)
        for m in BAND_M:
            x2d = bsr_band.pad_x_block(op, x256 if m == 256 else x256[:, :m].contiguous())
            ref = bsr_band.band_spmm_plain(op.strips, x2d, **args)
            tol = tol_of(ref, bsr_band.band_spmm_plain(abs_strips, x2d, **args))
            calls, errs = {}, {}
            for name, (code, lib) in BAND_CHECKED.items():
                out = torch.full_like(ref, float("nan"))
                calls[name] = band_call(code, op, x2d, out, lib)
                calls[name]()
                torch.cuda.synchronize()
                if not bool(((out - ref).abs() <= tol).all()):
                    raise AssertionError(f"band {vd} m={m}: {name} outside the tolerance")
                errs[name] = float((out - ref).abs().max())
                again = torch.empty_like(out)
                band_call(code, op, x2d, again, lib)()
                torch.cuda.synchronize()
                if not torch.equal(out, again):
                    raise AssertionError(f"band {vd} m={m}: {name} differs on a second call")
            del ref, tol
            for name, code in BAND_PARTS.items():
                calls[name] = band_call(code, op, x2d, torch.empty_like(out))
            ms = in_turns(torch, calls)
            rest = x2d.numel() * 4 + op.strips.shape[0] * op.strips.shape[1] * m * 4
            span_bytes = op.spans.lanes * op.strips.element_size() + rest
            ops_ms = 2 * coo.nnz * m / F32_PEAK_OPS * 1e3
            emit({"shape": "band", "strips": vd, "m": m, "n": n, "nnz": coo.nnz,
                  "bound_ms": max(span_bytes / bw * 1e3, ops_ms),
                  "bound_by": "bytes" if span_bytes / bw * 1e3 >= ops_ms else "operations",
                  "bound_units": "FP32 FMA, 67 TFLOP/s",
                  "layout_bound_ms": max((op.strips.numel() * op.strips.element_size() + rest)
                                         / bw * 1e3, ops_ms),
                  "median_ms": {name: float(np.median(v)) for name, v in ms.items()},
                  "turns_ms": ms, "max_abs_err": errs})
            del x2d
        # non-finite X: ±inf and NaN in 48 places of a 128-column X
        xbad = x256[:, :128].clone()
        rows = torch.as_tensor(rng.integers(0, n, 48), device="cuda")
        cols = torch.as_tensor(rng.integers(0, 128, 48), device="cuda")
        xbad[rows, cols] = torch.tensor([float("inf"), float("-inf"), float("nan")],
                                        device="cuda").repeat(16)
        x2d = bsr_band.pad_x_block(op, xbad)
        ref = bsr_band.band_spmm_plain(op.strips, x2d, **args)
        sum_abs = bsr_band.band_spmm_plain(abs_strips, x2d.abs(), **args)
        fin = sum_abs.isfinite()
        tol = tol_of(ref, sum_abs)
        for name, (code, lib) in BAND_CHECKED.items():
            out = torch.zeros_like(ref)
            band_call(code, op, x2d, out, lib)()
            torch.cuda.synchronize()
            nan_equal = torch.equal(out.isnan(), ref.isnan())
            inf = ref.isinf()
            inf_equal = torch.equal(out[inf], ref[inf])
            within = bool(((out - ref).abs()[fin] <= tol[fin]).all())
            emit({"nonfinite": "band", "strips": vd, "m": 128, "variant": name,
                  "nan": int(ref.isnan().sum()), "inf": int(inf.sum()),
                  "nan_equal": nan_equal, "inf_equal": inf_equal,
                  "finite_checked": int(fin.sum()), "within_tolerance": within})
            if not (nan_equal and inf_equal and within):
                raise AssertionError(f"band {vd}: {name} fails on non-finite X")
        del op, abs_strips, x2d, ref, sum_abs, fin, tol, xbad
    del x256

    bcoo = block_random_coo(131072, 2, bm=8, bn=128, seed=5)
    n = bcoo.shape[0]
    x256 = torch.rand((n, 256), generator=gen, device="cuda") * 0.9 + 0.1
    for sr in (PLUS_TIMES, MIN_PLUS) if "band" not in argv else ():
        op = build_operand(bcoo, sr, "bsr_ell")
        r_blocks, bm, kbn = op.tiles.shape
        k = op.tile_cols.shape[1]
        bn = kbn // k
        for m in BLOCKED_M:
            x2d = spmm_tiles.pad_x_block(x256 if m == 256 else x256[:, :m].contiguous(), bn, sr)
            ref = spmm_tiles.spmm_tiles_plain(op.tiles, op.tile_cols, x2d, sr)
            tol = None
            if sr is PLUS_TIMES:
                tol = tol_of(ref, spmm_tiles.spmm_tiles_plain(op.tiles.abs(), op.tile_cols,
                                                              x2d.abs(), PLUS_TIMES))
            calls = {}
            for name, code in TILE_MAPS.items():
                out = torch.full_like(ref, float("nan"))
                a = (op.tiles.device.index, op.tiles.data_ptr(), op.tile_cols.data_ptr(),
                     x2d.data_ptr(), out.data_ptr(), r_blocks, bm, kbn, k, m,
                     x2d.shape[0] // bn, _build.SR_CODES[sr.name], code, stream)
                if tiles_fn(*a):
                    continue  # this map cannot take the shape
                torch.cuda.synchronize()
                ok = (bool(((out - ref).abs() <= tol).all()) if tol is not None
                      else torch.equal(out, ref))
                if not ok:
                    raise AssertionError(f"blocked {sr.name} m={m}: {name} differs from plain")

                def call(a=a, name=name):
                    if tiles_fn(*a):
                        raise RuntimeError(f"map {name} launch failed")
                calls[name] = call
            del ref, tol
            ms = in_turns(torch, calls)
            rest = op.tile_cols.numel() * 4 + x2d.numel() * 4 + r_blocks * bm * m * 4
            n_bytes = op.tiles.numel() * op.tiles.element_size() + rest
            bytes_ms, ops_ms = n_bytes / bw * 1e3, 2 * bcoo.nnz * m / F32_PEAK_OPS * 1e3
            x_slot = k * bn * m * 4  # a tile slot's X block
            emit({"shape": "blocked", "semiring": sr.name, "m": m,
                  "tiles": list(op.tiles.shape), "bound_ms": max(bytes_ms, ops_ms),
                  "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                  "bound_units": "FP32, 67 TFLOP/s",
                  "x_read_bytes": {"rows": r_blocks * bm // 8 * x_slot,
                                   "tiles": r_blocks * x_slot},
                  "median_ms": {name: (float(np.median(ms[name])) if name in ms else None)
                                for name in TILE_MAPS},
                  "turns_ms": ms})
            del x2d
        del op
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

// What every SpMV kernel of the port shares: the seven semirings as
// functors, the strip loads, the warp ⊕-reduce, and the dispatch from the
// C interface's semiring and strip type codes to a template instantiation.
//
// Bit-exactness: min/max/or reductions are exact whatever the order, and
// each product is rounded once, so every semiring but plus_times gives the
// plain torch version's result bit for bit. The inputs hold no NaN:
// fminf/fmaxf differ from torch.minimum/maximum (and jnp.minimum/maximum)
// only on NaN. min_plus pads (FLT_MAX + FLT_MAX) overflow to +inf, as in the
// plain version; the fold's ⊕-clamp removes them. nvcc may contract
// plus_times' acc + x·a into an FMA, which only plus_times, held to a
// tolerance, sees.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <cstdint>
#include <type_traits>

namespace sh {

constexpr int kThreads = 256;  // 8 warps per block
constexpr int kWarps = kThreads / 32;

// semiring codes, as sparseharness_tpu_torch/ops/_build.py:SR_CODES
enum SrCode {
  PLUS_TIMES = 0,
  MIN_PLUS = 1,
  OR_AND = 2,  // int32 carrier: ⊕ = max, ⊗ = min on {0, 1}
  MAX_MIN = 3,
  MAX_TIMES = 4,
  MAX_RIGHT = 5,
  MIN_RIGHT = 6,
};

// strip dtype codes, as ops/_build.py:STRIP_CODES; bool (one byte, 0 or 1)
// is dia.cu's or_and values, which no other kernel takes
enum StripCode { STRIP_F32 = 0, STRIP_BF16 = 1, STRIP_I32 = 2, STRIP_BOOL = 3 };

// identity: the true identity of ⊕, which every partial starts from;
// zero: the semiring zero (0̄), which the gen-1 tile kernel seeds a row with
template <int SR>
struct Op;

template <>
struct Op<PLUS_TIMES> {
  using T = float;
  __device__ static T identity() { return 0.0f; }
  __device__ static T zero() { return 0.0f; }
  __device__ static T add(T a, T b) { return a + b; }
  __device__ static T mul(T x, T a) { return x * a; }
};

template <>
struct Op<MIN_PLUS> {
  using T = float;
  __device__ static T identity() { return __int_as_float(0x7f800000); }  // +inf
  __device__ static T zero() { return __int_as_float(0x7f7fffff); }      // FLT_MAX
  __device__ static T add(T a, T b) { return fminf(a, b); }
  __device__ static T mul(T x, T a) { return x + a; }
};

template <>
struct Op<OR_AND> {
  using T = int;
  __device__ static T identity() { return INT_MIN; }
  __device__ static T zero() { return 0; }
  __device__ static T add(T a, T b) { return max(a, b); }
  __device__ static T mul(T x, T a) { return min(x, a); }
};

template <>
struct Op<MAX_MIN> {
  using T = float;
  __device__ static T identity() { return -__int_as_float(0x7f800000); }  // -inf
  __device__ static T zero() { return -__int_as_float(0x7f7fffff); }      // -FLT_MAX
  __device__ static T add(T a, T b) { return fmaxf(a, b); }
  __device__ static T mul(T x, T a) { return fminf(x, a); }
};

template <>
struct Op<MAX_TIMES> {
  using T = float;
  __device__ static T identity() { return -__int_as_float(0x7f800000); }  // -inf
  __device__ static T zero() { return 0.0f; }
  __device__ static T add(T a, T b) { return fmaxf(a, b); }
  __device__ static T mul(T x, T a) { return x * a; }
};

template <>
struct Op<MAX_RIGHT> {
  using T = int;
  __device__ static T identity() { return INT_MIN; }
  __device__ static T zero() { return INT_MIN; }
  __device__ static T add(T a, T b) { return max(a, b); }
  __device__ static T mul(T x, T a) { return a == INT_MIN ? a : x; }
};

template <>
struct Op<MIN_RIGHT> {
  using T = int;
  __device__ static T identity() { return INT_MAX; }
  __device__ static T zero() { return INT_MAX; }
  __device__ static T add(T a, T b) { return min(a, b); }
  __device__ static T mul(T x, T a) { return a == INT_MAX ? a : x; }
};

// IEEE 754-2019 maximum and minimum: NaN propagates (max.NaN and min.NaN),
// and of two zeros the maximum is +0 unless both are −0, the minimum −0
// unless both are +0
__device__ __forceinline__ float max_ieee(float a, float b) {
  float m;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return a == b ? __int_as_float(__float_as_int(a) & __float_as_int(b)) : m;
}

__device__ __forceinline__ float min_ieee(float a, float b) {
  float m;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(m) : "f"(a), "f"(b));
  return a == b ? __int_as_float(__float_as_int(a) | __float_as_int(b)) : m;
}

// Op<SR> with the IEEE minimum and maximum for the float ⊕ (and max_min's
// ⊗): the band and diagonal kernels' semiring, whose float min and max do
// not depend on the order of their operands
template <int SR>
struct Ieee {
  using O = Op<SR>;
  using T = typename O::T;
  __device__ static T identity() { return O::identity(); }
  __device__ static T add(T a, T b) {
    if constexpr (SR == MIN_PLUS) return min_ieee(a, b);
    else if constexpr (SR == MAX_MIN || SR == MAX_TIMES) return max_ieee(a, b);
    else return O::add(a, b);
  }
  __device__ static T mul(T x, T a) {
    if constexpr (SR == MAX_MIN) return min_ieee(x, a);
    else return O::mul(x, a);
  }
};

// four consecutive strip entries, converted to the compute type, with a
// streaming load (the strips are read once and should not evict x from
// L2); the caller guarantees 16-byte (f32, int32) or 8-byte (bf16)
// alignment
__device__ __forceinline__ void load_strip4(const float* p, float (&v)[4]) {
  const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load_strip4(const int* p, int (&v)[4]) {
  const int4 t = __ldcs(reinterpret_cast<const int4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load_strip4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 t = __ldcs(reinterpret_cast<const uint2*>(p));
  // little endian: the lower half of each word is the earlier element
  v[0] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(t.x & 0xffffu)));
  v[1] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(t.x >> 16)));
  v[2] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(t.y & 0xffffu)));
  v[3] = __bfloat162float(__ushort_as_bfloat16(static_cast<unsigned short>(t.y >> 16)));
}

// one strip entry in the compute type, with a streaming load
__device__ __forceinline__ float load_strip1(const float* p) { return __ldcs(p); }
__device__ __forceinline__ int load_strip1(const int* p) { return __ldcs(p); }
__device__ __forceinline__ float load_strip1(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldcs(reinterpret_cast<const unsigned short*>(p))));
}

// four consecutive x entries from shared memory (SHARED) or through the
// read-only cache; 16-byte aligned
template <bool SHARED>
__device__ __forceinline__ void load_x4(const float* p, float (&v)[4]) {
  const float4 t = SHARED ? *reinterpret_cast<const float4*>(p)
                          : __ldg(reinterpret_cast<const float4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

template <bool SHARED>
__device__ __forceinline__ void load_x4(const int* p, int (&v)[4]) {
  const int4 t = SHARED ? *reinterpret_cast<const int4*>(p)
                        : __ldg(reinterpret_cast<const int4*>(p));
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// ⊕ of mul(x[i], a[i]) for i < 4 into acc
template <int SR>
__device__ __forceinline__ typename Op<SR>::T mul_add4(
    typename Op<SR>::T acc, const typename Op<SR>::T (&x)[4],
    const typename Op<SR>::T (&a)[4]) {
  using O = Op<SR>;
  acc = O::add(acc, O::mul(x[0], a[0]));
  acc = O::add(acc, O::mul(x[1], a[1]));
  acc = O::add(acc, O::mul(x[2], a[2]));
  acc = O::add(acc, O::mul(x[3], a[3]));
  return acc;
}

// ⊕ across the 32 lanes of a warp; every lane gets the result
template <int SR>
__device__ __forceinline__ typename Op<SR>::T warp_reduce(typename Op<SR>::T v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v = Op<SR>::add(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// Calls f.template run<SR, S>() for a semiring code and a strip type code:
// the float semirings take f32 or bf16 strips, the int32 carriers int32
// strips. Returns cudaErrorInvalidValue for any other pair, else what
// run returns.
template <int SR, typename F>
int dispatch_strip(int strip_dtype, const F& f) {
  if constexpr (std::is_same<typename Op<SR>::T, float>::value) {
    if (strip_dtype == STRIP_F32) return f.template run<SR, float>();
    if (strip_dtype == STRIP_BF16) return f.template run<SR, __nv_bfloat16>();
    return cudaErrorInvalidValue;
  } else {
    if (strip_dtype == STRIP_I32) return f.template run<SR, int>();
    return cudaErrorInvalidValue;
  }
}

template <typename F>
int dispatch(int semiring, int strip_dtype, const F& f) {
  switch (semiring) {
    case PLUS_TIMES: return dispatch_strip<PLUS_TIMES>(strip_dtype, f);
    case MIN_PLUS: return dispatch_strip<MIN_PLUS>(strip_dtype, f);
    case OR_AND: return dispatch_strip<OR_AND>(strip_dtype, f);
    case MAX_MIN: return dispatch_strip<MAX_MIN>(strip_dtype, f);
    case MAX_TIMES: return dispatch_strip<MAX_TIMES>(strip_dtype, f);
    case MAX_RIGHT: return dispatch_strip<MAX_RIGHT>(strip_dtype, f);
    case MIN_RIGHT: return dispatch_strip<MIN_RIGHT>(strip_dtype, f);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sh

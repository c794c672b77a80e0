// Shared helpers for the port's kernels: element-type codes, float
// conversion, and 8-element vector loads / stores (16-byte accesses).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Element-type codes; kernels/cuda_lib.py DTYPE_CODES mirrors them.
enum ReproDtype { REPRO_F32 = 0, REPRO_BF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
// Round to nearest even, as jnp's and torch's f32 -> bf16 casts do.
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 8 consecutive elements <-> 8 floats.  The vector forms need the
// address 16-byte aligned; callers check that once per launch.
template <typename T> struct Vec8;

template <> struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* p, float out[8]) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float in[8]) {
    reinterpret_cast<float4*>(p)[0] = make_float4(in[0], in[1], in[2], in[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(in[4], in[5], in[6], in[7]);
  }
};

template <> struct Vec8<__nv_bfloat16> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float out[8]) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      // bf16 -> f32 is the 16 bits moved to the top of the word.
      out[2 * i] = __uint_as_float(w[i] << 16);
      out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float in[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 pair = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&pair);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

static inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

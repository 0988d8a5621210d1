// Shared helpers for the port's kernels: 4-wide and scalar loads/stores of
// float32 and bfloat16 rows, with every value widened to float32, and the
// hash edge-drop.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dgc {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float32 value to T and back (identity for float32): the kernels
// round per-edge terms to the compute type exactly where the TPU kernel does.
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// VEC consecutive elements starting at p, as float32.  VEC is 4 (16-byte
// float32 or 8-byte bfloat16 loads; the caller guarantees alignment) or 1.
template <typename T, int VEC> struct Rows;

template <typename T> struct Rows<T, 1> {
  __device__ __forceinline__ static void load(const T* p, float* v) { v[0] = to_f32(p[0]); }
  __device__ __forceinline__ static void store(T* p, const float* v) { p[0] = from_f32<T>(v[0]); }
};

template <> struct Rows<float, 4> {
  __device__ __forceinline__ static void load(const float* p, float* v) {
    float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <> struct Rows<__nv_bfloat16, 4> {
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, float* v) {
    uint2 a = *reinterpret_cast<const uint2*>(p);
    float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.x));
    float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&a.y));
    v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* v) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 a;
    a.x = *reinterpret_cast<uint32_t*>(&lo);
    a.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = a;
  }
};

constexpr int kWarpsPerBlock = 8;

inline int blocks_for_rows(int n_rows) {
  return (n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
}

// The GAT attention weight of a sender-only score: exp(leaky_relu(el) - cmax),
// with the plain version's roundings (no fma contraction).
__device__ __forceinline__ float gat_weight(float el, float cmax, float neg_slope) {
  const float s = el >= 0.f ? el : __fmul_rn(neg_slope, el);
  return expf(__fsub_rn(s, cmax));
}

// The hash edge-drop's keep decision for the edge (recv, send): the uint32
// mixer of `_hash_keep` (deep_gcns_torch_tpu/ops/band.py:158-165), bit for bit.
__device__ __forceinline__ bool hash_keep(uint32_t recv, uint32_t send, uint32_t k0,
                                          uint32_t k1, int thresh) {
  uint32_t h = recv * 0x9E3779B9u + k0;
  h ^= send * 0x85EBCA6Bu + k1;
  h ^= h >> 16;
  h *= 668265295u;  // 0x27D4EB4F, the JAX code's decimal constant
  h ^= h >> 15;
  return static_cast<int>(h & 0x7FFFFFFFu) >= thresh;
}

}  // namespace dgc

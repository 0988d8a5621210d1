// K2: fused gather + GENConv message + softmax aggregation (no edge
// embeddings).  For each receiver row n and channel c:
//
//   m_e   = relu(x[senders[e], c]) + eps                       (float32)
//   w_e   = exp(t * m_e - cmax[c])                              (<= 1)
//   num   = sum_e round_T(w_e * m_e),  den = sum_e round_T(w_e)  (float32)
//   out[n, c] = den > 0 ? num / den : 0,   den_out[n, c] = den   (both in T)
//
// over e in [row_ptr[n], row_ptr[n+1]).  round_T is the rounding to the
// compute type that the TPU kernel applies before its float32 accumulation
// (spmm_pallas.py:348-349), so kernel and plain version differ only in the
// order of the sums.  cmax is the per-channel GLOBAL bound of `_fused_cmax`
// (spmm_pallas.py:649-662), computed outside the kernel; it must not become a
// per-receiver max, because the node-factored backward
// dx = relu'(x) * exp(t*m - cmax) * A^T(g/den) needs one shift for every
// receiver.  t arrives as a device pointer so that the host never waits.
//
// Replaces the TPU kernel `_softmax_agg_kernel` (spmm_pallas.py:322, called
// at :372), which streamed pre-gathered x[senders] tiles (an XLA gather at
// :699) through a one-hot MXU matmul.  Here the gather is fused: each warp
// owns one receiver row, lanes span the channels, and every edge's sender row
// is read straight from x.
//
// What bounds it on the H100: at the main shape (2.54M edges, C=128, bf16)
// the bytes are one gathered row per edge plus the node tables, and the
// operations are one exp per (edge, channel) on the special-function units;
// chip_smoke.py prints which bound is larger for the run.  The design issues
// four independent sender-row loads per step to keep several in flight and
// uses accurate expf (the plain version's exp) rather than __expf.  Note that
// x (43 MB in bf16 at the main shape) fits the 50 MB L2, so most of the
// per-edge row reads hit L2 rather than HBM.
#include "common.cuh"

namespace dgc {

template <typename T, int VEC>
__device__ __forceinline__ void accumulate(const float* xv, const float* cm, float t,
                                           float eps, float* num, float* den) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float m = fmaxf(xv[k], 0.f) + eps;
    // explicit roundings keep nvcc from contracting t*m - cmax into one fma,
    // so each term is bit for bit the plain version's and only the order of
    // the sums differs
    const float w = expf(__fsub_rn(__fmul_rn(m, t), cm[k]));
    num[k] += round_to<T>(w * m);
    den[k] += round_to<T>(w);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
softmax_agg_kernel(const T* __restrict__ x, const int* __restrict__ senders,
                   const int* __restrict__ row_ptr, const float* __restrict__ t_ptr,
                   const float* __restrict__ cmax, T* __restrict__ out,
                   T* __restrict__ den_out, int n_rows, int C, float eps) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int start = row_ptr[row];
  const int end = row_ptr[row + 1];
  const float t = *t_ptr;
  for (int c0 = lane * VEC; c0 < C; c0 += 32 * VEC) {
    float cm[VEC], num[VEC], den[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      cm[k] = cmax[c0 + k];
      num[k] = 0.f;
      den[k] = 0.f;
    }
    int e = start;
    for (; e + 4 <= end; e += 4) {
      float v[4][VEC];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        Rows<T, VEC>::load(x + (long long)senders[e + u] * C + c0, v[u]);
#pragma unroll
      for (int u = 0; u < 4; ++u) accumulate<T, VEC>(v[u], cm, t, eps, num, den);
    }
    for (; e < end; ++e) {
      float v[VEC];
      Rows<T, VEC>::load(x + (long long)senders[e] * C + c0, v);
      accumulate<T, VEC>(v, cm, t, eps, num, den);
    }
    float o[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) o[k] = den[k] > 0.f ? num[k] / den[k] : 0.f;
    Rows<T, VEC>::store(out + (long long)row * C + c0, o);
    Rows<T, VEC>::store(den_out + (long long)row * C + c0, den);
  }
}

template <typename T>
int launch_softmax_agg(const void* x, const void* senders, const void* row_ptr,
                       const void* t, const void* cmax, void* out, void* den,
                       int n_rows, int C, float eps, int vec, void* stream) {
  const dim3 grid(blocks_for_rows(n_rows)), block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    softmax_agg_kernel<T, 4><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const int*>(senders),
        static_cast<const int*>(row_ptr), static_cast<const float*>(t),
        static_cast<const float*>(cmax), static_cast<T*>(out), static_cast<T*>(den),
        n_rows, C, eps);
  } else {
    softmax_agg_kernel<T, 1><<<grid, block, 0, s>>>(
        static_cast<const T*>(x), static_cast<const int*>(senders),
        static_cast<const int*>(row_ptr), static_cast<const float*>(t),
        static_cast<const float*>(cmax), static_cast<T*>(out), static_cast<T*>(den),
        n_rows, C, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes; returns cudaGetLastError() after the launch.
extern "C" int dgc_softmax_agg_f32(const void* x, const void* senders, const void* row_ptr,
                                   const void* t, const void* cmax, void* out, void* den,
                                   int n_rows, int C, float eps, int vec, void* stream) {
  return dgc::launch_softmax_agg<float>(x, senders, row_ptr, t, cmax, out, den, n_rows,
                                        C, eps, vec, stream);
}

extern "C" int dgc_softmax_agg_bf16(const void* x, const void* senders, const void* row_ptr,
                                    const void* t, const void* cmax, void* out, void* den,
                                    int n_rows, int C, float eps, int vec, void* stream) {
  return dgc::launch_softmax_agg<__nv_bfloat16>(x, senders, row_ptr, t, cmax, out, den,
                                                n_rows, C, eps, vec, stream);
}

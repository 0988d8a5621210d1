// K1: CSR segment sum with an optional fused row gather.
//
//   out[n, :] = sum_{e in [ptr[n], ptr[n+1])} src[idx ? idx[e] : e, :]
//
// Replaces the TPU kernel `_seg_sum_kernel`
// (deep_gcns_torch_tpu/ops/spmm_pallas.py:252, called at :285), which scatters
// edge tiles into 128-row node blocks through a one-hot matmul on the MXU.
// On Hopper the segments are contiguous edge ranges, so each warp owns one
// output row and walks its range: no one-hot product, no atomics, and the
// result is deterministic (edges are summed in order, in float32).
//
// What bounds it on the H100: bytes.  Each edge reads one C-wide row of src
// (256 bytes at C=128 in bf16) and does C adds, far below the card's
// operations-per-byte balance.  The design keeps the reads as wide as it can
// (16-byte float32 / 8-byte bf16 loads, 32 lanes across the channels) and
// issues four independent row loads per step so that several are in flight.
// With `idx` the gather of the node-factored GENConv backward
// (spmm_pallas.py:747-750: take(qo, csc_receivers) then this sum) happens
// inside the kernel, so the [E, C] gathered intermediate is never written.
// Hub rows (one very long range) serialise in one warp; balancing them is
// later work.
#include "common.cuh"

namespace dgc {

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
seg_sum_kernel(const T* __restrict__ src, const int* __restrict__ idx,
               const int* __restrict__ ptr, T* __restrict__ out, int n_rows, int C) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int start = ptr[row];
  const int end = ptr[row + 1];
  for (int c0 = lane * VEC; c0 < C; c0 += 32 * VEC) {
    float acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
    int e = start;
    for (; e + 4 <= end; e += 4) {
      float v[4][VEC];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long r = idx ? idx[e + u] : (e + u);
        Rows<T, VEC>::load(src + r * C + c0, v[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] += v[u][k];
    }
    for (; e < end; ++e) {
      float v[VEC];
      const long long r = idx ? idx[e] : e;
      Rows<T, VEC>::load(src + r * C + c0, v);
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += v[k];
    }
    Rows<T, VEC>::store(out + (long long)row * C + c0, acc);
  }
}

template <typename T>
int launch_seg_sum(const void* src, const void* idx, const void* ptr, void* out,
                   int n_rows, int C, int vec, void* stream) {
  const dim3 grid(blocks_for_rows(n_rows)), block(kWarpsPerBlock * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    seg_sum_kernel<T, 4><<<grid, block, 0, s>>>(
        static_cast<const T*>(src), static_cast<const int*>(idx),
        static_cast<const int*>(ptr), static_cast<T*>(out), n_rows, C);
  } else {
    seg_sum_kernel<T, 1><<<grid, block, 0, s>>>(
        static_cast<const T*>(src), static_cast<const int*>(idx),
        static_cast<const int*>(ptr), static_cast<T*>(out), n_rows, C);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes.  `idx` may be null (no gather).  `vec` is 4
// when C % 4 == 0 and the row pointers are aligned for wide loads, else 1.
// Returns cudaGetLastError() after the launch.
extern "C" int dgc_seg_sum_f32(const void* src, const void* idx, const void* ptr,
                               void* out, int n_rows, int C, int vec, void* stream) {
  return dgc::launch_seg_sum<float>(src, idx, ptr, out, n_rows, C, vec, stream);
}

extern "C" int dgc_seg_sum_bf16(const void* src, const void* idx, const void* ptr,
                                void* out, int n_rows, int C, int vec, void* stream) {
  return dgc::launch_seg_sum<__nv_bfloat16>(src, idx, ptr, out, n_rows, C, vec, stream);
}

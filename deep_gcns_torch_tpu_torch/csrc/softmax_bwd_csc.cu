// K4: the backward of the fused softmax aggregation with edge embeddings, in
// sender (CSC) order.  For each sender row s and channel c, over the edges
// e in [col_ptr[s], col_ptr[s+1]) with receiver r = csc_receivers[e]:
//
//   xj  = x[s, c] + ee_csc[e, c],  m = relu(xj) + eps,
//   w   = exp(t * m - cmax[c])                                   (<= 1)
//   q   = qo[r, c]              (g/den, rounded to T by the caller)
//   dm  = q*w*(1 + t*(m - o))   with o = qo[r, C + c] = out[r, c]  (GW)
//       = q*w                                                 (otherwise)
//   dxj = xj > 0 ? dm : 0
//   dee_csc[e, c] = round_T(dxj),   dx[s, c] = sum_e round_T(dxj)  (float32 sum)
//   dt  = sum over (e, c) of q*w*m*(m - o)                           (GW only)
//
// Replaces the TPU kernel `_softmax_bwd_csc_kernel` (spmm_pallas.py:466,
// called at :629).  That kernel walks 128-sender blocks, rebuilds each edge's
// x_j with a transposed one-hot MXU product, streams q[csc_receivers] that
// XLA gathered into an [E, C] or [E, 2C] array beforehand (:768), and writes
// d(ee) back through a ring of VMEM buffers.  Here one warp owns one sender
// row with the lanes across the channels: x[s] is read once into registers,
// the edge range is contiguous in CSC order so ee_csc and dee_csc stream
// coalesced, and the receiver's row of qo is gathered inside the kernel, so
// the [E, C] gathered array is never written.  dt is written as one float32
// partial per sender row (a warp shuffle sum) that one torch.sum adds up: no
// float atomics, so the result does not change from run to run.  dee rows
// outside [col_ptr[0], col_ptr[n_rows]) (the sentinel padding) are zeroed by
// a grid-stride loop of the same launch.
//
// What bounds it on the H100: bytes.  Per (edge, channel) it reads one ee
// value and one or two gathered qo values and writes one dee value, against
// about 15 float32 operations and one exp; the node tables are small beside
// the edge streams at the cluster shape (780k edges, 13k nodes).  The design
// keeps four edges' loads in flight per step, as K1 and K2 do, and rounds
// every per-edge term exactly where the TPU kernel does (the explicit
// __f*_rn intrinsics stop nvcc from contracting them into fmas, so each term
// is bit for bit the plain version's).
#include "common.cuh"

namespace dgc {

template <typename T, int VEC, bool GW>
__device__ __forceinline__ void edge_terms(const float* xs, const float* ev, const float* q,
                                           const float* o, const float* cm, float t,
                                           float eps, float* d, float* acc, float* dt) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float xj = xs[k] + ev[k];
    const float m = fmaxf(xj, 0.f) + eps;
    const float w = expf(__fsub_rn(__fmul_rn(m, t), cm[k]));
    const float qw = __fmul_rn(q[k], w);
    float dm = qw;
    if (GW) {
      const float dl = __fsub_rn(m, o[k]);
      dm = __fmul_rn(qw, __fadd_rn(1.f, __fmul_rn(t, dl)));
      *dt += __fmul_rn(__fmul_rn(qw, m), dl);
    }
    d[k] = xj > 0.f ? dm : 0.f;
    acc[k] += round_to<T>(d[k]);
  }
}

template <typename T, int VEC, bool GW>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
softmax_bwd_csc_kernel(const T* __restrict__ x, const T* __restrict__ ee,
                       const T* __restrict__ qo, const int* __restrict__ col_ptr,
                       const int* __restrict__ receivers, const float* __restrict__ t_ptr,
                       const float* __restrict__ cmax, T* __restrict__ dx,
                       T* __restrict__ dee, float* __restrict__ dt_part, int n_rows, int C,
                       long long e_pad, float eps) {
  {  // zero the dee rows that no sender range covers
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long lo = (long long)col_ptr[0] * C, hi = (long long)col_ptr[n_rows] * C;
    for (long long i = tid; i < lo; i += stride) dee[i] = from_f32<T>(0.f);
    for (long long i = hi + tid; i < e_pad * C; i += stride) dee[i] = from_f32<T>(0.f);
  }
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // the whole warp leaves together
  const int start = col_ptr[row];
  const int end = col_ptr[row + 1];
  const float t = *t_ptr;
  const long long qs = GW ? 2LL * C : (long long)C;  // row stride of qo
  float dt = 0.f;
  for (int c0 = lane * VEC; c0 < C; c0 += 32 * VEC) {
    float xs[VEC], cm[VEC], acc[VEC];
    Rows<T, VEC>::load(x + (long long)row * C + c0, xs);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      cm[k] = cmax[c0 + k];
      acc[k] = 0.f;
    }
    int e = start;
    for (; e + 4 <= end; e += 4) {
      float ev[4][VEC], q[4][VEC], o[4][VEC];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long r = receivers[e + u];
        Rows<T, VEC>::load(ee + (long long)(e + u) * C + c0, ev[u]);
        Rows<T, VEC>::load(qo + r * qs + c0, q[u]);
        if (GW) Rows<T, VEC>::load(qo + r * qs + C + c0, o[u]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float d[VEC];
        edge_terms<T, VEC, GW>(xs, ev[u], q[u], o[u], cm, t, eps, d, acc, &dt);
        Rows<T, VEC>::store(dee + (long long)(e + u) * C + c0, d);
      }
    }
    for (; e < end; ++e) {
      const long long r = receivers[e];
      float ev[VEC], q[VEC], o[VEC], d[VEC];
      Rows<T, VEC>::load(ee + (long long)e * C + c0, ev);
      Rows<T, VEC>::load(qo + r * qs + c0, q);
      if (GW) Rows<T, VEC>::load(qo + r * qs + C + c0, o);
      edge_terms<T, VEC, GW>(xs, ev, q, o, cm, t, eps, d, acc, &dt);
      Rows<T, VEC>::store(dee + (long long)e * C + c0, d);
    }
    Rows<T, VEC>::store(dx + (long long)row * C + c0, acc);
  }
  if (GW) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dt += __shfl_down_sync(0xffffffffu, dt, off);
    if (lane == 0) dt_part[row] = dt;
  }
}

template <typename T, int VEC, bool GW>
void launch_one(const void* x, const void* ee, const void* qo, const void* col_ptr,
                const void* receivers, const void* t, const void* cmax, void* dx, void* dee,
                void* dt_part, int n_rows, int C, long long e_pad, float eps,
                cudaStream_t s) {
  const dim3 grid(blocks_for_rows(n_rows)), block(kWarpsPerBlock * 32);
  softmax_bwd_csc_kernel<T, VEC, GW><<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(ee), static_cast<const T*>(qo),
      static_cast<const int*>(col_ptr), static_cast<const int*>(receivers),
      static_cast<const float*>(t), static_cast<const float*>(cmax), static_cast<T*>(dx),
      static_cast<T*>(dee), static_cast<float*>(dt_part), n_rows, C, e_pad, eps);
}

template <typename T>
int launch_softmax_bwd_csc(const void* x, const void* ee, const void* qo, const void* col_ptr,
                           const void* receivers, const void* t, const void* cmax, void* dx,
                           void* dee, void* dt_part, int n_rows, int C, long long e_pad,
                           float eps, int grad_weights, int vec, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define DGC_K4_ARGS x, ee, qo, col_ptr, receivers, t, cmax, dx, dee, dt_part, n_rows, C, e_pad, eps, s
  if (vec == 4) {
    if (grad_weights) launch_one<T, 4, true>(DGC_K4_ARGS);
    else launch_one<T, 4, false>(DGC_K4_ARGS);
  } else {
    if (grad_weights) launch_one<T, 1, true>(DGC_K4_ARGS);
    else launch_one<T, 1, false>(DGC_K4_ARGS);
  }
#undef DGC_K4_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes.  x, ee (the embeddings in CSC order), qo, dx
// and dee share one type; qo is [N_pad, C] or, with grad_weights, [N_pad, 2C]
// holding [q | out]; dt_part is [n_rows] float32, used only with
// grad_weights (may be null otherwise).  Returns cudaGetLastError() after the
// launch.
extern "C" int dgc_softmax_bwd_csc_f32(const void* x, const void* ee, const void* qo,
                                       const void* col_ptr, const void* receivers,
                                       const void* t, const void* cmax, void* dx, void* dee,
                                       void* dt_part, int n_rows, int C, long long e_pad,
                                       float eps, int grad_weights, int vec, void* stream) {
  return dgc::launch_softmax_bwd_csc<float>(x, ee, qo, col_ptr, receivers, t, cmax, dx, dee,
                                            dt_part, n_rows, C, e_pad, eps, grad_weights,
                                            vec, stream);
}

extern "C" int dgc_softmax_bwd_csc_bf16(const void* x, const void* ee, const void* qo,
                                        const void* col_ptr, const void* receivers,
                                        const void* t, const void* cmax, void* dx, void* dee,
                                        void* dt_part, int n_rows, int C, long long e_pad,
                                        float eps, int grad_weights, int vec, void* stream) {
  return dgc::launch_softmax_bwd_csc<__nv_bfloat16>(x, ee, qo, col_ptr, receivers, t, cmax,
                                                    dx, dee, dt_part, n_rows, C, e_pad, eps,
                                                    grad_weights, vec, stream);
}

// K6: the backward of K5 in sender (CSC) order.  For each sender row s and
// head h, with el = T[s, H*D + h], msg = T[s, h*D : (h+1)*D],
// w = exp(leaky_relu(el) - cmax[h]) and lr' = (el >= 0 ? 1 : neg_slope),
// over the edges e in [col_ptr[s], col_ptr[s+1]) with receiver
// r = csc_receivers[e] that are kept (keep[e] != 0, or every edge without
// `keep`):
//
//   gnum = g[r, h*D : (h+1)*D],  gden = g[r, H*D + h]     (g in T's type)
//   dT[s, h*D + d] = sum_e round_T(w * gnum[d])
//   dT[s, H*D + h] = sum_e round_T((<msg, gnum> + gden) * w * lr')
//
// in float32, written in T's type, with zeros in the columns past H*D + H.
// A dropped edge's cotangent is zero in the TPU kernel (its gathered rows are
// zeroed by `keep_csc`, spmm_pallas.py:963-966), so skipping it is exact.
// Each edge term is rounded to T where the TPU kernel rounds it
// (spmm_pallas.py:881-883); the per-head dot <msg, gnum> is a float32 warp
// reduction, so it is summed in another order than the plain version's.
//
// Replaces the TPU kernel `_gat_bwd_kernel` (spmm_pallas.py:862, called at
// :969).  That kernel rebuilds each edge's T row with a transposed one-hot
// MXU product of a 128-sender block and streams g[csc_receivers], gathered by
// XLA into an [E, P] array beforehand (:963-966).  Here one warp owns one
// (sender row, head) pair: the score depends on the sender alone, so w, lr'
// and the row's msg are read once into registers, and each edge's receiver
// row of g is gathered inside the kernel, so the [E, P] array is never
// written.  The lanes span the head's D columns; the dot is a butterfly
// reduction over the warp, so every lane holds it without a broadcast.  No
// atomics: each warp writes its own columns of its own row.
//
// What bounds it on the H100: bytes.  Per (edge, head) it reads D + 1
// gathered values of g and does about 5 float32 operations per value; T and
// g read once and dT written once are 3 x 263 MB at the first layer in bf16.
// Up to four edges' row loads are in flight per step, and their four dot
// reductions interleave.
#include "common.cuh"

namespace dgc {

template <typename T, int VEC, int NCH, int U>
__device__ __forceinline__ void gat_bwd_edges(const T* __restrict__ g,
                                              const int* __restrict__ recv,
                                              const unsigned char* __restrict__ keep, int e,
                                              long long P, int base, int elc, int D, int lane,
                                              float w, float slope,
                                              const float (&msg)[NCH][VEC],
                                              float (&acc)[NCH][VEC], float& acc_el) {
  bool kept[U];
  float gden[U], dot[U];
  float v[U][NCH][VEC];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    kept[u] = keep == nullptr || keep[e + u] != 0;  // the same for every lane
    dot[u] = 0.f;
    if (!kept[u]) continue;
    const T* src = g + (long long)recv[e + u] * P;
    gden[u] = to_f32(src[elc]);
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c0 = j * 32 * VEC + lane * VEC;
      if (c0 < D) Rows<T, VEC>::load(src + base + c0, v[u][j]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!kept[u]) continue;
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (j * 32 * VEC + lane * VEC >= D) continue;
#pragma unroll
      for (int k = 0; k < VEC; ++k) dot[u] += msg[j][k] * v[u][j][k];
    }
  }
  // every lane takes part, kept or not, so the shuffles stay convergent
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int u = 0; u < U; ++u) dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], off);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!kept[u]) continue;
    acc_el += round_to<T>(__fmul_rn(__fmul_rn(__fadd_rn(dot[u], gden[u]), w), slope));
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (j * 32 * VEC + lane * VEC >= D) continue;
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[j][k] += round_to<T>(__fmul_rn(w, v[u][j][k]));
    }
  }
}

template <typename T, int VEC, int NCH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_bwd_csc_kernel(const T* __restrict__ tab, const T* __restrict__ g,
                   const int* __restrict__ col_ptr, const int* __restrict__ recv,
                   const unsigned char* __restrict__ keep, const float* __restrict__ cmax,
                   T* __restrict__ dtab, int n_rows, int P, int D, int H, float neg_slope) {
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)n_rows * H) return;  // the whole warp leaves together
  const int row = (int)(warp / H), head = (int)(warp % H);
  const int hd = H * D, base = head * D;
  const T* own = tab + (long long)row * P;
  const float el = to_f32(own[hd + head]);
  const float w = gat_weight(el, cmax[head], neg_slope);
  const float slope = el >= 0.f ? 1.f : neg_slope;
  float msg[NCH][VEC], acc[NCH][VEC], acc_el = 0.f;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c0 = j * 32 * VEC + lane * VEC;
#pragma unroll
    for (int k = 0; k < VEC; ++k) msg[j][k] = acc[j][k] = 0.f;
    if (c0 < D) Rows<T, VEC>::load(own + base + c0, msg[j]);
  }
  constexpr int U = EdgesInFlight<NCH>::value;
  const int end = col_ptr[row + 1];
  int e = col_ptr[row];
  for (; e + U <= end; e += U)
    gat_bwd_edges<T, VEC, NCH, U>(g, recv, keep, e, P, base, hd + head, D, lane, w, slope, msg,
                                  acc, acc_el);
  for (; e < end; ++e)
    gat_bwd_edges<T, VEC, NCH, 1>(g, recv, keep, e, P, base, hd + head, D, lane, w, slope, msg,
                                  acc, acc_el);
  T* dst = dtab + (long long)row * P;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c0 = j * 32 * VEC + lane * VEC;
    if (c0 < D) Rows<T, VEC>::store(dst + base + c0, acc[j]);
  }
  if (lane == 0) dst[hd + head] = from_f32<T>(acc_el);
  if (head == 0)  // the zero columns past [dmsg | d_el]
    for (int c = hd + H + lane; c < P; c += 32) dst[c] = from_f32<T>(0.f);
}

template <typename T, int VEC, int NCH>
void launch_one(const void* tab, const void* g, const void* col_ptr, const void* recv,
                const void* keep, const void* cmax, void* dtab, int n_rows, int P, int D, int H,
                float neg_slope, cudaStream_t s) {
  const long long warps = (long long)n_rows * H;
  const dim3 grid((unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  gat_bwd_csc_kernel<T, VEC, NCH><<<grid, block, 0, s>>>(
      static_cast<const T*>(tab), static_cast<const T*>(g), static_cast<const int*>(col_ptr),
      static_cast<const int*>(recv), static_cast<const unsigned char*>(keep),
      static_cast<const float*>(cmax), static_cast<T*>(dtab), n_rows, P, D, H, neg_slope);
}

template <typename T, int VEC>
void launch_vec(const void* tab, const void* g, const void* col_ptr, const void* recv,
                const void* keep, const void* cmax, void* dtab, int n_rows, int P, int D, int H,
                float neg_slope, int nch, cudaStream_t s) {
#define DGC_K6_ARGS tab, g, col_ptr, recv, keep, cmax, dtab, n_rows, P, D, H, neg_slope, s
  switch (nch) {
    case 1: launch_one<T, VEC, 1>(DGC_K6_ARGS); break;
    case 2: launch_one<T, VEC, 2>(DGC_K6_ARGS); break;
    case 4: launch_one<T, VEC, 4>(DGC_K6_ARGS); break;
    default: launch_one<T, VEC, 8>(DGC_K6_ARGS); break;
  }
#undef DGC_K6_ARGS
}

template <typename T>
int launch_gat_bwd_csc(const void* tab, const void* g, const void* col_ptr, const void* recv,
                       const void* keep, const void* cmax, void* dtab, int n_rows, int P, int D,
                       int H, float neg_slope, int vec, int nch, void* stream) {
  if (nch != 1 && nch != 2 && nch != 4 && nch != 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    launch_vec<T, 4>(tab, g, col_ptr, recv, keep, cmax, dtab, n_rows, P, D, H, neg_slope, nch, s);
  else
    launch_vec<T, 1>(tab, g, col_ptr, recv, keep, cmax, dtab, n_rows, P, D, H, neg_slope, nch, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes.  tab, g and dtab are [n_rows, P] of one
// type; col_ptr [n_rows + 1] and recv [E_pad] int32 in sender (CSC) order;
// keep [E_pad] uint8 in CSC order, or null when no edge was dropped; cmax [H]
// float32.  `vec` and `nch` as for K5.  Returns cudaGetLastError() after the
// launch.
extern "C" int dgc_gat_bwd_csc_f32(const void* tab, const void* g, const void* col_ptr,
                                   const void* recv, const void* keep, const void* cmax,
                                   void* dtab, int n_rows, int P, int D, int H, float neg_slope,
                                   int vec, int nch, void* stream) {
  return dgc::launch_gat_bwd_csc<float>(tab, g, col_ptr, recv, keep, cmax, dtab, n_rows, P, D,
                                        H, neg_slope, vec, nch, stream);
}

extern "C" int dgc_gat_bwd_csc_bf16(const void* tab, const void* g, const void* col_ptr,
                                    const void* recv, const void* keep, const void* cmax,
                                    void* dtab, int n_rows, int P, int D, int H,
                                    float neg_slope, int vec, int nch, void* stream) {
  return dgc::launch_gat_bwd_csc<__nv_bfloat16>(tab, g, col_ptr, recv, keep, cmax, dtab, n_rows,
                                                P, D, H, neg_slope, vec, nch, stream);
}

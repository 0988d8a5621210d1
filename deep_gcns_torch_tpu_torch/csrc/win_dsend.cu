// K9: the sender side of the dense destination-score GAT's backward, over
// the TRANSPOSE band's window and hub columns (rows are senders s, positions
// receivers r; the drop hash takes (r, s)).  For each sender row s and head
// h, with M the forward's stabilizer:
//
//   z = el[s] + er[r],   E = c * exp(min(lrelu(z) - M[r], 50))
//   q = <feat[s, h, :], gnum[r, h, :]> + gden[r],   t = E * q * lrelu'(z)
//   d_el[s] = sum_r t,   d_feat[s, h, :] = sum_r round_T(E) * gnum[r, h, :]
//
// both float32; round_T is the TPU kernel's `e.astype(cdk)`
// (ops/gat_dense.py:1117) and gnum is in the compute type.
//
// Replaces the TPU kernel `_k_dsend` (deep_gcns_torch_tpu/ops/gat_dense.py:1048,
// called at :1250 by `_win_dsend_call`), which evaluates the transpose band's
// dense [W, 128] tiles with the receiver-side tables packed into one
// 128-lane container and two MXU products per head.  Here a lane holds its
// columns of feat[s] in registers; each listed receiver's gnum row is read
// once and serves both the dot (a butterfly over the lanes) and the d_feat
// sum, and er, M and gden are read per listed receiver.
//
// What bounds it on the H100: bytes (A read once per head, gnum rows of a
// block's window shared in L1/L2, d_feat float32 written once).
#include "gat_dense.cuh"

namespace dgc {

template <typename T, int VEC, int NCH, int U>
__device__ __forceinline__ void dsend_walk(const T* gcol, long long hd, int D, int lane, int H,
                                           int head, const float (&f)[NCH][VEC],
                                           const float* __restrict__ gden, const int* ids,
                                           const float* wts, const float* dls, int j, float& d_el,
                                           float (&acc)[NCH][VEC]) {
  float v[U][NCH][VEC];
  float gd[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    load_head<T, VEC, NCH>(gcol + ids[j + u] * hd, D, lane, v[u]);
    gd[u] = gden[static_cast<long long>(ids[j + u]) * H + head];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float q = __fadd_rn(warp_sum(lane_dot<VEC, NCH>(f, v[u])), gd[u]);
    d_el = __fadd_rn(d_el, __fmul_rn(__fmul_rn(wts[j + u], q), dls[j + u]));
    add_scaled<VEC, NCH>(acc, round_to<T>(wts[j + u]), v[u]);
  }
}

template <typename T, int VEC, int NCH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
win_dsend_kernel(DenseBand b, const float* __restrict__ el, const float* __restrict__ er,
                 const float* __restrict__ M, const float* __restrict__ gden,
                 const T* __restrict__ feat, const T* __restrict__ gnum,
                 float* __restrict__ d_el_out, float* __restrict__ d_feat) {
  __shared__ int ids_s[kWarpsPerBlock][kPass];
  __shared__ float wts_s[kWarpsPerBlock][kPass];
  __shared__ float dls_s[kWarpsPerBlock][kPass];
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + wib;
  if (warp >= static_cast<long long>(b.n_rows) * b.H) return;  // the whole warp leaves
  const int H = b.H, D = b.D;
  const int row = static_cast<int>(warp / H), head = static_cast<int>(warp % H);
  const long long hd = static_cast<long long>(H) * D, rh = static_cast<long long>(row) * H + head;
  const long long off = static_cast<long long>(row) * hd + static_cast<long long>(head) * D;
  const float el_s = el[rh];
  float f[NCH][VEC];
  load_head<T, VEC, NCH>(feat + off, D, lane, f);
  int* ids = ids_s[wib];
  float* wts = wts_s[wib];
  float* dls = dls_s[wib];
  const T* gcol = gnum + static_cast<long long>(head) * D;
  float d_el = 0.f;
  float acc[NCH][VEC];
#pragma unroll
  for (int g = 0; g < NCH; ++g)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[g][q] = 0.f;
  for_each_pass(b, row, lane, true, [&](const Slots& sl) {
    int total;
    int pos = warp_prefix(__popc(sl.valid), lane, total);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if ((sl.valid >> k) & 1u) {
        const long long r = static_cast<long long>(sl.id[k]) * H + head;
        const float z = __fadd_rn(el_s, er[r]);
        ids[pos] = sl.id[k];
        wts[pos] = edge_weight(sl.cnt[k], lrelu(z, b.ns), M[r]);
        dls[pos] = dlrelu(z, b.ns);
        ++pos;
      }
    }
    __syncwarp();
    constexpr int U = EdgesInFlight<NCH>::value;
    int j = 0;
    for (; j + U <= total; j += U)
      dsend_walk<T, VEC, NCH, U>(gcol, hd, D, lane, H, head, f, gden, ids, wts, dls, j, d_el,
                                 acc);
    for (; j < total; ++j)
      dsend_walk<T, VEC, NCH, 1>(gcol, hd, D, lane, H, head, f, gden, ids, wts, dls, j, d_el,
                                 acc);
    __syncwarp();  // the next pass overwrites the list
  });
  store_head<VEC, NCH>(d_feat + off, D, lane, acc);
  if (lane == 0) d_el_out[rh] = d_el;
}

template <typename T>
int launch_win_dsend(const DenseBand& b, const void* el, const void* er, const void* M,
                     const void* gden, const void* feat, const void* gnum, void* d_el,
                     void* d_feat, int vec, int nch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = dense_grid(b.n_rows, b.H), block(kWarpsPerBlock * 32);
#define DGC_K9_LAUNCH(TT, V, N)                                                            \
  win_dsend_kernel<TT, V, N><<<grid, block, 0, s>>>(                                       \
      b, static_cast<const float*>(el), static_cast<const float*>(er),                     \
      static_cast<const float*>(M), static_cast<const float*>(gden),                       \
      static_cast<const TT*>(feat), static_cast<const TT*>(gnum), static_cast<float*>(d_el), \
      static_cast<float*>(d_feat))
  DGC_DENSE_DISPATCH(DGC_K9_LAUNCH, T, vec, nch);
#undef DGC_K9_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes: the transpose band as for dgc_win_fused_*;
// el, er, M, gden and d_el [n_rows, H] float32; feat and gnum [n_rows, H*D]
// of the entry point's type, d_feat [n_rows, H*D] float32.  Returns
// cudaGetLastError() after the launch.
#define DGC_K9_ENTRY(NAME, TT)                                                              \
  extern "C" int NAME(const void* a, const void* w_lo, const void* a_hub, const void* hub_ids, \
                      const void* el, const void* er, const void* M, const void* gden,        \
                      const void* feat, const void* gnum, void* d_el, void* d_feat,           \
                      int n_rows, int W, int n_hub, int H, int D, float ns, uint32_t k0,      \
                      uint32_t k1, int thresh, int vec, int nch, void* stream) {              \
    const dgc::DenseBand b =                                                                  \
        dgc::make_band(a, w_lo, a_hub, hub_ids, n_rows, W, n_hub, H, D, ns, k0, k1, thresh);  \
    return dgc::launch_win_dsend<TT>(b, el, er, M, gden, feat, gnum, d_el, d_feat, vec, nch,  \
                                     stream);                                                 \
  }

DGC_K9_ENTRY(dgc_win_dsend_f32, float)
DGC_K9_ENTRY(dgc_win_dsend_bf16, __nv_bfloat16)

// K8: the receiver side of the dense destination-score GAT's backward, over
// the forward band's window and hub columns.  For each receiver row r and
// head h, over the valid positions s of the row (gat_dense.cuh), with M the
// forward's stabilizer:
//
//   z = el[s] + er[r],   E = c * exp(min(lrelu(z) - M[r], 50))
//   q = <feat[s, h, :], gnum[r, h, :]> + gden[r],   t = E * q * lrelu'(z)
//   d_er[r] = sum_s t                                           (float32)
//
// feat and gnum are in the compute type (gnum rounded to it by the caller,
// as `_win_der_call` does at ops/gat_dense.py:1194), so in bf16 each product
// of the dot is exact in float32.
//
// Replaces the TPU kernel `_k_der` (deep_gcns_torch_tpu/ops/gat_dense.py:966,
// called at :1208 by `_win_der_call`), which evaluates the dense [W, 128]
// tile of a block and one MXU product per head for the dots.  Here a lane
// holds its columns of gnum[r] in registers, the valid positions are
// compacted into a per-warp list (E, lrelu'(z)), and for each listed sender
// the warp reads its feature row, takes the dot as a butterfly over the
// lanes and adds t.
//
// What bounds it on the H100: bytes (A read once per head, the window's
// feature rows shared by a block's 128 receivers in L1/L2, gnum read once).
#include "gat_dense.cuh"

namespace dgc {

template <typename T, int VEC, int NCH, int U>
__device__ __forceinline__ void der_walk(const T* fcol, long long hd, int D, int lane,
                                         const float (&gn)[NCH][VEC], float gd,
                                         const int* ids, const float* wts, const float* dls,
                                         int j, float& der) {
  float v[U][NCH][VEC];
#pragma unroll
  for (int u = 0; u < U; ++u) load_head<T, VEC, NCH>(fcol + ids[j + u] * hd, D, lane, v[u]);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const float q = __fadd_rn(warp_sum(lane_dot<VEC, NCH>(gn, v[u])), gd);
    der = __fadd_rn(der, __fmul_rn(__fmul_rn(wts[j + u], q), dls[j + u]));
  }
}

template <typename T, int VEC, int NCH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
win_der_kernel(DenseBand b, const float* __restrict__ el, const float* __restrict__ er,
               const float* __restrict__ M, const float* __restrict__ gden,
               const T* __restrict__ feat, const T* __restrict__ gnum,
               float* __restrict__ d_er) {
  __shared__ int ids_s[kWarpsPerBlock][kPass];
  __shared__ float wts_s[kWarpsPerBlock][kPass];
  __shared__ float dls_s[kWarpsPerBlock][kPass];
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + wib;
  if (warp >= static_cast<long long>(b.n_rows) * b.H) return;  // the whole warp leaves
  const int H = b.H, D = b.D;
  const int row = static_cast<int>(warp / H), head = static_cast<int>(warp % H);
  const long long hd = static_cast<long long>(H) * D, rh = static_cast<long long>(row) * H + head;
  const float er_r = er[rh], m_r = M[rh], gd_r = gden[rh];
  float gn[NCH][VEC];
  load_head<T, VEC, NCH>(gnum + static_cast<long long>(row) * hd + static_cast<long long>(head) * D,
                         D, lane, gn);
  int* ids = ids_s[wib];
  float* wts = wts_s[wib];
  float* dls = dls_s[wib];
  const T* fcol = feat + static_cast<long long>(head) * D;
  float der = 0.f;
  for_each_pass(b, row, lane, false, [&](const Slots& sl) {
    int total;
    int pos = warp_prefix(__popc(sl.valid), lane, total);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if ((sl.valid >> k) & 1u) {
        const float z = __fadd_rn(el[static_cast<long long>(sl.id[k]) * H + head], er_r);
        ids[pos] = sl.id[k];
        wts[pos] = edge_weight(sl.cnt[k], lrelu(z, b.ns), m_r);
        dls[pos] = dlrelu(z, b.ns);
        ++pos;
      }
    }
    __syncwarp();
    constexpr int U = EdgesInFlight<NCH>::value;
    int j = 0;
    for (; j + U <= total; j += U)
      der_walk<T, VEC, NCH, U>(fcol, hd, D, lane, gn, gd_r, ids, wts, dls, j, der);
    for (; j < total; ++j)
      der_walk<T, VEC, NCH, 1>(fcol, hd, D, lane, gn, gd_r, ids, wts, dls, j, der);
    __syncwarp();  // the next pass overwrites the list
  });
  if (lane == 0) d_er[rh] = der;
}

template <typename T>
int launch_win_der(const DenseBand& b, const void* el, const void* er, const void* M,
                   const void* gden, const void* feat, const void* gnum, void* d_er, int vec,
                   int nch, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = dense_grid(b.n_rows, b.H), block(kWarpsPerBlock * 32);
#define DGC_K8_LAUNCH(TT, V, N)                                                            \
  win_der_kernel<TT, V, N><<<grid, block, 0, s>>>(                                         \
      b, static_cast<const float*>(el), static_cast<const float*>(er),                     \
      static_cast<const float*>(M), static_cast<const float*>(gden),                       \
      static_cast<const TT*>(feat), static_cast<const TT*>(gnum), static_cast<float*>(d_er))
  DGC_DENSE_DISPATCH(DGC_K8_LAUNCH, T, vec, nch);
#undef DGC_K8_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes: the band as for dgc_win_fused_*; el, er, M,
// gden and d_er [n_rows, H] float32; feat and gnum [n_rows, H*D] of the entry
// point's type.  Returns cudaGetLastError() after the launch.
#define DGC_K8_ENTRY(NAME, TT)                                                              \
  extern "C" int NAME(const void* a, const void* w_lo, const void* a_hub, const void* hub_ids, \
                      const void* el, const void* er, const void* M, const void* gden,        \
                      const void* feat, const void* gnum, void* d_er, int n_rows, int W,      \
                      int n_hub, int H, int D, float ns, uint32_t k0, uint32_t k1, int thresh, \
                      int vec, int nch, void* stream) {                                       \
    const dgc::DenseBand b =                                                                  \
        dgc::make_band(a, w_lo, a_hub, hub_ids, n_rows, W, n_hub, H, D, ns, k0, k1, thresh);  \
    return dgc::launch_win_der<TT>(b, el, er, M, gden, feat, gnum, d_er, vec, nch, stream);   \
  }

DGC_K8_ENTRY(dgc_win_der_f32, float)
DGC_K8_ENTRY(dgc_win_der_bf16, __nv_bfloat16)

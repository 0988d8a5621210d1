// K7: the forward of the dense destination-score GAT over the window band and
// its hub columns.  For each receiver row r and head h, over the valid
// positions s of the row (gat_dense.cuh):
//
//   M[r]   = max(max_s lrelu(el[s] + er[r]), m_other[r])
//   E_s    = c_s * exp(min(lrelu(el[s] + er[r]) - M[r], 50))
//   den[r] = sum_s E_s,   num[r, :] = sum_s round_T(E_s) * feat[s, h, :]
//
// m_other carries the maxima of the structures outside the kernel (hub rows,
// leftover, self term, hub columns past 2048), so M is the exact
// per-receiver stabilizer; max rounds nothing, so M equals the plain
// version's bit for bit.  Two walks of the row: the maximum first, then the
// weights and sums against it, which gives the TPU kernel's sums directly
// (an online rescaled softmax would round differently).  round_T is the
// rounding to feat's type that the TPU kernel applies before its MXU product
// (`e.astype(cdk)`, ops/gat_dense.py:1338); num, den and M are float32.
//
// Replaces the TPU kernel `_k_fused` (deep_gcns_torch_tpu/ops/gat_dense.py:1274,
// called at :1380 by `_win_fused_call`), which scores every position of a
// 128-receiver block's dense [W, 128] window tile, masks, and runs one MXU
// product per head.  Here the first walk reads the row's counts and one el
// value per valid position; the second compacts the valid positions into a
// list and walks it with the lanes across the head's D columns, several
// feature rows in flight.
//
// What bounds it on the H100: bytes.  A (N_pad * W int8) is read once per
// head, its rows shared by a row's heads in L1; feat rows of a block's window
// are shared by its 128 receivers (L1/L2); num (float32, the largest
// array) is written once.  chip_smoke.py prints the bound for its run.
#include "gat_dense.cuh"

namespace dgc {

template <typename T, int VEC, int NCH, int U>
__device__ __forceinline__ void fused_walk(const T* fcol, long long hd, int D, int lane,
                                           const int* ids, const float* wts, int j,
                                           float (&acc)[NCH][VEC]) {
  float v[U][NCH][VEC];
#pragma unroll
  for (int u = 0; u < U; ++u) load_head<T, VEC, NCH>(fcol + ids[j + u] * hd, D, lane, v[u]);
#pragma unroll
  for (int u = 0; u < U; ++u) add_scaled<VEC, NCH>(acc, wts[j + u], v[u]);
}

template <typename T, int VEC, int NCH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
win_fused_kernel(DenseBand b, const float* __restrict__ el, const float* __restrict__ er,
                 const float* __restrict__ m_other, const T* __restrict__ feat,
                 float* __restrict__ num, float* __restrict__ den, float* __restrict__ m_out) {
  __shared__ int ids_s[kWarpsPerBlock][kPass];
  __shared__ float wts_s[kWarpsPerBlock][kPass];
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long warp = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + wib;
  if (warp >= static_cast<long long>(b.n_rows) * b.H) return;  // the whole warp leaves
  const int H = b.H, D = b.D;
  const int row = static_cast<int>(warp / H), head = static_cast<int>(warp % H);
  const long long hd = static_cast<long long>(H) * D, rh = static_cast<long long>(row) * H + head;
  const float er_r = er[rh];

  // 1. M over the valid positions, then the structures outside the kernel
  float m = kNegScore;
  for_each_pass(b, row, lane, false, [&](const Slots& sl) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      if ((sl.valid >> k) & 1u)
        m = fmaxf(m, lrelu(__fadd_rn(el[static_cast<long long>(sl.id[k]) * H + head], er_r),
                           b.ns));
  });
  m = fmaxf(warp_max(m), m_other[rh]);

  // 2. the weights against M: den in each lane, num through the list
  int* ids = ids_s[wib];
  float* wts = wts_s[wib];
  const T* fcol = feat + static_cast<long long>(head) * D;
  float den_l = 0.f;
  float acc[NCH][VEC];
#pragma unroll
  for (int g = 0; g < NCH; ++g)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[g][q] = 0.f;
  for_each_pass(b, row, lane, false, [&](const Slots& sl) {
    int total;
    int pos = warp_prefix(__popc(sl.valid), lane, total);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      if ((sl.valid >> k) & 1u) {
        const float s =
            lrelu(__fadd_rn(el[static_cast<long long>(sl.id[k]) * H + head], er_r), b.ns);
        const float e = edge_weight(sl.cnt[k], s, m);
        den_l = __fadd_rn(den_l, e);
        ids[pos] = sl.id[k];
        wts[pos] = round_to<T>(e);
        ++pos;
      }
    }
    __syncwarp();
    constexpr int U = EdgesInFlight<NCH>::value;
    int j = 0;
    for (; j + U <= total; j += U) fused_walk<T, VEC, NCH, U>(fcol, hd, D, lane, ids, wts, j, acc);
    for (; j < total; ++j) fused_walk<T, VEC, NCH, 1>(fcol, hd, D, lane, ids, wts, j, acc);
    __syncwarp();  // the next pass overwrites the list
  });
  store_head<VEC, NCH>(num + static_cast<long long>(row) * hd + static_cast<long long>(head) * D,
                       D, lane, acc);
  den_l = warp_sum(den_l);
  if (lane == 0) {
    den[rh] = den_l;
    m_out[rh] = m;
  }
}

template <typename T>
int launch_win_fused(const DenseBand& b, const void* el, const void* er, const void* m_other,
                     const void* feat, void* num, void* den, void* m_out, int vec, int nch,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid = dense_grid(b.n_rows, b.H), block(kWarpsPerBlock * 32);
#define DGC_K7_LAUNCH(TT, V, N)                                                            \
  win_fused_kernel<TT, V, N><<<grid, block, 0, s>>>(                                       \
      b, static_cast<const float*>(el), static_cast<const float*>(er),                     \
      static_cast<const float*>(m_other), static_cast<const TT*>(feat),                    \
      static_cast<float*>(num), static_cast<float*>(den), static_cast<float*>(m_out))
  DGC_DENSE_DISPATCH(DGC_K7_LAUNCH, T, vec, nch);
#undef DGC_K7_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes.  a [n_rows, W] int8 (W a multiple of 8),
// w_lo [n_rows / 128] int32, a_hub [n_rows, n_hub] bf16 (n_hub a multiple of
// 8, 16-byte aligned) and hub_ids [n_hub] int32, or null for no hub columns;
// el, er, m_other, den, m_out [n_rows, H] float32; feat [n_rows, H*D] of the
// entry point's type, num [n_rows, H*D] float32.  thresh < 0 means no drop;
// k0/k1 are the drop key's int32 bits.  Returns cudaGetLastError() after the
// launch.
#define DGC_K7_ENTRY(NAME, TT)                                                              \
  extern "C" int NAME(const void* a, const void* w_lo, const void* a_hub, const void* hub_ids, \
                      const void* el, const void* er, const void* m_other, const void* feat,  \
                      void* num, void* den, void* m_out, int n_rows, int W, int n_hub, int H, \
                      int D, float ns, uint32_t k0, uint32_t k1, int thresh, int vec, int nch, \
                      void* stream) {                                                         \
    const dgc::DenseBand b =                                                                  \
        dgc::make_band(a, w_lo, a_hub, hub_ids, n_rows, W, n_hub, H, D, ns, k0, k1, thresh);  \
    return dgc::launch_win_fused<TT>(b, el, er, m_other, feat, num, den, m_out, vec, nch,     \
                                     stream);                                                 \
  }

DGC_K7_ENTRY(dgc_win_fused_f32, float)
DGC_K7_ENTRY(dgc_win_fused_bf16, __nv_bfloat16)

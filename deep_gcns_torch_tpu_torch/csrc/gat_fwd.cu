// K5: the forward of the sender-only-score GAT attention SpMM.  The packed
// node table T [N_pad, P] holds [msg (H*D) | el (H) | zero columns].  For each
// receiver row r and head h, over the edges e in [row_ptr[r], row_ptr[r+1])
// whose receiver is still r (a dropped edge carries the sentinel receiver
// N_pad):
//
//   w_e  = exp(leaky_relu(el[s_e, h]) - cmax[h])                  (<= 1)
//   num  = sum_e round_T(w_e * msg[s_e, h, :]),  den = sum_e round_T(w_e)
//   out[r] = [num (H*D) | den (H) | 0], in T's type, sums in float32
//
// with s_e = senders[e].  cmax is the per-head GLOBAL shift of `_gat_cmax`
// (spmm_pallas.py:892-895), computed outside the kernel: the node-factored
// backward (K6) needs one shift for every receiver.  round_T is the rounding
// to T that the TPU kernel applies to each edge's terms before its float32
// sum (spmm_pallas.py:850-853), so kernel and plain version differ only in
// the order of the sums.
//
// Replaces the TPU kernel `_gat_fwd_kernel` (spmm_pallas.py:837, called at
// :905).  That kernel streams T[senders], gathered by XLA into an [E, P]
// array beforehand (:952), through a one-hot MXU matmul per 128-row block.
// Here one warp owns one (receiver row, head) pair, lanes span the head's D
// columns, and every edge's sender row is read straight from T: the [E, P]
// array (2.15 GB a call at the 387-wide middle layer in bf16) is never
// written.  Each lane reads the head's el from the same row and computes the
// edge weight itself, so no shuffles are needed.
//
// What bounds it on the H100: bytes.  Per (edge, head) it reads D + 1 values
// of one gathered row and does about 4 float32 operations per value plus one
// exp; T read once and out written once are 2 x 263 MB at the first layer
// (N=169,343, P=776, bf16), while the gathered rows total E*P values, which
// the cluster order of the graph keeps mostly in the 50 MB L2.  The design
// keeps up to four edges' row loads in flight per step and uses 16-byte
// float32 / 8-byte bf16 loads when D and P are multiples of 4.
#include "common.cuh"

namespace dgc {

template <typename T, int VEC, int NCH, int U>
__device__ __forceinline__ void gat_fwd_edges(const T* __restrict__ tab,
                                              const int* __restrict__ senders,
                                              const int* __restrict__ recv, int e, int row,
                                              long long P, int base, int elc, int D, int lane,
                                              float cm, float neg_slope, float (&acc)[NCH][VEC],
                                              float& den) {
  bool kept[U];
  float w[U];
  float v[U][NCH][VEC];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    kept[u] = recv[e + u] == row;  // the same for every lane of the warp
    if (!kept[u]) continue;
    const T* src = tab + (long long)senders[e + u] * P;
    w[u] = gat_weight(to_f32(src[elc]), cm, neg_slope);
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      const int c0 = j * 32 * VEC + lane * VEC;
      if (c0 < D) Rows<T, VEC>::load(src + base + c0, v[u][j]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (!kept[u]) continue;
    den += round_to<T>(w[u]);
#pragma unroll
    for (int j = 0; j < NCH; ++j) {
      if (j * 32 * VEC + lane * VEC >= D) continue;
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[j][k] += round_to<T>(__fmul_rn(w[u], v[u][j][k]));
    }
  }
}

template <typename T, int VEC, int NCH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
gat_fwd_kernel(const T* __restrict__ tab, const int* __restrict__ senders,
               const int* __restrict__ recv, const int* __restrict__ row_ptr,
               const float* __restrict__ cmax, T* __restrict__ out, int n_rows, int P, int D,
               int H, float neg_slope) {
  const long long warp = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)n_rows * H) return;  // the whole warp leaves together
  const int row = (int)(warp / H), head = (int)(warp % H);
  const int hd = H * D, base = head * D;
  const float cm = cmax[head];
  float acc[NCH][VEC], den = 0.f;
#pragma unroll
  for (int j = 0; j < NCH; ++j)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[j][k] = 0.f;
  constexpr int U = EdgesInFlight<NCH>::value;
  const int end = row_ptr[row + 1];
  int e = row_ptr[row];
  for (; e + U <= end; e += U)
    gat_fwd_edges<T, VEC, NCH, U>(tab, senders, recv, e, row, P, base, hd + head, D, lane, cm,
                                  neg_slope, acc, den);
  for (; e < end; ++e)
    gat_fwd_edges<T, VEC, NCH, 1>(tab, senders, recv, e, row, P, base, hd + head, D, lane, cm,
                                  neg_slope, acc, den);
  T* dst = out + (long long)row * P;
#pragma unroll
  for (int j = 0; j < NCH; ++j) {
    const int c0 = j * 32 * VEC + lane * VEC;
    if (c0 < D) Rows<T, VEC>::store(dst + base + c0, acc[j]);
  }
  if (lane == 0) dst[hd + head] = from_f32<T>(den);
  if (head == 0)  // the zero columns past [num | den]
    for (int c = hd + H + lane; c < P; c += 32) dst[c] = from_f32<T>(0.f);
}

template <typename T, int VEC, int NCH>
void launch_one(const void* tab, const void* senders, const void* recv, const void* row_ptr,
                const void* cmax, void* out, int n_rows, int P, int D, int H, float neg_slope,
                cudaStream_t s) {
  const long long warps = (long long)n_rows * H;
  const dim3 grid((unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  gat_fwd_kernel<T, VEC, NCH><<<grid, block, 0, s>>>(
      static_cast<const T*>(tab), static_cast<const int*>(senders),
      static_cast<const int*>(recv), static_cast<const int*>(row_ptr),
      static_cast<const float*>(cmax), static_cast<T*>(out), n_rows, P, D, H, neg_slope);
}

template <typename T, int VEC>
void launch_vec(const void* tab, const void* senders, const void* recv, const void* row_ptr,
                const void* cmax, void* out, int n_rows, int P, int D, int H, float neg_slope,
                int nch, cudaStream_t s) {
#define DGC_K5_ARGS tab, senders, recv, row_ptr, cmax, out, n_rows, P, D, H, neg_slope, s
  switch (nch) {
    case 1: launch_one<T, VEC, 1>(DGC_K5_ARGS); break;
    case 2: launch_one<T, VEC, 2>(DGC_K5_ARGS); break;
    case 4: launch_one<T, VEC, 4>(DGC_K5_ARGS); break;
    default: launch_one<T, VEC, 8>(DGC_K5_ARGS); break;
  }
#undef DGC_K5_ARGS
}

template <typename T>
int launch_gat_fwd(const void* tab, const void* senders, const void* recv, const void* row_ptr,
                   const void* cmax, void* out, int n_rows, int P, int D, int H, float neg_slope,
                   int vec, int nch, void* stream) {
  if (nch != 1 && nch != 2 && nch != 4 && nch != 8) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    launch_vec<T, 4>(tab, senders, recv, row_ptr, cmax, out, n_rows, P, D, H, neg_slope, nch, s);
  else
    launch_vec<T, 1>(tab, senders, recv, row_ptr, cmax, out, n_rows, P, D, H, neg_slope, nch, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes.  tab and out are [n_rows, P] of one type,
// senders and recv (the receivers with dropped edges set to the sentinel)
// [E_pad] int32 in receiver (CSR) order, row_ptr [n_rows + 1] int32, cmax
// [H] float32.  `vec` is 4 when D and P are multiples of 4 and the tables are
// aligned for wide loads, else 1; `nch` (1, 2, 4 or 8) is the number of
// 32*vec-column groups a lane walks per head (>= D / (32*vec)).  Returns
// cudaGetLastError() after the launch.
extern "C" int dgc_gat_fwd_f32(const void* tab, const void* senders, const void* recv,
                               const void* row_ptr, const void* cmax, void* out, int n_rows,
                               int P, int D, int H, float neg_slope, int vec, int nch,
                               void* stream) {
  return dgc::launch_gat_fwd<float>(tab, senders, recv, row_ptr, cmax, out, n_rows, P, D, H,
                                    neg_slope, vec, nch, stream);
}

extern "C" int dgc_gat_fwd_bf16(const void* tab, const void* senders, const void* recv,
                                const void* row_ptr, const void* cmax, void* out, int n_rows,
                                int P, int D, int H, float neg_slope, int vec, int nch,
                                void* stream) {
  return dgc::launch_gat_fwd<__nv_bfloat16>(tab, senders, recv, row_ptr, cmax, out, n_rows, P,
                                            D, H, neg_slope, vec, nch, stream);
}

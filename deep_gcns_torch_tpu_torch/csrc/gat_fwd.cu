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
// Here every edge's sender row is read straight from T: the [E, P] array
// (2.15 GB a call at the 387-wide middle layer in bf16) is never written.
//
// What bounds it on the H100: bytes.  T read once and out written once are
// 2 x 133 MB at P=392 bf16 (2 x 263 MB at P=776), while the gathered rows
// total (kept edges) x P values, which the cluster order of the graph keeps
// mostly in the 50 MB L2; chip_smoke.py prints the bound and the time if
// every gather came from HBM.
//
// The first form of this kernel gave a warp to each (receiver row, head), the
// lanes across the head's D columns.  For each edge every lane loaded
// recv[e] and senders[e] (one address in all 32 lanes), then the sender's
// el (again one address), then its slice of the row: up to 4 edges in
// flight, a chain two dependent loads deep per group of 4, and each edge's
// indices and el fetched H times, once per head's warp.  0.816 ms at P=392
// bf16 on the H100, 9.5x the byte bound.
//
// The design: one warp per receiver row, all heads, the edge indices loaded
// 32 at a time.
//   1. Edge table: the lanes load 32 consecutive edge slots' senders and
//      receivers at once (coalesced); each lane with a kept slot loads its
//      sender's H el values (contiguous at column H*D of T) and computes
//      w_h = exp(lrelu(el_h) - cmax_h).  The kept slots are compacted (a
//      ballot and a popcount, edge order kept) into a table in shared memory:
//      sender id and w per head.
//   2. den: one lane per head adds round_T(w_h) over the table in edge
//      order, so den is the first form's bit for bit.
//   3. Walk: the lanes run across the H·D columns, several sender rows in
//      flight, none of their loads waiting on an index load; each column
//      adds round_T(w_{h(c)}·msg[s, c]) in edge order, so num is the first
//      form's bit for bit.
//   Rows wider than one walk (32·VEC·NCH columns: P=776) walk the row's
//   edges once per column chunk.  Narrow rows (P=48, H·D = 40) take K2's
//   lane groups in bf16 (`k5_layout` in ops/spmm_cuda.py: 3 groups of 10
//   lanes, each group every third kept edge of the table, the groups'
//   partials added in the fixed order g = 0..G-1, so num there differs from
//   the first form's in the order of its float32 sums); float32 keeps one
//   group and edge order.
//
// Forms measured on the H100 (80GB HBM3, 700 W) on the RevGAT-5L graph with
// the step's hash keep (N=169,472, 1,949,008 kept edges), ms at P=392 /
// 776 / 48 bf16 and P=392 float32, by `chip_smoke.py --kernel-forms=K5`
// (each a copy of this source with one constant changed, or the wrapper's
// walk form or lane groups): kept (96 values in flight a lane, 4 blocks an
// SM) 0.402-0.404 / 0.737-0.738 / 0.194-0.196 / 0.483-0.484; 48 values in
// flight 0.403-0.406 / 0.736-0.759 / 0.193-0.205 / 0.504-0.510; 24
// 0.424-0.427 / 0.842-0.846 / 0.190-0.191 / 0.563-0.567; 3 blocks
// 0.457-0.467 / 0.816-0.832 / 0.221-0.238 / 0.455-0.460; 6 blocks
// 0.550-0.571 / 1.097-1.137 / 0.173-0.182 / 0.834-0.847; one walk at P=776
// (3 blocks) 0.457-0.466 / 0.741-0.743 / 0.222-0.237 / 0.455-0.459; no lane
// groups 0.402-0.408 / 0.736-0.753 / 0.225-0.230 / 0.483-0.492.  A form
// that loaded each batch's first rows before the weights spilled 380-640
// bytes a thread and read 1.252-1.257 / 2.476-2.503 / 0.229-0.233 /
// 1.414-1.460.  The first form read 0.814-0.817 / 1.371-1.379 /
// 0.400-0.402 / 0.824-0.827 by `chip_smoke.py --kernel-times`.
#include "common.cuh"

namespace dgc {

// Values of sender rows a lane keeps in flight in the walk: rows in flight =
// kFlightValues / (values a lane holds of one row), between 1 and 8.
constexpr int kFlightValues = 96;
// Blocks an SM keeps resident: 64 registers a thread.
constexpr int kMinBlocks = 4;

template <int VALS> struct FwdRowsInFlight {
  static constexpr int raw = kFlightValues / VALS;
  static constexpr int value = raw < 1 ? 1 : (raw > 8 ? 8 : raw);
};

// A warp's part of the dynamic shared memory: the table's 32 sender ids, its
// weights [32, H] and den per head.
__host__ __device__ inline int fwd_table_floats(int H) { return 32 + 33 * H; }

template <typename T, int VEC, int NCH, int U>
__device__ __forceinline__ void fwd_step(const T* __restrict__ tab, long long P, int HD, int H,
                                         const int* ids, const float* wts, int i, int G,
                                         const int (&c0)[NCH], const int (&head)[NCH],
                                         float (&acc)[NCH][VEC]) {
  float v[U][NCH][VEC];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const T* src = tab + static_cast<long long>(ids[i + u * G]) * P;
#pragma unroll
    for (int g = 0; g < NCH; ++g) {
      if (c0[g] < HD) {
        Rows<T, VEC>::load(src + c0[g], v[u][g]);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) v[u][g][q] = 0.f;
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int g = 0; g < NCH; ++g) {
      const float w = wts[(i + u * G) * H + head[g]];
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[g][q] += round_to<T>(__fmul_rn(w, v[u][g][q]));
    }
  }
}

// The steps of U/2, U/4, ... rows (while the group's entries last) that
// follow the walk's U-row steps, so that a short remainder keeps several
// loads in flight; the caller ends with single rows.  Table order is kept.
// Lane groups take it (a group walks a third of a ~11-edge row at 1 x 40);
// the one-group forms measured 1-2 % slower with it (PERF.md).
template <typename T, int VEC, int NCH, int U>
__device__ __forceinline__ void fwd_tail(const T* __restrict__ tab, long long P, int HD, int H,
                                         const int* ids, const float* wts, int& i, int n, int G,
                                         const int (&c0)[NCH], const int (&head)[NCH],
                                         float (&acc)[NCH][VEC]) {
  if constexpr (U > 1) {
    if (i + (U - 1) * G < n) {
      fwd_step<T, VEC, NCH, U>(tab, P, HD, H, ids, wts, i, G, c0, head, acc);
      i += U * G;
    }
    fwd_tail<T, VEC, NCH, U / 2>(tab, P, HD, H, ids, wts, i, n, G, c0, head, acc);
  }
}

// MULTI: the row takes G > 1 lane groups of w lanes (then H·D <= w·VEC and
// one column chunk); else w = 32, G = 1.
template <typename T, int VEC, int NCH, bool MULTI>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocks)
gat_fwd_kernel(const T* __restrict__ tab, const int* __restrict__ senders,
               const int* __restrict__ recv, const int* __restrict__ row_ptr,
               const float* __restrict__ cmax, T* __restrict__ out, int n_rows, int P, int D,
               int H, float neg_slope, int w_arg, int G_arg) {
  extern __shared__ float smem[];
  constexpr int U = FwdRowsInFlight<NCH * VEC>::value;
  constexpr int SPAN = 32 * VEC * NCH;
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + wib;
  if (row >= n_rows) return;  // the whole warp leaves: the shuffles below see 32 lanes
  const int w = MULTI ? w_arg : 32;
  const int G = MULTI ? G_arg : 1;
  const int grp = lane / w, j = lane - grp * w;
  const int HD = H * D;
  float* base_smem = smem + wib * fwd_table_floats(H);
  int* ids = reinterpret_cast<int*>(base_smem);
  float* wts = base_smem + 32;
  float* dens = wts + 32 * H;
  for (int h = lane; h < H; h += 32) dens[h] = 0.f;
  const int start = row_ptr[row], end = row_ptr[row + 1];
  T* dst = out + static_cast<long long>(row) * P;
  for (int cbase = 0; cbase < HD; cbase += MULTI ? HD : SPAN) {
    int c0[NCH], head[NCH];
    float acc[NCH][VEC];
#pragma unroll
    for (int g = 0; g < NCH; ++g) {
      c0[g] = MULTI ? (grp < G ? j * VEC : HD) : cbase + g * 32 * VEC + lane * VEC;
      head[g] = c0[g] < HD ? c0[g] / D : 0;  // D is a multiple of VEC: one head a group
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[g][q] = 0.f;
    }
    for (int e0 = start; e0 < end; e0 += 32) {
      // 1. the edge table of slots e0 .. e0 + 31
      const int e = e0 + lane;
      int s = 0;
      bool kept = false;
      if (e < end) {
        kept = recv[e] == row;
        s = senders[e];
      }
      const unsigned mask = __ballot_sync(0xFFFFFFFFu, kept);
      const int n = __popc(mask);
      if (n == 0) continue;  // uniform
      if (kept) {
        const int pos = __popc(mask & ((1u << lane) - 1u));
        ids[pos] = s;
        const T* elp = tab + static_cast<long long>(s) * P + HD;
        for (int h = 0; h < H; ++h)
          wts[pos * H + h] = gat_weight(to_f32(elp[h]), cmax[h], neg_slope);
      }
      __syncwarp();
      // 2. den in edge order, one lane a head (with the first column chunk)
      if (cbase == 0) {
        for (int h = lane; h < H; h += 32) {
          float d = dens[h];
          for (int i = 0; i < n; ++i) d += round_to<T>(wts[i * H + h]);
          dens[h] = d;
        }
      }
      // 3. the walk: this group's kept edges, U rows in flight
      if (grp < G) {
        int i = grp;
        for (; i + (U - 1) * G < n; i += U * G)
          fwd_step<T, VEC, NCH, U>(tab, P, HD, H, ids, wts, i, G, c0, head, acc);
        if constexpr (MULTI)
          fwd_tail<T, VEC, NCH, U / 2>(tab, P, HD, H, ids, wts, i, n, G, c0, head, acc);
        for (; i < n; i += G)
          fwd_step<T, VEC, NCH, 1>(tab, P, HD, H, ids, wts, i, G, c0, head, acc);
      }
      __syncwarp();  // the next slots overwrite the table
    }
    if (MULTI) {  // the groups' partial sums, added in the order g = 0, 1, ..., G-1
      float part[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) part[q] = acc[0][q];
      for (int k = 1; k < G; ++k) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[0][q] += __shfl_sync(0xFFFFFFFFu, part[q], k * w + j);
      }
      if (grp == 0 && c0[0] < HD) Rows<T, VEC>::store(dst + c0[0], acc[0]);
    } else {
#pragma unroll
      for (int g = 0; g < NCH; ++g)
        if (c0[g] < HD) Rows<T, VEC>::store(dst + c0[g], acc[g]);
    }
  }
  __syncwarp();
  for (int h = lane; h < H; h += 32) dst[HD + h] = from_f32<T>(dens[h]);
  for (int c = HD + H + lane; c < P; c += 32) dst[c] = from_f32<T>(0.f);  // past [num | den]
}

template <typename T>
int launch_gat_fwd(const void* tab, const void* senders, const void* recv, const void* row_ptr,
                   const void* cmax, void* out, int n_rows, int P, int D, int H, float neg_slope,
                   int vec, int nch, int w, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H < 1 || w < 1 || w > 32 || G < 1 || w * G > 32 ||
      (G > 1 && (nch != 1 || w * vec < H * D)))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = static_cast<long long>(kWarpsPerBlock) * fwd_table_floats(H) * 4;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks_for_rows(n_rows)), block(kWarpsPerBlock * 32);
#define DGC_K5_LAUNCH(V, N, MULTI)                                                             \
  do {                                                                                         \
    auto kernel = gat_fwd_kernel<T, V, N, MULTI>;                                              \
    if (smem > 48 * 1024) {                                                                    \
      const cudaError_t e = cudaFuncSetAttribute(                                              \
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));        \
      if (e != cudaSuccess) return static_cast<int>(e);                                        \
    }                                                                                          \
    kernel<<<grid, block, static_cast<size_t>(smem), s>>>(                                     \
        static_cast<const T*>(tab), static_cast<const int*>(senders),                          \
        static_cast<const int*>(recv), static_cast<const int*>(row_ptr),                       \
        static_cast<const float*>(cmax), static_cast<T*>(out), n_rows, P, D, H, neg_slope, w, \
        G);                                                                                    \
  } while (0)
  // vec 4 (D and P multiples of 4, the tables 16-byte aligned) with nch 1, 2,
  // 3 or 6 groups of 128 columns a lane's walk, or vec 1 with 8 groups of 32;
  // wider rows walk their columns in chunks; lane groups with nch 1
  if (G > 1) {
    if (vec == 4) {
      DGC_K5_LAUNCH(4, 1, true);
    } else if (vec == 1) {
      DGC_K5_LAUNCH(1, 1, true);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (vec == 4 && nch == 1) {
    DGC_K5_LAUNCH(4, 1, false);
  } else if (vec == 4 && nch == 2) {
    DGC_K5_LAUNCH(4, 2, false);
  } else if (vec == 4 && nch == 3) {
    DGC_K5_LAUNCH(4, 3, false);
  } else if (vec == 4 && nch == 6) {
    DGC_K5_LAUNCH(4, 6, false);
  } else if (vec == 1 && nch == 8) {
    DGC_K5_LAUNCH(1, 8, false);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DGC_K5_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes.  tab and out are [n_rows, P] of one type,
// senders and recv (the receivers with dropped edges set to the sentinel)
// [E_pad] int32 in receiver (CSR) order, row_ptr [n_rows + 1] int32, cmax
// [H] float32.  `vec` is 4 when D and P are multiples of 4 and the tables are
// aligned for wide loads, else 1; `nch` the number of 32*vec-column groups a
// lane walks at once across the row's H*D columns; w and G the lane groups
// (G = 1, w = 32 but for narrow bf16 rows).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a form the kernel does not
// take.
#define DGC_K5_ENTRY(NAME, TT)                                                                \
  extern "C" int NAME(const void* tab, const void* senders, const void* recv,                 \
                      const void* row_ptr, const void* cmax, void* out, int n_rows, int P,     \
                      int D, int H, float neg_slope, int vec, int nch, int w, int G,           \
                      void* stream) {                                                          \
    return dgc::launch_gat_fwd<TT>(tab, senders, recv, row_ptr, cmax, out, n_rows, P, D, H,   \
                                   neg_slope, vec, nch, w, G, stream);                        \
  }

DGC_K5_ENTRY(dgc_gat_fwd_f32, float)
DGC_K5_ENTRY(dgc_gat_fwd_bf16, __nv_bfloat16)

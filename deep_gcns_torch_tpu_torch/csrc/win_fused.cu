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
// version's bit for bit.  The weights are taken against the final M, which
// gives the TPU kernel's sums directly (an online rescaled softmax would
// round differently).  round_T is the rounding to feat's type that the TPU
// kernel applies before its MXU product (`e.astype(cdk)`,
// ops/gat_dense.py:1338); num, den and M are float32.
//
// Replaces the TPU kernel `_k_fused` (deep_gcns_torch_tpu/ops/gat_dense.py:1274,
// called at :1380 by `_win_fused_call`), which scores every position of a
// 128-receiver block's dense [W, 128] window tile, masks, and runs one MXU
// product per head.
//
// What bounds it on the H100: bytes.  A (N_pad * W int8) and the hub counts
// are read once, feat rows of a block's window are shared by its 128
// receivers (L1/L2), num (float32, the largest array) is written once.
// chip_smoke.py prints the bound for its run.  The first port of it gave a
// warp to each (row, head): it scanned the row's counts and hub columns
// twice (once for M, once for the weights), hashing the drop for every
// non-zero count on each scan, so each row's counts were read and hashed
// 2·H times, then walked its ~14 kept positions one 256-position pass at a
// time, a short list of 3-4 feature rows and one dependent gather per pass,
// again for each head: 1.73 ms at 3 x 128 bf16 on the H100, 10.1x the byte
// bound.
//
// The design: one warp per receiver row, all heads, one scan.
//   1. The warp scans the row's window counts and in-kernel hub columns
//      once, 8 positions a lane a pass, hashes the drop once per non-zero
//      count, and compacts the kept positions (node id and count) into a
//      list in shared memory (popcount and warp prefix sum).
//   2. From the list alone: lanes over (entry, head) load el and store the
//      scores; M per head is a warp max of them and m_other; the weights
//      E = c·exp(min(s - M, 50)) and den per head follow, and round_T(E)
//      overwrites the score.
//   3. One feature walk for all heads: the lanes run across the row's H·D
//      columns (at 3 x 128 bf16, 384 values, 12 a lane), several rows in
//      flight, each column adding round_T(E)·feat in list order (the window's
//      positions, then the hub columns', as the first form did).
// The scan (`fill_list`, gat_dense.cuh, shared with K9) loads the counts of
// 2 passes before it decodes any, and the block copies the hub ids into
// shared memory first, so a row's count loads overlap and no hub-id load
// waits on a count.  The list holds L entries (`k7_list_size` in
// ops/gat_dense.py, 256 at up to 3 heads).  No bound on a row's kept
// positions holds in general (a band without hub rows, a wide window, 2048
// hub columns), so a longer row is done here in list-sized chunks: a first
// sweep over the chunks finds M, a second rescans them and adds the weights
// and the feature walk against it, num's partial sums carried through the
// row's own num (written and read again by the same lanes).  Rows wider
// than one walk's columns (32·VEC·NCH) walk the list once per column chunk.
//
// Forms measured on the H100 (80GB HBM3, 700 W) on the RevGAT-5L band with
// the step's drop (N=169,472, W=768, 128 hub columns, 13.9 kept positions a
// row), ms at 3x128 / 3x256 / 1x40 bf16 and 3x128 float32, by
// `chip_smoke.py --k7-forms` (each a copy of this source with one constant
// changed): kept (2 passes' counts a load, 4 blocks an SM, a 256-entry
// list) 0.543 / 0.773-0.775 / 0.366-0.367 / 0.516; 1 pass a load 0.551-0.552
// / 0.817-0.833 / 0.398-0.402 / 0.553; 4 passes a load 0.566-0.567 / 0.777-
// 0.778 / 0.380-0.381 / 0.519-0.520; 1 block an SM (up to 96 registers)
// 0.767-0.769 / 0.995-0.999 / 0.578 / 0.764; 3 blocks 0.608-0.609 / 0.813-
// 0.814 / 0.431-0.433 / 0.596-0.597; 5 blocks (48 registers, spilling)
// 0.594-0.595 / 1.014-1.016 / 0.364 / 0.620, with a 128-entry list 0.559-
// 0.560 / 0.893-0.895 / 0.365 / 0.564-0.566; 6 blocks and a 128-entry list
// 0.566-0.567 / 1.261-1.263 / 0.355 / 0.606-0.608; 8 blocks (32 registers)
// 0.793-0.794 / 2.544-2.547 / 0.372-0.374 / 0.892-0.894.  The first form of
// this design (one count load a pass, hub ids read from device memory, 80-98
// registers) read 0.650 / 1.077-1.084 / 0.678 / 0.649-0.656 by
// `chip_smoke.py --kernel-times`, where the (row, head) form read 1.726-
// 1.728 / 2.173-2.175 / 0.655-0.656 / 1.764.
#include "gat_dense.cuh"

namespace dgc {

// A warp's part of the dynamic shared memory: the list's node ids and
// counts, its scores (then rounded weights) [L, H], and M and den per head.
struct RowList {
  int* id;
  float* cnt;
  float* w;
  float* m;
  float* den;
};

__host__ __device__ inline long long row_list_floats(int L, int H) {
  return static_cast<long long>(L) * (2 + H) + 2LL * H;
}

__device__ __forceinline__ RowList row_list(float* base, int L, int H) {
  RowList r;
  r.id = reinterpret_cast<int*>(base);
  r.cnt = base + L;
  r.w = base + 2 * L;
  r.m = r.w + static_cast<long long>(L) * H;
  r.den = r.m + H;
  return r;
}

// Passes whose counts a lane loads before it decodes any (`fill_list` in
// gat_dense.cuh), so that a row's count loads overlap (the RevGAT band's rows
// have 3 window passes and one of hub columns: two batches).  4 passes at
// once measured slower at 64 registers a thread.
constexpr int kScanBatch = 2;

// Scores of the list's n entries, w[i, h] = lrelu(el[id_i, h] + er[r, h]),
// lanes over (entry, head), two el loads in flight a lane; then M[h] =
// max(M[h], the scores' max).
__device__ __forceinline__ void list_scores(const RowList& rl, int n, int H,
                                            const float* __restrict__ el,
                                            const float* __restrict__ er_row, float ns,
                                            int lane) {
  const int nh = n * H;
  for (int k = lane; k < nh; k += 64) {
    const int k2 = k + 32;
    const int i = k / H, i2 = k2 / H;
    const float a = el[static_cast<long long>(rl.id[i]) * H + (k - i * H)];
    const float c = k2 < nh ? el[static_cast<long long>(rl.id[i2]) * H + (k2 - i2 * H)] : 0.f;
    rl.w[k] = lrelu(__fadd_rn(a, er_row[k - i * H]), ns);
    if (k2 < nh) rl.w[k2] = lrelu(__fadd_rn(c, er_row[k2 - i2 * H]), ns);
  }
  __syncwarp();
  for (int h = 0; h < H; ++h) {
    float m = kNegScore;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, rl.w[i * H + h]);
    m = warp_max(m);
    if (lane == 0) rl.m[h] = fmaxf(rl.m[h], m);
  }
  __syncwarp();
}

// The weights against M: den[h] += sum E (each lane's partial, then the
// warp's), and w[i, h] = round_T(E).
template <typename T>
__device__ __forceinline__ void list_weights(const RowList& rl, int n, int H, int lane) {
  for (int h = 0; h < H; ++h) {
    const float m = rl.m[h];
    float d = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = edge_weight(rl.cnt[i], rl.w[i * H + h], m);
      d = __fadd_rn(d, e);
      rl.w[i * H + h] = round_to<T>(e);
    }
    d = warp_sum(d);
    if (lane == 0) rl.den[h] = __fadd_rn(rl.den[h], d);
  }
  __syncwarp();
}

// Feature rows a lane keeps in flight when it holds `vals` values of a row.
template <int VALS> struct RowsInFlight {
  static constexpr int value = VALS <= 4 ? 8 : (VALS <= 12 ? 4 : (VALS <= 24 ? 2 : 1));
};

template <typename T, int VEC, int NCH, int U>
__device__ __forceinline__ void walk_step(const T* __restrict__ feat, long long hd, int H,
                                          const RowList& rl, int j, const int (&c0)[NCH],
                                          const int (&head)[NCH], int HD,
                                          float (&acc)[NCH][VEC]) {
  float v[U][NCH][VEC];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const T* frow = feat + static_cast<long long>(rl.id[j + u]) * hd;
#pragma unroll
    for (int g = 0; g < NCH; ++g) {
      if (c0[g] < HD) {
        Rows<T, VEC>::load(frow + c0[g], v[u][g]);
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
      const float wt = rl.w[(j + u) * H + head[g]];
#pragma unroll
      for (int q = 0; q < VEC; ++q) acc[g][q] = __fadd_rn(acc[g][q], __fmul_rn(wt, v[u][g][q]));
    }
  }
}

// num_row[c] (+)= sum_i w[i, head(c)] * feat[id_i, c] over the list, in list
// order; `first`: the row's first chunk (num starts at 0, else at what the
// previous chunk stored).  The lanes run across the H·D columns, VEC a lane
// in NCH groups, in chunks of 32·VEC·NCH columns.
template <typename T, int VEC, int NCH>
__device__ __forceinline__ void list_walk(const T* __restrict__ feat, int HD, int D, int H,
                                          const RowList& rl, int n, bool first,
                                          float* __restrict__ num_row, int lane) {
  constexpr int U = RowsInFlight<NCH * VEC>::value;
  for (int base = 0; base < HD; base += 32 * VEC * NCH) {
    int c0[NCH], head[NCH];
    float acc[NCH][VEC];
#pragma unroll
    for (int g = 0; g < NCH; ++g) {
      c0[g] = base + g * 32 * VEC + lane * VEC;
      head[g] = c0[g] < HD ? c0[g] / D : 0;  // D is a multiple of VEC: one head a group
      if (!first && c0[g] < HD) {
        Rows<float, VEC>::load(num_row + c0[g], acc[g]);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[g][q] = 0.f;
      }
    }
    int j = 0;
    for (; j + U <= n; j += U) walk_step<T, VEC, NCH, U>(feat, HD, H, rl, j, c0, head, HD, acc);
    for (; j < n; ++j) walk_step<T, VEC, NCH, 1>(feat, HD, H, rl, j, c0, head, HD, acc);
#pragma unroll
    for (int g = 0; g < NCH; ++g)
      if (c0[g] < HD) Rows<float, VEC>::store(num_row + c0[g], acc[g]);
  }
}

// Blocks an SM keeps resident: the compiler fits each thread in 64
// registers, which the 3 x 128 bf16 form takes without spilling; the 3 x 256
// form spills about 100 bytes and still measured faster than at 3 blocks an
// SM (see the head of this file for the forms measured).
constexpr int kMinBlocks = 4;

template <typename T, int VEC, int NCH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocks)
win_fused_kernel(DenseBand b, const float* __restrict__ el, const float* __restrict__ er,
                 const float* __restrict__ m_other, const T* __restrict__ feat,
                 float* __restrict__ num, float* __restrict__ den, float* __restrict__ m_out,
                 int L) {
  // dynamic shared memory: the hub ids (n_hub ints), then each warp's list
  extern __shared__ float smem[];
  const int* hub_ids = stage_hub_ids(b, smem);
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + wib;
  if (row >= b.n_rows) return;  // the whole warp leaves
  const int H = b.H, HD = b.H * b.D;
  const RowList rl = row_list(smem + b.n_hub + wib * row_list_floats(L, H), L, H);
  const long long rh = static_cast<long long>(row) * H;
  for (int h = lane; h < H; h += 32) {
    rl.m[h] = fmaxf(kNegScore, m_other[rh + h]);
    rl.den[h] = 0.f;
  }
  const int w_lo = b.w_lo[row / kBlockRows];
  const int n_win = (b.W + kPass - 1) / kPass;
  const int n_pass = n_win + (b.n_hub + kPass - 1) / kPass;
  const float* er_row = er + rh;
  float* num_row = num + static_cast<long long>(row) * HD;

  // 1-2. one scan into the list, the scores and M
  Cursor cur{0, 0};
  bool more;
  int n = fill_list<kScanBatch>(b, row, w_lo, n_win, n_pass, lane, false, L, 0, cur, hub_ids,
                                rl.id, rl.cnt, more);
  __syncwarp();
  list_scores(rl, n, H, el, er_row, b.ns, lane);
  const bool chunked = more;
  for (int lo = L; more; lo += L) {  // a row longer than the list: M over every chunk
    __syncwarp();
    n = fill_list<kScanBatch>(b, row, w_lo, n_win, n_pass, lane, false, L, lo, cur, hub_ids,
                              rl.id, rl.cnt, more);
    __syncwarp();
    list_scores(rl, n, H, el, er_row, b.ns, lane);
  }

  // 2-3. the weights against M and the feature walk
  if (!chunked) {
    list_weights<T>(rl, n, H, lane);
    list_walk<T, VEC, NCH>(feat, HD, b.D, H, rl, n, true, num_row, lane);
  } else {
    cur = Cursor{0, 0};
    for (int lo = 0;; lo += L) {
      __syncwarp();
      n = fill_list<kScanBatch>(b, row, w_lo, n_win, n_pass, lane, false, L, lo, cur, hub_ids,
                                rl.id, rl.cnt, more);
      __syncwarp();
      // the scores again; their maxima change nothing now
      list_scores(rl, n, H, el, er_row, b.ns, lane);
      list_weights<T>(rl, n, H, lane);
      list_walk<T, VEC, NCH>(feat, HD, b.D, H, rl, n, lo == 0, num_row, lane);
      if (!more) break;
    }
  }
  __syncwarp();
  for (int h = lane; h < H; h += 32) {
    den[rh + h] = rl.den[h];
    m_out[rh + h] = rl.m[h];
  }
}

template <typename T>
int launch_win_fused(const DenseBand& b, const void* el, const void* er, const void* m_other,
                     const void* feat, void* num, void* den, void* m_out, int vec, int nch,
                     int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || b.H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = (b.n_hub + kWarpsPerBlock * row_list_floats(L, b.H)) * 4;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks_for_rows(b.n_rows)), block(kWarpsPerBlock * 32);
#define DGC_K7_LAUNCH(TT, V, N)                                                             \
  do {                                                                                      \
    auto kernel = win_fused_kernel<TT, V, N>;                                               \
    if (smem > 48 * 1024) {                                                                 \
      const cudaError_t e = cudaFuncSetAttribute(                                           \
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));     \
      if (e != cudaSuccess) return static_cast<int>(e);                                     \
    }                                                                                       \
    kernel<<<grid, block, static_cast<size_t>(smem), s>>>(                                  \
        b, static_cast<const float*>(el), static_cast<const float*>(er),                    \
        static_cast<const float*>(m_other), static_cast<const TT*>(feat),                   \
        static_cast<float*>(num), static_cast<float*>(den), static_cast<float*>(m_out), L); \
  } while (0)
  // vec 4 (D and H*D multiples of 4, the row tables 16-byte aligned) with
  // nch 1, 2, 3 or 6 groups of 128 columns a lane's walk, or vec 1 with 8
  // groups of 32; wider rows walk their columns in chunks
  if (vec == 4 && nch == 1) {
    DGC_K7_LAUNCH(T, 4, 1);
  } else if (vec == 4 && nch == 2) {
    DGC_K7_LAUNCH(T, 4, 2);
  } else if (vec == 4 && nch == 3) {
    DGC_K7_LAUNCH(T, 4, 3);
  } else if (vec == 4 && nch == 6) {
    DGC_K7_LAUNCH(T, 4, 6);
  } else if (vec == 1 && nch == 8) {
    DGC_K7_LAUNCH(T, 1, 8);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DGC_K7_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes.  a [n_rows, W] int8 (W a multiple of 8),
// w_lo [n_rows / 128] int32, a_hub [n_rows, n_hub] bf16 (n_hub a multiple of
// 8, 16-byte aligned) and hub_ids [n_hub] int32, or null for no hub columns;
// el, er, m_other, den, m_out [n_rows, H] float32; feat [n_rows, H*D] of the
// entry point's type, num [n_rows, H*D] float32.  thresh < 0 means no drop;
// k0/k1 are the drop key's int32 bits.  vec and nch choose the walk's form,
// L the entries of a warp's list.  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a form or list the kernel does not
// take.
#define DGC_K7_ENTRY(NAME, TT)                                                              \
  extern "C" int NAME(const void* a, const void* w_lo, const void* a_hub, const void* hub_ids, \
                      const void* el, const void* er, const void* m_other, const void* feat,  \
                      void* num, void* den, void* m_out, int n_rows, int W, int n_hub, int H, \
                      int D, float ns, uint32_t k0, uint32_t k1, int thresh, int vec, int nch, \
                      int L, void* stream) {                                                  \
    const dgc::DenseBand b =                                                                  \
        dgc::make_band(a, w_lo, a_hub, hub_ids, n_rows, W, n_hub, H, D, ns, k0, k1, thresh);  \
    return dgc::launch_win_fused<TT>(b, el, er, m_other, feat, num, den, m_out, vec, nch, L,  \
                                     stream);                                                 \
  }

DGC_K7_ENTRY(dgc_win_fused_f32, float)
DGC_K7_ENTRY(dgc_win_fused_bf16, __nv_bfloat16)

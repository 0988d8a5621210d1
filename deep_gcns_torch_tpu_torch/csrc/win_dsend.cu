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
// 128-lane container and two MXU products per head.
//
// What bounds it on the H100: bytes (the transpose band's counts read once,
// el, er, M, gden, feat and gnum read once, the gnum rows of a block's
// window shared in L1/L2, d_feat float32 written once).  chip_smoke.py prints
// the bound for its run.  The first form of this kernel gave a warp to each
// (sender row, head): it loaded and drop-hashed each row's counts H times
// (`for_each_pass`, gat_dense.cuh), gathered er, M and gden per listed
// receiver in the scan, and for each receiver read gnum's head slice and ran
// a 5-step shuffle butterfly (the dot <feat_s, gnum_r>_h) before d_el could
// take the term: a short list of ~14 entries a row, each a dependent load
// and a butterfly, H times a row.  1.652 ms at 3 x 128 bf16 on the H100,
// 7.9x the byte bound.
//
// The design: one warp per sender row, all heads, one scan (K7's),
// plus one piece of algebra that takes the dot out of the list walk:
//
//   d_el[s, h] = sum_{c in h} feat[s, c] * G[c] + sum_r a_r * gden[r, h],
//   G[c] = sum_r a_r * gnum[r, c],   a_r = E_r * lrelu'(z_r),
//
// which equals sum_r t up to the order of float32 sums (the freedom the
// tolerance of d_el already grants the per-head dot's order).
//   1. The warp scans the row's window counts and in-kernel hub columns once
//      (`fill_list`, gat_dense.cuh, shared with K7), hashes the drop once per
//      non-zero count, and compacts the kept receivers (id, count) into a
//      list in shared memory.
//   2. From the list: lanes over (entry, head) gather er, M and store
//      round_T(E) and a per (entry, head).
//   3. One walk over the row's H·D columns, lanes across them, several gnum
//      rows in flight: each column adds round_T(E)·gnum (d_feat, in list
//      order: the first form's product and order, so d_feat is its bit for
//      bit) and a·gnum (G, float32).
//   4. At the end of the walk, one warp reduction per head per row: the
//      lane's feat[s]·G over its columns of the head, plus (lanes over the
//      list) a·gden.
// K9 has no maximum to find (M comes in), so a row longer than the list is
// done in list-sized chunks in one sweep: d_feat's partial sums are carried
// through the row's own d_feat (written and read again by the same lanes,
// which keeps the order), and each chunk's feat·G and a·gden add into the
// row's per-head d_el in shared memory.  Rows wider than one walk's columns
// (32·VEC·NCH) walk the list once per column chunk.
//
// Forms measured on the H100 (80GB HBM3, 700 W) on the RevGAT-5L transpose
// band with the step's drop (N=169,472, W=768, 128 hub columns), ms at
// 3x128 / 3x256 / 1x40 bf16 and 3x128 float32, by
// `chip_smoke.py --kernel-forms=K9` (each a copy of this source with one
// constant changed, or the wrapper's list or walk form): kept (2 passes'
// counts a load, 24 gnum values in flight a lane, 4 blocks an SM, a
// 160-entry list at 3 heads) 0.573-0.576 / 0.862-0.867 / 0.389-0.395 /
// 0.599-0.601; 1 pass a load 0.620-0.625 / 0.915-0.918 / 0.411-0.412 /
// 0.619-0.621; half the rows in flight 0.607-0.612 / 0.946-0.952 /
// 0.375-0.379 / 0.608-0.613; twice 0.596-0.612 / 0.892-0.911 / 0.388-0.431
// / 0.632-0.656; 3 blocks 0.659-0.664 / 0.978-0.981 / 0.441-0.443 /
// 0.653-0.658; 2 blocks 0.822-0.828 / 1.175-1.183 / 0.438-0.445 /
// 0.833-0.838; a 64-entry list 0.570-0.574 / 0.860-0.868 / 0.388-0.394 /
// 0.589-0.593; a 224-entry list 0.671-0.676 / 0.996-1.014 / 0.389-0.394 /
// 0.709-0.714; one walk at 3x256 (3 blocks) 0.661-0.664 / 1.432-1.438 /
// 0.441-0.444 / 0.653-0.657.  A form that loaded the walk's first rows
// before the list's terms read 0.585-0.589 / 0.880-0.886 / 0.406-0.430 /
// 0.609-0.611.  The first form read 1.641-1.655 / 1.933-1.946 /
// 0.584-0.590 / 1.674-1.687 by `chip_smoke.py --kernel-times`.
#include "gat_dense.cuh"

namespace dgc {

// Passes whose counts a lane loads before it decodes any (`fill_list`).
constexpr int kScanBatch = 2;
// Values of gnum rows a lane keeps in flight in the walk: rows in flight =
// kFlightValues / (values a lane holds of one row), at least 1.
constexpr int kFlightValues = 24;
// Blocks an SM keeps resident: 64 registers a thread.
constexpr int kMinBlocks = 4;

// A warp's part of the dynamic shared memory: the list's receiver ids and
// counts, round_T(E) and a = E·lrelu'(z) per (entry, head), and the row's
// d_el per head.
struct DsendList {
  int* id;
  float* cnt;
  float* w;
  float* a;
  float* d_el;
};

__host__ __device__ inline long long dsend_list_floats(int L, int H) {
  return static_cast<long long>(L) * (2 + 2 * H) + H;
}

__device__ __forceinline__ DsendList dsend_list(float* base, int L, int H) {
  DsendList r;
  r.id = reinterpret_cast<int*>(base);
  r.cnt = base + L;
  r.w = base + 2 * L;
  r.a = r.w + static_cast<long long>(L) * H;
  r.d_el = r.a + static_cast<long long>(L) * H;
  return r;
}

// One (entry, head) of the list: round_T(E) and a.
template <typename T>
__device__ __forceinline__ void dsend_term(const DsendList& dl, int k, int H,
                                           const float* __restrict__ el_row,
                                           const float* __restrict__ er,
                                           const float* __restrict__ M, float ns) {
  const int i = k / H, h = k - i * H;
  const long long rk = static_cast<long long>(dl.id[i]) * H + h;
  const float z = __fadd_rn(el_row[h], er[rk]);
  const float e = edge_weight(dl.cnt[i], lrelu(z, ns), M[rk]);
  dl.w[k] = round_to<T>(e);
  dl.a[k] = __fmul_rn(e, dlrelu(z, ns));
}

// The list's n entries' terms, lanes over (entry, head), two in flight a lane.
template <typename T>
__device__ __forceinline__ void dsend_terms(const DsendList& dl, int n, int H,
                                            const float* __restrict__ el_row,
                                            const float* __restrict__ er,
                                            const float* __restrict__ M, float ns, int lane) {
  const int nh = n * H;
  for (int k = lane; k < nh; k += 64) {
    dsend_term<T>(dl, k, H, el_row, er, M, ns);
    if (k + 32 < nh) dsend_term<T>(dl, k + 32, H, el_row, er, M, ns);
  }
  __syncwarp();
}

template <int VALS> struct DsendRowsInFlight {
  static constexpr int value = kFlightValues / VALS > 1 ? kFlightValues / VALS : 1;
};

template <typename T, int VEC, int NCH, int U>
__device__ __forceinline__ void dsend_step(const T* __restrict__ gnum, int HD, int H,
                                           const DsendList& dl, int j, const int (&c0)[NCH],
                                           const int (&head)[NCH], float (&acc)[NCH][VEC],
                                           float (&G)[NCH][VEC]) {
  float v[U][NCH][VEC];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const T* grow = gnum + static_cast<long long>(dl.id[j + u]) * HD;
#pragma unroll
    for (int g = 0; g < NCH; ++g) {
      if (c0[g] < HD) {
        Rows<T, VEC>::load(grow + c0[g], v[u][g]);
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
      const int k = (j + u) * H + head[g];
      const float wt = dl.w[k], at = dl.a[k];
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        acc[g][q] = __fadd_rn(acc[g][q], __fmul_rn(wt, v[u][g][q]));
        G[g][q] = fmaf(at, v[u][g][q], G[g][q]);
      }
    }
  }
}

// d_feat_row[c] (+)= sum_i w[i, head(c)] * gnum[id_i, c] in list order, and
// d_el[h] += sum_{c in h} feat_row[c] * G[c] (+ sum_i a[i, h] * gden[id_i, h]
// once per list chunk, with the last column chunk); `first`: the row's first
// list chunk (d_feat starts at 0, else at what the previous chunk stored).
template <typename T, int VEC, int NCH>
__device__ __forceinline__ void dsend_walk(const T* __restrict__ feat_row,
                                           const T* __restrict__ gnum,
                                           const float* __restrict__ gden, int HD, int D, int H,
                                           const DsendList& dl, int n, bool first,
                                           float* __restrict__ d_feat_row, int lane) {
  constexpr int U = DsendRowsInFlight<NCH * VEC>::value;
  constexpr int SPAN = 32 * VEC * NCH;
  for (int base = 0; base < HD; base += SPAN) {
    int c0[NCH], head[NCH];
    float acc[NCH][VEC], G[NCH][VEC];
#pragma unroll
    for (int g = 0; g < NCH; ++g) {
      c0[g] = base + g * 32 * VEC + lane * VEC;
      head[g] = c0[g] < HD ? c0[g] / D : 0;  // D is a multiple of VEC: one head a group
      if (!first && c0[g] < HD) {
        Rows<float, VEC>::load(d_feat_row + c0[g], acc[g]);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[g][q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < VEC; ++q) G[g][q] = 0.f;
    }
    int j = 0;
    for (; j + U <= n; j += U) dsend_step<T, VEC, NCH, U>(gnum, HD, H, dl, j, c0, head, acc, G);
    for (; j < n; ++j) dsend_step<T, VEC, NCH, 1>(gnum, HD, H, dl, j, c0, head, acc, G);
#pragma unroll
    for (int g = 0; g < NCH; ++g) {
      if (c0[g] < HD) Rows<float, VEC>::store(d_feat_row + c0[g], acc[g]);
      // G now holds the lane's feat[s] · G terms, column by column
      float f[VEC];
      if (c0[g] < HD) {
        Rows<T, VEC>::load(feat_row + c0[g], f);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) f[q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < VEC; ++q) G[g][q] = __fmul_rn(f[q], G[g][q]);
    }
    // one warp reduction per head: the heads of this column chunk, and with
    // the last chunk every head, which also takes the list's a·gden
    const int end = base + SPAN < HD ? base + SPAN : HD;
    const bool last = end == HD;
    const int h_lo = last ? 0 : base / D, h_hi = last ? H - 1 : (end - 1) / D;
    for (int h = h_lo; h <= h_hi; ++h) {
      float v = 0.f;
#pragma unroll
      for (int g = 0; g < NCH; ++g) {
        if (c0[g] < HD && head[g] == h) {
#pragma unroll
          for (int q = 0; q < VEC; ++q) v = __fadd_rn(v, G[g][q]);
        }
      }
      if (last)
        for (int i = lane; i < n; i += 32)
          v = fmaf(dl.a[i * H + h], gden[static_cast<long long>(dl.id[i]) * H + h], v);
      v = warp_sum(v);
      if (lane == 0) dl.d_el[h] = __fadd_rn(dl.d_el[h], v);
    }
  }
}

template <typename T, int VEC, int NCH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocks)
win_dsend_kernel(DenseBand b, const float* __restrict__ el, const float* __restrict__ er,
                 const float* __restrict__ M, const float* __restrict__ gden,
                 const T* __restrict__ feat, const T* __restrict__ gnum,
                 float* __restrict__ d_el_out, float* __restrict__ d_feat, int L) {
  // dynamic shared memory: the hub ids (n_hub ints), then each warp's list
  extern __shared__ float smem[];
  const int* hub_ids = stage_hub_ids(b, smem);
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + wib;
  if (row >= b.n_rows) return;  // the whole warp leaves
  const int H = b.H, HD = b.H * b.D;
  const DsendList dl = dsend_list(smem + b.n_hub + wib * dsend_list_floats(L, H), L, H);
  const long long rh = static_cast<long long>(row) * H;
  for (int h = lane; h < H; h += 32) dl.d_el[h] = 0.f;
  const int w_lo = b.w_lo[row / kBlockRows];
  const int n_win = (b.W + kPass - 1) / kPass;
  const int n_pass = n_win + (b.n_hub + kPass - 1) / kPass;
  const float* el_row = el + rh;
  const T* feat_row = feat + static_cast<long long>(row) * HD;
  float* d_feat_row = d_feat + static_cast<long long>(row) * HD;
  Cursor cur{0, 0};
  bool more = true;
  for (int lo = 0; more; lo += L) {
    __syncwarp();
    const int n = fill_list<kScanBatch>(b, row, w_lo, n_win, n_pass, lane, true, L, lo, cur,
                                        hub_ids, dl.id, dl.cnt, more);
    __syncwarp();
    if (n == 0) {  // only a row with no kept position: d_feat and d_el are 0
      const float zero[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = lane * VEC; c < HD; c += 32 * VEC)
        Rows<float, VEC>::store(d_feat_row + c, zero);
      break;
    }
    dsend_terms<T>(dl, n, H, el_row, er, M, b.ns, lane);
    dsend_walk<T, VEC, NCH>(feat_row, gnum, gden, HD, b.D, H, dl, n, lo == 0, d_feat_row,
                            lane);
  }
  __syncwarp();
  for (int h = lane; h < H; h += 32) d_el_out[rh + h] = dl.d_el[h];
}

template <typename T>
int launch_win_dsend(const DenseBand& b, const void* el, const void* er, const void* M,
                     const void* gden, const void* feat, const void* gnum, void* d_el,
                     void* d_feat, int vec, int nch, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || b.H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = (b.n_hub + kWarpsPerBlock * dsend_list_floats(L, b.H)) * 4;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks_for_rows(b.n_rows)), block(kWarpsPerBlock * 32);
#define DGC_K9_LAUNCH(TT, V, N)                                                               \
  do {                                                                                        \
    auto kernel = win_dsend_kernel<TT, V, N>;                                                 \
    if (smem > 48 * 1024) {                                                                   \
      const cudaError_t e = cudaFuncSetAttribute(                                             \
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));       \
      if (e != cudaSuccess) return static_cast<int>(e);                                       \
    }                                                                                         \
    kernel<<<grid, block, static_cast<size_t>(smem), s>>>(                                    \
        b, static_cast<const float*>(el), static_cast<const float*>(er),                      \
        static_cast<const float*>(M), static_cast<const float*>(gden),                        \
        static_cast<const TT*>(feat), static_cast<const TT*>(gnum), static_cast<float*>(d_el), \
        static_cast<float*>(d_feat), L);                                                      \
  } while (0)
  // vec 4 (D and H*D multiples of 4, the row tables 16-byte aligned) with
  // nch 1, 2, 3 or 6 groups of 128 columns a lane's walk, or vec 1 with 8
  // groups of 32; wider rows walk their columns in chunks
  if (vec == 4 && nch == 1) {
    DGC_K9_LAUNCH(T, 4, 1);
  } else if (vec == 4 && nch == 2) {
    DGC_K9_LAUNCH(T, 4, 2);
  } else if (vec == 4 && nch == 3) {
    DGC_K9_LAUNCH(T, 4, 3);
  } else if (vec == 4 && nch == 6) {
    DGC_K9_LAUNCH(T, 4, 6);
  } else if (vec == 1 && nch == 8) {
    DGC_K9_LAUNCH(T, 1, 8);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DGC_K9_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes: the transpose band as for dgc_win_fused_*;
// el, er, M, gden and d_el [n_rows, H] float32; feat and gnum [n_rows, H*D]
// of the entry point's type, d_feat [n_rows, H*D] float32.  vec and nch
// choose the walk's form, L the entries of a warp's list.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a form
// or list the kernel does not take.
#define DGC_K9_ENTRY(NAME, TT)                                                              \
  extern "C" int NAME(const void* a, const void* w_lo, const void* a_hub, const void* hub_ids, \
                      const void* el, const void* er, const void* M, const void* gden,        \
                      const void* feat, const void* gnum, void* d_el, void* d_feat,           \
                      int n_rows, int W, int n_hub, int H, int D, float ns, uint32_t k0,      \
                      uint32_t k1, int thresh, int vec, int nch, int L, void* stream) {       \
    const dgc::DenseBand b =                                                                  \
        dgc::make_band(a, w_lo, a_hub, hub_ids, n_rows, W, n_hub, H, D, ns, k0, k1, thresh);  \
    return dgc::launch_win_dsend<TT>(b, el, er, M, gden, feat, gnum, d_el, d_feat, vec, nch,  \
                                     L, stream);                                              \
  }

DGC_K9_ENTRY(dgc_win_dsend_f32, float)
DGC_K9_ENTRY(dgc_win_dsend_bf16, __nv_bfloat16)

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
// tile of a block and one MXU product per head for the dots.
//
// What bounds it on the H100: bytes (the forward band's counts read once,
// el, er, M, gden, feat and gnum read once, the feature rows of a block's
// window shared in L1/L2, d_er written once).  chip_smoke.py prints the
// bound for its run.  The first form of this kernel gave a warp to each
// (receiver row, head): it loaded and drop-hashed each row's counts H times
// (once per head's warp), and for each listed sender read feat's
// head slice and ran a 5-step shuffle butterfly (the dot <feat_s, gnum_r>_h)
// before d_er could take the term: a short list of ~14 entries a row, each
// a dependent load and a butterfly, H times a row.  1.231 ms at 3 x 128
// bf16 on the H100 (80GB HBM3, 700 W), 9.3x the byte bound.
//
// The design: one warp per receiver row, all heads, one scan (K7's and
// K9's), and the dot taken out of the list walk by the same algebra as K9's:
//
//   d_er[r, h] = sum_{c in h} gnum[r, c] * F[c] + gden[r, h] * A_h,
//   F[c] = sum_s a_s * feat[s, c],   A_h = sum_s a_s,   a_s = E_s * lrelu'(z_s),
//
// which equals sum_s t up to the order of float32 sums (the freedom the
// tolerance of d_er already grants the per-head dot's order).
//   1. The warp scans the row's window counts and in-kernel hub columns once
//      (`fill_list`, gat_dense.cuh), hashes the drop once per non-zero count,
//      and compacts the kept senders (id, count) into a list in shared
//      memory.
//   2. From the list: lanes over (entry, head) gather el and store
//      a = E * lrelu'(z) per (entry, head).
//   3. One walk over the row's H·D columns, lanes across them, several feat
//      rows in flight: each column adds a·feat into F (float32), and the lane
//      that holds a head's first column also adds a into A_h.
//   4. At the end of the row, one warp reduction per head: the lane's
//      gnum[r]·F over its columns of the head, plus gden·A_h.
// M comes in, so there is no maximum to find: a row longer than the list is
// done in list-sized chunks in one sweep, F and A carried in registers.
// Rows wider than one walk's columns (32·VEC·NCH: 3 x 256) walk each list
// chunk once per column chunk, and each chunk's per-head partials add into
// the row's d_er in shared memory.  A_h takes no reduction of its own: the
// lane that holds a head's first column adds every entry's a, and adds
// gden·A_h into its part of the head's one reduction.  d_er holds the
// plain version within TOL_DENSE_T in float32 on receiver rows of up to 700
// positions (chip_smoke.py's long-row band).
//
// Forms measured on the H100 (80GB HBM3, 700 W) on the RevGAT-5L band with
// the step's drop (N=169,472, W=768, 128 hub columns), ms at 3x128 / 3x256
// / 1x40 bf16 and 3x128 float32, by `chip_smoke.py --kernel-forms=K8` (each
// a copy of this source with one constant changed, or the wrapper's list or
// walk form): kept (2 passes' counts a load, 36 feat values in flight a
// lane, 4 blocks an SM, a 256-entry list at 3 heads, 3 x 256 in two column
// chunks) 0.501 / 0.700-0.701 / 0.359-0.360 / 0.505-0.507; 1 pass a load
// 0.541 / 0.739-0.740 / 0.397-0.398 / 0.546-0.567; 24 values in flight
// 0.509-0.511 / 0.716-0.718 / 0.350-0.351 / 0.519; 48 0.508-0.510 /
// 0.720-0.722 / 0.358 / 0.499; 3 blocks 0.581 / 0.804-0.806 / 0.415-0.416
// / 0.585; 5 blocks 0.505-0.506 / 0.731 / 0.339 / 0.598-0.600; a 128-entry
// list 0.498-0.499 / 0.696 / 0.358 / 0.499-0.500; one walk at 3x256 (3
// blocks) 0.580 / 0.878-0.880 / 0.415 / 0.585.  At one head (1 x 40) the
// scan and the per-row shuffles set the time, as for K7 (0.367) and K9
// (0.390).  The first form read 1.227-1.231 / 1.581-1.591 / 0.434-0.437 /
// 1.248-1.254 by `chip_smoke.py --kernel-times`.
#include "gat_dense.cuh"

namespace dgc {

// Passes whose counts a lane loads before it decodes any (`fill_list`).
constexpr int kScanBatch = 2;
// Values of feat rows a lane keeps in flight in the walk: rows in flight =
// kFlightValues / (values a lane holds of one row), between 1 and 8.
constexpr int kFlightValues = 36;
// Blocks an SM keeps resident: 64 registers a thread.
constexpr int kMinBlocks = 4;

// A warp's part of the dynamic shared memory: the list's sender ids and
// counts, a = E·lrelu'(z) per (entry, head), and the row's d_er per head.
struct DerList {
  int* id;
  float* cnt;
  float* a;
  float* d_er;
};

__host__ __device__ inline long long der_list_floats(int L, int H) {
  return static_cast<long long>(L) * (2 + H) + H;
}

__device__ __forceinline__ DerList der_list(float* base, int L, int H) {
  DerList r;
  r.id = reinterpret_cast<int*>(base);
  r.cnt = base + L;
  r.a = base + 2 * L;
  r.d_er = r.a + static_cast<long long>(L) * H;
  return r;
}

// One (entry, head) of the list: a = E·lrelu'(z).
__device__ __forceinline__ void der_term(const DerList& dl, int k, int H,
                                         const float* __restrict__ el,
                                         const float* __restrict__ er_row,
                                         const float* __restrict__ m_row, float ns) {
  const int i = k / H, h = k - i * H;
  const float z = __fadd_rn(el[static_cast<long long>(dl.id[i]) * H + h], er_row[h]);
  const float e = edge_weight(dl.cnt[i], lrelu(z, ns), m_row[h]);
  dl.a[k] = __fmul_rn(e, dlrelu(z, ns));
}

// The list's n entries' terms, lanes over (entry, head), two in flight a lane.
__device__ __forceinline__ void der_terms(const DerList& dl, int n, int H,
                                          const float* __restrict__ el,
                                          const float* __restrict__ er_row,
                                          const float* __restrict__ m_row, float ns, int lane) {
  const int nh = n * H;
  for (int k = lane; k < nh; k += 64) {
    der_term(dl, k, H, el, er_row, m_row, ns);
    if (k + 32 < nh) der_term(dl, k + 32, H, el, er_row, m_row, ns);
  }
  __syncwarp();
}

template <int VALS> struct DerRowsInFlight {
  static constexpr int raw = kFlightValues / VALS;
  static constexpr int value = raw < 1 ? 1 : (raw > 8 ? 8 : raw);
};

// The lane's columns of the column chunk at `base`: c0[g] (HD and past: none)
// and its head.
template <int VEC, int NCH>
__device__ __forceinline__ void der_columns(int base, int HD, int D, int lane, int (&c0)[NCH],
                                            int (&head)[NCH]) {
#pragma unroll
  for (int g = 0; g < NCH; ++g) {
    c0[g] = base + g * 32 * VEC + lane * VEC;
    head[g] = c0[g] < HD ? c0[g] / D : 0;  // D is a multiple of VEC: one head a group
  }
}

// U list entries from j: F[c] += a[head(c)]·feat[id, c] and A[g] += a.
template <typename T, int VEC, int NCH, int U>
__device__ __forceinline__ void der_step(const T* __restrict__ feat, int HD, int H,
                                         const DerList& dl, int j, const int (&c0)[NCH],
                                         const int (&head)[NCH], float (&F)[NCH][VEC],
                                         float (&A)[NCH]) {
  float v[U][NCH][VEC];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const T* frow = feat + static_cast<long long>(dl.id[j + u]) * HD;
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
      const float at = dl.a[(j + u) * H + head[g]];
#pragma unroll
      for (int q = 0; q < VEC; ++q) F[g][q] = fmaf(at, v[u][g][q], F[g][q]);
      A[g] = __fadd_rn(A[g], at);
    }
  }
}

// d_er[h] += sum_{c in h, this chunk} gnum[r, c]·F[c] (+ gden[r, h]·A_h from
// the lane that holds the head's first column), one warp reduction per head
// of the column chunk at `base`.
template <typename T, int VEC, int NCH>
__device__ __forceinline__ void der_reduce(const T* __restrict__ gnum_row,
                                           const float* __restrict__ gden_row, int HD, int D,
                                           int base, const int (&c0)[NCH],
                                           const int (&head)[NCH], const float (&F)[NCH][VEC],
                                           const float (&A)[NCH], float* d_er, int lane) {
  constexpr int SPAN = 32 * VEC * NCH;
  float part[NCH];
#pragma unroll
  for (int g = 0; g < NCH; ++g) {
    part[g] = 0.f;
    if (c0[g] < HD) {
      float gn[VEC];
      Rows<T, VEC>::load(gnum_row + c0[g], gn);
#pragma unroll
      for (int q = 0; q < VEC; ++q) part[g] = fmaf(gn[q], F[g][q], part[g]);
      if (c0[g] == head[g] * D) part[g] = fmaf(gden_row[head[g]], A[g], part[g]);
    }
  }
  const int end = base + SPAN < HD ? base + SPAN : HD;
  for (int h = base / D; h <= (end - 1) / D; ++h) {
    float v = 0.f;
#pragma unroll
    for (int g = 0; g < NCH; ++g)
      if (c0[g] < HD && head[g] == h) v = __fadd_rn(v, part[g]);
    v = warp_sum(v);
    if (lane == 0) d_er[h] = __fadd_rn(d_er[h], v);
  }
}

template <typename T, int VEC, int NCH>
__device__ __forceinline__ void der_walk(const T* __restrict__ feat, int HD, int H,
                                         const DerList& dl, int n, const int (&c0)[NCH],
                                         const int (&head)[NCH], float (&F)[NCH][VEC],
                                         float (&A)[NCH]) {
  constexpr int U = DerRowsInFlight<NCH * VEC>::value;
  int j = 0;
  for (; j + U <= n; j += U) der_step<T, VEC, NCH, U>(feat, HD, H, dl, j, c0, head, F, A);
  for (; j < n; ++j) der_step<T, VEC, NCH, 1>(feat, HD, H, dl, j, c0, head, F, A);
}

template <int VEC, int NCH>
__device__ __forceinline__ void der_zero(float (&F)[NCH][VEC], float (&A)[NCH]) {
#pragma unroll
  for (int g = 0; g < NCH; ++g) {
    A[g] = 0.f;
#pragma unroll
    for (int q = 0; q < VEC; ++q) F[g][q] = 0.f;
  }
}

template <typename T, int VEC, int NCH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocks)
win_der_kernel(DenseBand b, const float* __restrict__ el, const float* __restrict__ er,
               const float* __restrict__ M, const float* __restrict__ gden,
               const T* __restrict__ feat, const T* __restrict__ gnum,
               float* __restrict__ d_er_out, int L) {
  // dynamic shared memory: the hub ids (n_hub ints), then each warp's list
  extern __shared__ float smem[];
  const int* hub_ids = stage_hub_ids(b, smem);
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + wib;
  if (row >= b.n_rows) return;  // the whole warp leaves
  constexpr int SPAN = 32 * VEC * NCH;
  const int H = b.H, D = b.D, HD = b.H * b.D;
  const DerList dl = der_list(smem + b.n_hub + wib * der_list_floats(L, H), L, H);
  const long long rh = static_cast<long long>(row) * H;
  for (int h = lane; h < H; h += 32) dl.d_er[h] = 0.f;
  const int w_lo = b.w_lo[row / kBlockRows];
  const int n_win = (b.W + kPass - 1) / kPass;
  const int n_pass = n_win + (b.n_hub + kPass - 1) / kPass;
  const float* er_row = er + rh;
  const float* m_row = M + rh;
  const float* gden_row = gden + rh;
  const T* gnum_row = gnum + static_cast<long long>(row) * HD;
  // one column chunk: F and A carried across the list chunks, one reduction
  // at the end; more: a reduction per (list chunk, column chunk)
  const bool one_chunk = HD <= SPAN;
  int c0[NCH], head[NCH];
  float F[NCH][VEC], A[NCH];
  der_zero<VEC, NCH>(F, A);
  int total = 0;
  Cursor cur{0, 0};
  bool more = true;
  for (int lo = 0; more; lo += L) {
    __syncwarp();
    const int n = fill_list<kScanBatch>(b, row, w_lo, n_win, n_pass, lane, false, L, lo, cur,
                                        hub_ids, dl.id, dl.cnt, more);
    __syncwarp();
    if (n == 0) break;  // only a row with no kept position: d_er is 0
    total += n;
    der_terms(dl, n, H, el, er_row, m_row, b.ns, lane);
    for (int base = 0; base < HD; base += SPAN) {
      der_columns<VEC, NCH>(base, HD, D, lane, c0, head);
      if (!one_chunk) der_zero<VEC, NCH>(F, A);
      der_walk<T, VEC, NCH>(feat, HD, H, dl, n, c0, head, F, A);
      if (!one_chunk)
        der_reduce<T, VEC, NCH>(gnum_row, gden_row, HD, D, base, c0, head, F, A, dl.d_er, lane);
    }
  }
  if (one_chunk && total > 0) {
    der_columns<VEC, NCH>(0, HD, D, lane, c0, head);
    der_reduce<T, VEC, NCH>(gnum_row, gden_row, HD, D, 0, c0, head, F, A, dl.d_er, lane);
  }
  __syncwarp();
  for (int h = lane; h < H; h += 32) d_er_out[rh + h] = dl.d_er[h];
}

template <typename T>
int launch_win_der(const DenseBand& b, const void* el, const void* er, const void* M,
                   const void* gden, const void* feat, const void* gnum, void* d_er, int vec,
                   int nch, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || b.H < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long smem = (b.n_hub + kWarpsPerBlock * der_list_floats(L, b.H)) * 4;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks_for_rows(b.n_rows)), block(kWarpsPerBlock * 32);
#define DGC_K8_LAUNCH(TT, V, N)                                                               \
  do {                                                                                        \
    auto kernel = win_der_kernel<TT, V, N>;                                                   \
    if (smem > 48 * 1024) {                                                                   \
      const cudaError_t e = cudaFuncSetAttribute(                                             \
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));       \
      if (e != cudaSuccess) return static_cast<int>(e);                                       \
    }                                                                                         \
    kernel<<<grid, block, static_cast<size_t>(smem), s>>>(                                    \
        b, static_cast<const float*>(el), static_cast<const float*>(er),                      \
        static_cast<const float*>(M), static_cast<const float*>(gden),                        \
        static_cast<const TT*>(feat), static_cast<const TT*>(gnum), static_cast<float*>(d_er), \
        L);                                                                                   \
  } while (0)
  // vec 4 (D and H*D multiples of 4, the row tables 16-byte aligned) with
  // nch 1, 2, 3 or 6 groups of 128 columns a lane's walk, or vec 1 with 8
  // groups of 32; wider rows walk their columns in chunks
  if (vec == 4 && nch == 1) {
    DGC_K8_LAUNCH(T, 4, 1);
  } else if (vec == 4 && nch == 2) {
    DGC_K8_LAUNCH(T, 4, 2);
  } else if (vec == 4 && nch == 3) {
    DGC_K8_LAUNCH(T, 4, 3);
  } else if (vec == 4 && nch == 6) {
    DGC_K8_LAUNCH(T, 4, 6);
  } else if (vec == 1 && nch == 8) {
    DGC_K8_LAUNCH(T, 1, 8);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DGC_K8_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes: the band as for dgc_win_fused_*; el, er, M,
// gden and d_er [n_rows, H] float32; feat and gnum [n_rows, H*D] of the entry
// point's type.  vec and nch choose the walk's form, L the entries of a
// warp's list.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a form or list the kernel does not take.
#define DGC_K8_ENTRY(NAME, TT)                                                              \
  extern "C" int NAME(const void* a, const void* w_lo, const void* a_hub, const void* hub_ids, \
                      const void* el, const void* er, const void* M, const void* gden,        \
                      const void* feat, const void* gnum, void* d_er, int n_rows, int W,      \
                      int n_hub, int H, int D, float ns, uint32_t k0, uint32_t k1, int thresh, \
                      int vec, int nch, int L, void* stream) {                                \
    const dgc::DenseBand b =                                                                  \
        dgc::make_band(a, w_lo, a_hub, hub_ids, n_rows, W, n_hub, H, D, ns, k0, k1, thresh);  \
    return dgc::launch_win_der<TT>(b, el, er, M, gden, feat, gnum, d_er, vec, nch, L,        \
                                   stream);                                                   \
  }

DGC_K8_ENTRY(dgc_win_der_f32, float)
DGC_K8_ENTRY(dgc_win_der_bf16, __nv_bfloat16)

// Shared parts of K7-K9 (win_fused.cu, win_der.cu, win_dsend.cu): the dense
// destination-score GAT over the window band and its hub columns
// (deep_gcns_torch_tpu/ops/gat_dense.py:966-1393).
//
// In K8 and K9 one warp owns one (row, head) pair of a band: a receiver row
// of the forward band (K8) or a sender row of the transpose band (K9); K7
// gives a warp a whole receiver row and all its heads (win_fused.cu).  The row's
// positions are its W window counts (int8 A[N_pad, W], row-major; node id
// w_lo[row / 128] + column) and, when the kernel takes the band's hub columns,
// its hub counts (bf16 a_hub[N_pad, H_hub]; node id hub_ids[k]).  A warp
// examines them 256 at a time, 8 per lane (one 8-byte load of int8 counts, or
// one 16-byte load of bf16 ones); a position is valid when its count is
// non-zero and the hash edge-drop keeps its edge.  On the RevGAT-5L graph
// about 1.8 % of the window positions are edges (~14 a row), so the TPU's
// dense W x 128 tile is not evaluated: valid positions are compacted into a
// per-warp list in shared memory (a popcount and a warp prefix sum, as in
// band.cu) and the list is walked with the lanes across the head's D
// columns.  Skipping a masked position is exact: it adds 0 to every sum and
// NEG to the maximum.  Scores, exp and sums are float32; each term rounds
// where the TPU kernel rounds (__f*_rn keeps the compiler from contracting
// what the plain version rounds).
#pragma once

#include "common.cuh"

namespace dgc {

constexpr float kNegScore = -1e30f;  // NEG: "no edge"
constexpr float kShiftCap = 50.f;    // CAP: exp(<= 50) is finite
constexpr int kSlots = 8;            // positions a lane examines per pass
constexpr int kPass = 32 * kSlots;   // positions a warp examines per pass
constexpr int kBlockRows = 128;      // rows per window block (BN)

struct DenseBand {
  const int8_t* a;             // [n_rows, W] window counts
  const int* w_lo;             // [n_rows / 128] window starts
  const __nv_bfloat16* a_hub;  // [n_rows, n_hub] hub counts (n_hub 0: none in the kernel)
  const int* hub_ids;          // [n_hub]
  int n_rows, W, n_hub, H, D;
  float ns;                    // leaky ReLU slope
  uint32_t k0, k1;             // drop key bits
  int thresh;                  // drop threshold; < 0: no drop
};

inline DenseBand make_band(const void* a, const void* w_lo, const void* a_hub,
                           const void* hub_ids, int n_rows, int W, int n_hub, int H, int D,
                           float ns, uint32_t k0, uint32_t k1, int thresh) {
  DenseBand b;
  b.a = static_cast<const int8_t*>(a);
  b.w_lo = static_cast<const int*>(w_lo);
  b.a_hub = static_cast<const __nv_bfloat16*>(a_hub);
  b.hub_ids = static_cast<const int*>(hub_ids);
  b.n_rows = n_rows;
  b.W = W;
  b.n_hub = a_hub == nullptr ? 0 : n_hub;
  b.H = H;
  b.D = D;
  b.ns = ns;
  b.k0 = k0;
  b.k1 = k1;
  b.thresh = thresh;
  return b;
}

__device__ __forceinline__ float lrelu(float z, float ns) {
  return z >= 0.f ? z : __fmul_rn(ns, z);
}

__device__ __forceinline__ float dlrelu(float z, float ns) { return z >= 0.f ? 1.f : ns; }

// c * exp(min(s - m, CAP)), the plain version's order of operations
__device__ __forceinline__ float edge_weight(float cnt, float s, float m) {
  return __fmul_rn(cnt, expf(fminf(__fsub_rn(s, m), kShiftCap)));
}

// Butterfly reductions: every lane ends with the same value (each step adds
// the same two operands in every lane pair, and float addition commutes).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  return v;
}

// Exclusive prefix sum of n over the warp's lanes; `total` gets the sum.
__device__ __forceinline__ int warp_prefix(int n, int lane, int& total) {
  int incl = n;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
    if (lane >= off) incl += v;
  }
  total = __shfl_sync(0xFFFFFFFFu, incl, 31);
  return incl - n;
}

// The 8 positions of one lane in one pass: counts, node ids, and bit k of
// `valid` set when position k is an edge that the drop keeps.
struct Slots {
  float cnt[kSlots];
  int id[kSlots];
  uint32_t valid;
};

// `swap`: the band is a transpose band, its rows are senders.
__device__ __forceinline__ bool kept(const DenseBand& b, int row, int id, bool swap) {
  if (b.thresh < 0) return true;
  const uint32_t r = static_cast<uint32_t>(row), s = static_cast<uint32_t>(id);
  return swap ? hash_keep(s, r, b.k0, b.k1, b.thresh) : hash_keep(r, s, b.k0, b.k1, b.thresh);
}

// Window columns col0 .. col0 + 7 of `row` (W a multiple of 8).
__device__ __forceinline__ void window_slots(const DenseBand& b, int row, int lo, int col0,
                                             bool swap, Slots& sl) {
  const uint2 w = *reinterpret_cast<const uint2*>(b.a + static_cast<long long>(row) * b.W + col0);
  sl.valid = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int c = static_cast<int8_t>(((k < 4 ? w.x : w.y) >> (8 * (k & 3))) & 0xFFu);
    sl.cnt[k] = static_cast<float>(c);
    sl.id[k] = lo + col0 + k;
    if (c > 0 && kept(b, row, sl.id[k], swap)) sl.valid |= 1u << k;
  }
}

// Hub columns col0 .. col0 + 7 of `row` (n_hub a multiple of 8); a bf16
// count widens to float32 by a shift of its bits.
__device__ __forceinline__ void hub_slots(const DenseBand& b, int row, int col0, bool swap,
                                          Slots& sl) {
  const uint4 w = *reinterpret_cast<const uint4*>(b.a_hub + static_cast<long long>(row) * b.n_hub
                                                  + col0);
  sl.valid = 0;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const uint32_t word = k < 2 ? w.x : (k < 4 ? w.y : (k < 6 ? w.z : w.w));
    sl.cnt[k] = __uint_as_float(((word >> (16 * (k & 1))) & 0xFFFFu) << 16);
    sl.id[k] = 0;
    if (sl.cnt[k] > 0.f) {
      sl.id[k] = b.hub_ids[col0 + k];
      if (kept(b, row, sl.id[k], swap)) sl.valid |= 1u << k;
    }
  }
}

// Calls visit(slots) once per pass in every lane of the warp, the window's
// passes first, then the hub columns'; lanes past the end get no valid slot.
// Every lane makes the same calls, so `visit` may use warp shuffles.
template <class Visit>
__device__ __forceinline__ void for_each_pass(const DenseBand& b, int row, int lane, bool swap,
                                              Visit&& visit) {
  const int lo = b.w_lo[row / kBlockRows];
  Slots sl;
  for (int base = 0; base < b.W; base += kPass) {
    const int col0 = base + kSlots * lane;
    sl.valid = 0;
    if (col0 < b.W) window_slots(b, row, lo, col0, swap, sl);
    visit(sl);
  }
  for (int base = 0; base < b.n_hub; base += kPass) {
    const int col0 = base + kSlots * lane;
    sl.valid = 0;
    if (col0 < b.n_hub) hub_slots(b, row, col0, swap, sl);
    visit(sl);
  }
}

// Loads the lane's columns of one head's D values of a row (zeros past D).
template <typename T, int VEC, int NCH>
__device__ __forceinline__ void load_head(const T* p, int D, int lane, float (&v)[NCH][VEC]) {
#pragma unroll
  for (int g = 0; g < NCH; ++g) {
    const int c0 = g * 32 * VEC + lane * VEC;
    if (c0 < D) {
      Rows<T, VEC>::load(p + c0, v[g]);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q) v[g][q] = 0.f;
    }
  }
}

template <int VEC, int NCH>
__device__ __forceinline__ void store_head(float* p, int D, int lane, const float (&v)[NCH][VEC]) {
#pragma unroll
  for (int g = 0; g < NCH; ++g) {
    const int c0 = g * 32 * VEC + lane * VEC;
    if (c0 < D) Rows<float, VEC>::store(p + c0, v[g]);
  }
}

// The lane's part of a per-head dot product.
template <int VEC, int NCH>
__device__ __forceinline__ float lane_dot(const float (&a)[NCH][VEC], const float (&b)[NCH][VEC]) {
  float s = 0.f;
#pragma unroll
  for (int g = 0; g < NCH; ++g)
#pragma unroll
    for (int q = 0; q < VEC; ++q) s = fmaf(a[g][q], b[g][q], s);
  return s;
}

// acc += w * v, the product rounded before the sum (as the plain version's
// products of a rounded weight and a row)
template <int VEC, int NCH>
__device__ __forceinline__ void add_scaled(float (&acc)[NCH][VEC], float w,
                                           const float (&v)[NCH][VEC]) {
#pragma unroll
  for (int g = 0; g < NCH; ++g)
#pragma unroll
    for (int q = 0; q < VEC; ++q) acc[g][q] = __fadd_rn(acc[g][q], __fmul_rn(w, v[g][q]));
}

inline dim3 dense_grid(int n_rows, int H) {
  const long long warps = static_cast<long long>(n_rows) * H;
  return dim3(static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
}

}  // namespace dgc

// The launch of one K7-K9 kernel for the (vec, nch) of the call: `vec` 4
// (D and H*D multiples of 4, the row tables 16-byte aligned) with nch 1
// (D <= 128) or 2 (D <= 256), or `vec` 1 with nch 8 (D <= 256); `nch` is the
// number of 32*vec-column groups a lane walks per head.  Three forms per type
// keep the build short.
#define DGC_DENSE_DISPATCH(LAUNCH, T, vec, nch)                                          \
  do {                                                                                   \
    if (vec == 4 && nch == 1) {                                                          \
      LAUNCH(T, 4, 1);                                                                   \
    } else if (vec == 4 && nch == 2) {                                                   \
      LAUNCH(T, 4, 2);                                                                   \
    } else if (vec == 1 && nch == 8) {                                                   \
      LAUNCH(T, 1, 8);                                                                   \
    } else {                                                                             \
      return static_cast<int>(cudaErrorInvalidValue);                                    \
    }                                                                                    \
  } while (0)

// Shared parts of K7-K9 (win_fused.cu, win_der.cu, win_dsend.cu): the dense
// destination-score GAT over the window band and its hub columns
// (deep_gcns_torch_tpu/ops/gat_dense.py:966-1393).
//
// Each kernel gives a warp one row of a band and all its heads: K7 and K8 a
// receiver row of the forward band (win_fused.cu, win_der.cu), K9 a sender
// row of the transpose band (win_dsend.cu).  The row's positions are its W
// window counts (int8 A[N_pad, W], row-major; node id w_lo[row / 128] +
// column) and, when the kernel takes the band's hub columns, its hub counts
// (bf16 a_hub[N_pad, H_hub]; node id hub_ids[k]).  A warp examines them 256
// at a time, 8 per lane (one 8-byte load of int8 counts, or one 16-byte load
// of bf16 ones); a position is valid when its count is non-zero and the hash
// edge-drop keeps its edge.  On the RevGAT-5L graph about 1.8 % of the
// window positions are edges (~14 a row), so the TPU's dense W x 128 tile is
// not evaluated: the warp scans the whole row once and compacts its valid
// positions into a list in shared memory (`fill_list`: a popcount and a warp
// prefix sum, as in band.cu; a row longer than the list is done in
// list-sized chunks), then walks the list with the lanes across the row's
// H·D columns.  Skipping a masked position is exact: it adds 0 to every sum
// and NEG to the maximum.  Scores, exp and sums are float32; each term
// rounds where the TPU kernel rounds (__f*_rn keeps the compiler from
// contracting what the plain version rounds).
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

// ---- the one-scan list ----

// Where a scan resumes: a pass (the window's passes, then the hub columns')
// and the list index of the first kept position in it.
struct Cursor {
  int pass, first;
};

// The lane's 8 raw counts of pass p: int8 window counts in .x and .y, or
// bf16 hub counts in .x to .w; zeros past the row's end.
__device__ __forceinline__ uint4 load_pass(const DenseBand& b, int row, int n_win, int p,
                                           int lane) {
  uint4 w = make_uint4(0u, 0u, 0u, 0u);
  if (p < n_win) {
    const int col0 = p * kPass + kSlots * lane;
    if (col0 < b.W) {
      const uint2 v =
          *reinterpret_cast<const uint2*>(b.a + static_cast<long long>(row) * b.W + col0);
      w.x = v.x;
      w.y = v.y;
    }
  } else {
    const int col0 = (p - n_win) * kPass + kSlots * lane;
    if (col0 < b.n_hub)
      w = *reinterpret_cast<const uint4*>(b.a_hub + static_cast<long long>(row) * b.n_hub +
                                          col0);
  }
  return w;
}

// The valid positions of the counts of pass p already loaded (window: count
// > 0 and kept; hub columns: the same, with the hub ids from the block's copy
// in shared memory)
__device__ __forceinline__ void decode_pass(const DenseBand& b, int row, int w_lo, int n_win,
                                            int p, int lane, bool swap, const uint4& w,
                                            const int* hub_ids, Slots& sl) {
  sl.valid = 0;
  if (p < n_win) {
    const int col0 = p * kPass + kSlots * lane;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int c = static_cast<int8_t>(((k < 4 ? w.x : w.y) >> (8 * (k & 3))) & 0xFFu);
      sl.cnt[k] = static_cast<float>(c);
      sl.id[k] = w_lo + col0 + k;
      if (c > 0 && kept(b, row, sl.id[k], swap)) sl.valid |= 1u << k;
    }
  } else {
    const int col0 = (p - n_win) * kPass + kSlots * lane;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const uint32_t word = k < 2 ? w.x : (k < 4 ? w.y : (k < 6 ? w.z : w.w));
      sl.cnt[k] = __uint_as_float(((word >> (16 * (k & 1))) & 0xFFFFu) << 16);
      sl.id[k] = 0;
      if (sl.cnt[k] > 0.f) {
        sl.id[k] = hub_ids[col0 + k];
        if (kept(b, row, sl.id[k], swap)) sl.valid |= 1u << k;
      }
    }
  }
}

// Compacts the kept positions of list index [lo, lo + L) into the list
// (node ids `id`, counts `cnt`), scanning from `cur`; returns how many it
// wrote.  `more` is set when kept positions remain past lo + L, and `cur`
// then stays at the pass that holds index lo + L, where the next chunk
// starts.  A lane loads the counts of BATCH passes before it decodes any, so
// that a row's count loads overlap.  The list order is the window's passes,
// then the hub columns', each pass in lane order.
// Uniform across the warp.
template <int BATCH>
__device__ __forceinline__ int fill_list(const DenseBand& b, int row, int w_lo, int n_win,
                                         int n_pass, int lane, bool swap, int L, int lo,
                                         Cursor& cur, const int* hub_ids, int* id, float* cnt,
                                         bool& more) {
  more = false;
  for (int p0 = cur.pass; p0 < n_pass; p0 += BATCH) {
    uint4 raw[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH; ++q)
      raw[q] = p0 + q < n_pass ? load_pass(b, row, n_win, p0 + q, lane)
                               : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      const int p = p0 + q;
      if (p >= n_pass) break;
      Slots sl;
      decode_pass(b, row, w_lo, n_win, p, lane, swap, raw[q], hub_ids, sl);
      int total;
      int pos = cur.first + warp_prefix(__popc(sl.valid), lane, total);
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if ((sl.valid >> k) & 1u) {
          if (pos >= lo && pos < lo + L) {
            id[pos - lo] = sl.id[k];
            cnt[pos - lo] = sl.cnt[k];
          }
          ++pos;
        }
      }
      if (cur.first + total > lo + L) {
        more = true;
        return L;
      }
      cur.first += total;
      cur.pass = p + 1;
    }
  }
  return cur.first - lo;
}

// The block's copy of the hub ids, at the start of its dynamic shared memory.
__device__ __forceinline__ int* stage_hub_ids(const DenseBand& b, float* smem) {
  int* hub_ids = reinterpret_cast<int*>(smem);
  for (int i = threadIdx.x; i < b.n_hub; i += blockDim.x) hub_ids[i] = b.hub_ids[i];
  __syncthreads();
  return hub_ids;
}

}  // namespace dgc

// K2: fused gather + GENConv message + softmax aggregation, with or without
// edge embeddings.  For each receiver row n and channel c:
//
//   m_e   = relu(x[senders[e], c] [+ ee[e, c]]) + eps              (float32)
//   M     = max_e round(t * m_e)                       (the row's own shift)
//   w_e   = exp(t * m_e - M)                                    (<= 1, one is 1)
//   num   = sum_e round_T(w_e * m_e),  den = sum_e round_T(w_e)  (float32)
//   out[n, c] = den > 0 ? num / den : 0
//   lse[n, c] = den > 0 ? M + log(den) : 0                       (float32)
//
// over e in [row_ptr[n], row_ptr[n+1]).  round_T is the rounding to the
// compute type that the TPU kernel applies before its float32 accumulation
// (spmm_pallas.py:348-349), so kernel and plain version differ only in the
// order of the sums.  The shift M is the receiver's own maximum score in
// each channel, as the reference's scatter_softmax takes it, so the largest
// weight of every row is 1 and den >= 1: no row's weights underflow however
// far its scores lie below another row's.  (The TPU kernel shifts by one
// global bound a channel, `_fused_cmax`, spmm_pallas.py:649-662: once a
// channel's scores spread past ~87, every weight of the rows far below the
// top underflows and their aggregation returns 0.)  lse, the row's
// log-normaliser, is what the backward needs: the normalised weight of an
// edge is exp(t * m_e - lse[r]), read per edge (K4).  t arrives as a device
// pointer so that the host never waits.
//
// The shift is taken in a first walk over the row's edges (the same loads
// as the second, which finds them in L1 or L2; one multiply and one max a
// value), not by an online softmax that rescales num and den whenever the
// running maximum grows: an online shift changes each term's value, and
// with it the rounding of the terms and of their sums, so no plain version
// could give them bit for bit.  (A float32 form with a lazy online shift, M
// moving only past M + 8, moved a 5,000-edge hub row's sequential float32
// sums off the plain version's by more than their 1e-5 agreement on the
// H100.)
//
// Replaces the TPU kernel `_softmax_agg_kernel` (spmm_pallas.py:322, called
// at :372), which streamed pre-gathered x[senders] tiles (an XLA gather at
// :699) through a one-hot MXU matmul.  Here the gather is fused: a warp owns
// one receiver row and every edge's sender row is read straight from x.
// With edge embeddings (the `has_ee` branch, spmm_pallas.py:323-344) `ee` is
// in receiver (CSR) order, so a row's embeddings are one contiguous stretch
// of [row_ptr[n], row_ptr[n+1]) rows, read beside the gathered sender rows.
//
// What bounds it on the H100 (SXM, 700 W): the bytes are one gathered row
// per edge plus the node tables (plus one streamed ee row per edge with
// embeddings); the operations are ~10 float32 operations and one accurate
// expf, which takes the special-function units, per (edge, channel).  The
// latter bounds C=128 (chip_smoke.py prints the bound).  In bf16 x (43 MB at
// ResGEN-28's shape, 2 MB at a RevGCN group's) fits the 50 MB L2, so most
// gathered rows come from L2; in float32 ResGEN-28's x is 86.7 MB, so the
// first walk streams most of its rows from HBM and the second finds some of
// them in L2.  Either way what sets the time is how many rows a warp keeps
// in flight: each edge is a dependent senders[e] -> x[s] chain.
// Lanes laid across the channels alone, 4 to a lane, leave 22 of 32 lanes
// idle at C=40 and walk a ~60-edge row in 15 dependent steps.
//
// The design: lane groups over edges.  The warp's lanes split into G groups
// of w = ceil(C / VEC) lanes, G = 32 / w, with VEC = 4 (16-byte float32 or
// 8-byte bf16 loads) where the rows allow them, else VEC = 1 (a scalar
// form).  Group g walks the edges e = start + g, g + G, ... with four edges
// in flight a lane; the groups' maxima are merged by shuffles before the
// second walk, and the G partial (num, den) pairs of each channel are
// added at the end in the fixed order g = 0 .. G-1 through warp shuffles, so
// the result is deterministic.  In bf16 C=40 gives w=10, G=3 (30 lanes busy,
// 12 edges in flight a warp, against 10 lanes and 4 edges with one group),
// C=64 w=16, G=2; C=128 and wider keep one group (w=32, G=1) and walk the
// channels in chunks of 32·VEC.  float32 always takes one group, whose walk
// adds each channel's terms in edge order: the plain version's sequential
// sums.  A float32 sum over a long row of near-equal terms (a hub whose
// messages sit at relu's floor) carries an order-dependent bias well above
// 1e-5 relative, so the groups' interleaved order would move the float32
// result off the plain version's by more than their agreement allows; in
// bf16 the sums round to 8 bits at the end and the order does not show.  A
// grouped float32 form that added every term in edge order through
// shuffles measured 1.15x (C=40) and 1.39x (C=64) slower on the H100 than
// this one group.  Eight bf16 values a lane (16-byte loads,
// G=6 at C=40, G=2 at C=128) measured slower on the H100 at all three
// widths: twice the registers a lane cost more occupancy than the wider
// loads saved.  At C=128 the kernel is bound by instruction throughput
// (~25 per (edge, channel), most of them the accurate expf and the two
// roundings the contract fixes), so groups cannot help there.  Consecutive
// edges' ee rows are contiguous, so the groups read one coalesced stretch a
// step.  The wrapper (ops/spmm_cuda.py::k2_lane_groups) chooses w and G.
//
// The gather forms hand rows to warps longest first (`order`, the graph's
// `row_order`, built once with the graph by graph.py::build_graph): a row's
// walk is one warp's, with four edges in flight a lane, so a hub of ~1,200
// edges takes a warp far longer than the rest of its wave; in index order a
// hub late in the grid ran alone after the others, and the kernel's time
// followed the graph's largest rows.  Each row's arithmetic, and so its
// result, is the same in either order.
//
// The long-row split.  Longest first cured a hub's late start, not its
// serial walk: one warp a row, four edges in flight a lane, takes a
// 1,105-edge row through ~277 dependent steps a walk.  On ResGEN-28's
// float32 graph (C=128, 2.78 M edges) the kernel took 0.80 ms, the same
// graph with every row cut to 128 edges 0.52, and its 8 longest rows alone
// 0.47 (H100, chip_smoke.py --kernel-times).  So in the one-group layout (MULTI
// false: float32, and bf16 rows of 32 vector slots or more) the gather forms
// give each of the first n_split rows of `order` (those of more than
// K2_SPLIT_EDGES edges, counted by spmm_cuda.py::k2_split_rows, longest first)
// S = ceil(C / 32) warps, one 32-channel slice each, one channel a lane (one
// 128-byte line an edge in float32), with kSplitU = 16 edges in flight a
// lane: registers allow four times the one-group form's, as a lane holds
// one channel and not four.  Each warp walks every edge of its row in edge
// order, both walks, so each channel's shift, terms and sums are the
// one-group walk's in the same order, and out and lse are the unsplit
// launch's bit for bit; the slices share nothing, so nothing is merged.  One
// launch: the grid's first n_split * S warps take the split rows, and each
// later warp one of the remaining rows.  Measured on the H100 (700 W) at
// that shape: 0.836 -> 0.543 ms with D = 128 (D = 64 0.558, 256 0.547; 8
// edges in flight, or two channels a lane, within 1-3 % at their best D);
// bf16 C=128 0.652 -> 0.472, float32 C=64 0.563 -> 0.384.  split_slice is a function of
// its own: inlined, it left the kernel's own walk (the unsplit rows) 7-9 %
// slower, though that walk's loops compiled to the same instructions.
//
// The message form (SRC == kMsgs, `dgc_softmax_agg_msgs_*`) is the TPU
// kernel's `relu_eps=None` path (spmm_pallas.py:345-346, launched by
// `gen_softmax_aggregate_csr` at :416-459): the messages m [E_pad, C] are
// materialised by the caller in receiver (CSR) order and used as they are,
// with no sender gather, no relu and no eps; its shift is the row's maximum
// of t*m as well (the TPU kernel's is the exact global maximum, :402-409).
// A row's messages are one contiguous stretch, so the lane groups read
// consecutive rows: every load is coalesced and nothing is a dependent
// chain.  The walks, the roundings and the order of the sums are the gather
// forms'.  Its rows go to warps in index order: its CSR ranges come from
// whatever the caller materialised (a shard's local or halo edges), which
// carry no order of their own.
#include "common.cuh"

namespace dgc {

// where an edge's message comes from: x[senders[e]], x[senders[e]] + ee[e],
// or the materialised row msgs[e] (passed as x)
enum Src { kGather = 0, kGatherEE = 1, kMsgs = 2 };

// one edge's message m = relu(v) + eps (RELU_EPS, the gather forms) or
// m = v (the message form)
template <bool RELU_EPS>
__device__ __forceinline__ float message(float v, float eps) {
  return RELU_EPS ? fmaxf(v, 0.f) + eps : v;
}

// one edge's terms round_T(w * m) and round_T(w), per channel.  PAIRED
// rounds bf16 two values at a time (one packing conversion a pair, the same
// round-to-nearest-even as one at a time): fewer instructions, which the
// one-group form (C=128, bound by instruction throughput) gains from and the
// grouped forms measured slower with
template <typename T, int VEC, bool PAIRED, bool RELU_EPS>
__device__ __forceinline__ void edge_terms(const float* xv, const float* cm, float t, float eps,
                                           float* tn, float* td) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float m = message<RELU_EPS>(xv[k], eps);
    // explicit roundings keep nvcc from contracting t*m - M into one fma,
    // so each term is bit for bit the plain version's and only the order of
    // the sums differs
    const float w = expf(__fsub_rn(__fmul_rn(m, t), cm[k]));
    tn[k] = __fmul_rn(w, m);  // rounded as the plain version rounds it: no fma into the sum
    td[k] = w;
  }
  if constexpr (PAIRED && sizeof(T) == 2 && VEC % 2 == 0) {
#pragma unroll
    for (int k = 0; k < VEC; k += 2) {
      const float2 a = __bfloat1622float2(__floats2bfloat162_rn(tn[k], tn[k + 1]));
      const float2 b = __bfloat1622float2(__floats2bfloat162_rn(td[k], td[k + 1]));
      tn[k] = a.x;
      tn[k + 1] = a.y;
      td[k] = b.x;
      td[k + 1] = b.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      tn[k] = round_to<T>(tn[k]);
      td[k] = round_to<T>(td[k]);
    }
  }
}

template <typename T, int VEC, bool PAIRED, bool RELU_EPS>
__device__ __forceinline__ void accumulate(const float* xv, const float* cm, float t,
                                           float eps, float* num, float* den) {
  float tn[VEC], td[VEC];
  edge_terms<T, VEC, PAIRED, RELU_EPS>(xv, cm, t, eps, tn, td);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    num[k] += tn[k];
    den[k] += td[k];
  }
}

// the first walk's step: the running maximum of the scores round(t * m)
template <int VEC, bool RELU_EPS>
__device__ __forceinline__ void track_max(const float* xv, float t, float eps, float* mx) {
#pragma unroll
  for (int k = 0; k < VEC; ++k)
    mx[k] = fmaxf(mx[k], __fmul_rn(message<RELU_EPS>(xv[k], eps), t));
}

// x[sender] (+ ee[e]), or msgs[e] (x holds the messages), for one edge,
// widened to float32
template <typename T, int VEC, int SRC>
__device__ __forceinline__ void load_message(const T* __restrict__ x, const T* __restrict__ ee,
                                             int sender, int e, int C, int c0, float* v) {
  if constexpr (SRC == kMsgs) {
    Rows<T, VEC>::load(x + (long long)e * C + c0, v);
    return;
  }
  Rows<T, VEC>::load(x + (long long)sender * C + c0, v);
  if constexpr (SRC == kGatherEE) {
    float ev[VEC];
    Rows<T, VEC>::load(ee + (long long)e * C + c0, ev);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] += ev[k];
  }
}

// The long-row split: the edges in flight a lane
constexpr int kSplitU = 16;

// The warps that split one row: one 32-channel slice each
__host__ __device__ __forceinline__ int split_warps(int C) { return (C + 31) / 32; }

// One warp's slice of a long row (a gather form): each lane holds one channel c
// and walks every edge of [start, end) in edge order, the max walk and then
// the sum walk, with kSplitU edges in flight.  Each channel's shift, terms
// and sums are the one-group walk's, in the same order, so out and lse are
// that walk's bit for bit.  No shuffles: the lanes past C return at once.
// Not inlined (see the head of this file).
template <typename T, int SRC>
__device__ __noinline__ void split_slice(const T* __restrict__ x, const T* __restrict__ ee,
                                         const int* __restrict__ senders, int row, int start,
                                         int end, int C, int c, float t, float eps,
                                         T* __restrict__ out, float* __restrict__ lse) {
  constexpr int U = kSplitU;
  if (c >= C) return;
  float cm = __int_as_float(0xff800000);  // -inf
  int e = start;
  for (; e + U <= end; e += U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      load_message<T, 1, SRC>(x, ee, senders[e + u], e + u, C, c, &v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) track_max<1, true>(&v[u], t, eps, &cm);
  }
  for (; e < end; ++e) {
    float v;
    load_message<T, 1, SRC>(x, ee, senders[e], e, C, c, &v);
    track_max<1, true>(&v, t, eps, &cm);
  }
  float num = 0.f, den = 0.f;
  for (e = start; e + U <= end; e += U) {
    float v[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      load_message<T, 1, SRC>(x, ee, senders[e + u], e + u, C, c, &v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) accumulate<T, 1, true, true>(&v[u], &cm, t, eps, &num, &den);
  }
  for (; e < end; ++e) {
    float v;
    load_message<T, 1, SRC>(x, ee, senders[e], e, C, c, &v);
    accumulate<T, 1, true, true>(&v, &cm, t, eps, &num, &den);
  }
  const long long i = (long long)row * C + c;
  out[i] = from_f32<T>(den > 0.f ? num / den : 0.f);
  lse[i] = den > 0.f ? __fadd_rn(cm, logf(den)) : 0.f;
}

// MULTI is false when the row takes one group (w = 32, G = 1): the layout is
// then known at compile time and the kernel is the plain lanes-over-channels
// walk, whose edge order is the sequential one.  In that layout the gather
// forms split the first n_split rows of `order` (its longest): the grid's
// first n_split * split_warps(C) warps walk their slices (split_slice), and
// each later warp takes one of the remaining rows.
template <typename T, int VEC, int SRC, bool MULTI>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
softmax_agg_kernel(const T* __restrict__ x, const T* __restrict__ ee,
                   const int* __restrict__ senders, const int* __restrict__ row_ptr,
                   const int* __restrict__ order, const float* __restrict__ t_ptr,
                   T* __restrict__ out, float* __restrict__ lse, int n_rows, int n_split,
                   int C, int w_arg, int G_arg, float eps) {
  constexpr int U = 4;  // edges in flight a lane
  constexpr bool RELU_EPS = SRC != kMsgs;
  const int w = MULTI ? w_arg : 32;
  const int G = MULTI ? G_arg : 1;
  const int warp = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  int slot = warp;
  if constexpr (RELU_EPS && !MULTI) {
    const int S = split_warps(C);
    if (warp < n_split * S) {
      const int row = order[warp / S];
      split_slice<T, SRC>(x, ee, senders, row, row_ptr[row], row_ptr[row + 1], C,
                          (warp % S) * 32 + lane, *t_ptr, eps, out, lse);
      return;
    }
    slot = warp - n_split * S + n_split;
  }
  if (slot >= n_rows) return;  // the whole warp: the shuffles below see 32 lanes
  const int row = SRC == kMsgs ? slot : order[slot];
  const int g = lane / w;
  const int j = lane - g * w;
  const int start = row_ptr[row];
  const int end = row_ptr[row + 1];
  const float t = *t_ptr;
  for (int base = 0; base < C; base += w * VEC) {
    const int c0 = base + j * VEC;
    const bool on = g < G && c0 < C;
    // first walk: the row's maximum score in each channel (-inf without edges)
    float cm[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) cm[k] = __int_as_float(0xff800000);  // -inf
    if (on) {
      int e = start + g;
      for (; e + (U - 1) * G < end; e += U * G) {
        float v[U][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u)
          load_message<T, VEC, SRC>(x, ee, SRC == kMsgs ? 0 : senders[e + u * G], e + u * G, C,
                                    c0, v[u]);
#pragma unroll
        for (int u = 0; u < U; ++u) track_max<VEC, RELU_EPS>(v[u], t, eps, cm);
      }
      for (; e < end; e += G) {
        float v[VEC];
        load_message<T, VEC, SRC>(x, ee, SRC == kMsgs ? 0 : senders[e], e, C, c0, v);
        track_max<VEC, RELU_EPS>(v, t, eps, cm);
      }
    }
    // every group takes the maximum over all groups (the idle lanes hold -inf);
    // one group has it already, and its warp needs no shuffle
    if constexpr (MULTI) {
      float pm[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) pm[k] = cm[k];
      for (int h = 0; h < G; ++h) {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          cm[k] = fmaxf(cm[k], __shfl_sync(0xffffffffu, pm[k], h * w + j));
      }
    }
    // second walk: the terms against that shift
    float num[VEC], den[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      num[k] = 0.f;
      den[k] = 0.f;
    }
    if (on) {
      int e = start + g;
      for (; e + (U - 1) * G < end; e += U * G) {
        float v[U][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u)
          load_message<T, VEC, SRC>(x, ee, SRC == kMsgs ? 0 : senders[e + u * G], e + u * G, C,
                                    c0, v[u]);
#pragma unroll
        for (int u = 0; u < U; ++u)
          accumulate<T, VEC, !MULTI, RELU_EPS>(v[u], cm, t, eps, num, den);
      }
      for (; e < end; e += G) {
        float v[VEC];
        load_message<T, VEC, SRC>(x, ee, SRC == kMsgs ? 0 : senders[e], e, C, c0, v);
        accumulate<T, VEC, !MULTI, RELU_EPS>(v, cm, t, eps, num, den);
      }
    }
    // the groups' partial sums, added in the order g = 0, 1, ..., G-1
    if constexpr (MULTI) {
      float pn[VEC], pd[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        pn[k] = num[k];
        pd[k] = den[k];
      }
      for (int h = 1; h < G; ++h) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          num[k] += __shfl_sync(0xffffffffu, pn[k], h * w + j);
          den[k] += __shfl_sync(0xffffffffu, pd[k], h * w + j);
        }
      }
    }
    if (on && g == 0) {
      float o[VEC], l[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        o[k] = den[k] > 0.f ? num[k] / den[k] : 0.f;
        l[k] = den[k] > 0.f ? __fadd_rn(cm[k], logf(den[k])) : 0.f;
      }
      Rows<T, VEC>::store(out + (long long)row * C + c0, o);
      Rows<float, VEC>::store(lse + (long long)row * C + c0, l);
    }
  }
}

template <typename T, int VEC, int SRC>
void launch_one(const void* x, const void* ee, const void* senders, const void* row_ptr,
                const void* order, const void* t, void* out, void* lse, int n_rows,
                int n_split, int C, int w, int G, float eps, cudaStream_t s) {
  const int warps = n_rows - n_split + n_split * split_warps(C);
  const dim3 grid(blocks_for_rows(warps)), block(kWarpsPerBlock * 32);
  auto kernel = softmax_agg_kernel<T, VEC, SRC, false>;
  if constexpr (sizeof(T) == 2) {  // lane groups: bf16 only (see the head of this file)
    if (G > 1) kernel = softmax_agg_kernel<T, VEC, SRC, true>;
  }
  kernel<<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(ee), static_cast<const int*>(senders),
      static_cast<const int*>(row_ptr), static_cast<const int*>(order),
      static_cast<const float*>(t), static_cast<T*>(out), static_cast<float*>(lse), n_rows,
      n_split, C, w, G, eps);
}

template <typename T, int VEC>
void launch_vec(const void* x, const void* ee, const void* senders, const void* row_ptr,
                const void* order, const void* t, void* out, void* lse, int n_rows,
                int n_split, int C, int w, int G, float eps, bool msgs, cudaStream_t s) {
#define DGC_K2_ARGS x, ee, senders, row_ptr, order, t, out, lse, n_rows, n_split, C, w, G, eps, s
  if (msgs)
    launch_one<T, VEC, kMsgs>(DGC_K2_ARGS);
  else if (ee)
    launch_one<T, VEC, kGatherEE>(DGC_K2_ARGS);
  else
    launch_one<T, VEC, kGather>(DGC_K2_ARGS);
#undef DGC_K2_ARGS
}

// vec: 4 or 1, as the wrapper found the rows aligned; w and G: the lane
// groups (w * G <= 32, w * VEC >= C unless w == 32; float32 takes G = 1);
// order: the rows in the order the warps take them; n_split: how many of
// order's first rows are split over warps (the gather forms at G = 1 only;
// 0 otherwise); msgs: x holds one materialised message row per edge
// (senders, ee, order and eps are not read)
template <typename T>
int launch_softmax_agg(const void* x, const void* ee, const void* senders, const void* row_ptr,
                       const void* order, const void* t, void* out, void* lse, int n_rows,
                       int n_split, int C, int w, int G, float eps, int vec, bool msgs,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w < 1 || w > 32 || G < 1 || w * G > 32 || (sizeof(T) == 4 && G != 1) || n_split < 0 ||
      n_split > n_rows || (n_split > 0 && (G != 1 || msgs)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4)
    launch_vec<T, 4>(x, ee, senders, row_ptr, order, t, out, lse, n_rows, n_split, C, w, G,
                     eps, msgs, s);
  else if (vec == 1)
    launch_vec<T, 1>(x, ee, senders, row_ptr, order, t, out, lse, n_rows, n_split, C, w, G,
                     eps, msgs, s);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes.  `ee` may be null (no edge embeddings); it
// has x's type and [E_pad, C] rows in receiver order.  `order` is a
// permutation of [0, n_rows), longest rows first; its first n_split rows are
// split over warps (0 <= n_split <= n_rows, and 0 unless G == 1).  out has
// x's type, lse is float32 [n_rows, C].  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a lane layout, vec or n_split the
// kernel does not take.
extern "C" int dgc_softmax_agg_f32(const void* x, const void* ee, const void* senders,
                                   const void* row_ptr, const void* order, const void* t,
                                   void* out, void* lse, int n_rows, int n_split, int C, int w,
                                   int G, float eps, int vec, void* stream) {
  return dgc::launch_softmax_agg<float>(x, ee, senders, row_ptr, order, t, out, lse, n_rows,
                                        n_split, C, w, G, eps, vec, false, stream);
}

extern "C" int dgc_softmax_agg_bf16(const void* x, const void* ee, const void* senders,
                                    const void* row_ptr, const void* order, const void* t,
                                    void* out, void* lse, int n_rows, int n_split, int C,
                                    int w, int G, float eps, int vec, void* stream) {
  return dgc::launch_softmax_agg<__nv_bfloat16>(x, ee, senders, row_ptr, order, t, out, lse,
                                                n_rows, n_split, C, w, G, eps, vec, false,
                                                stream);
}

// The message form: msgs [E_pad, C] of the output's type in receiver order,
// the CSR row_ptr and t (a device float); the rows go in index order.
extern "C" int dgc_softmax_agg_msgs_f32(const void* msgs, const void* row_ptr, const void* t,
                                        void* out, void* lse, int n_rows, int C, int w, int G,
                                        int vec, void* stream) {
  return dgc::launch_softmax_agg<float>(msgs, nullptr, nullptr, row_ptr, nullptr, t, out, lse,
                                        n_rows, 0, C, w, G, 0.f, vec, true, stream);
}

extern "C" int dgc_softmax_agg_msgs_bf16(const void* msgs, const void* row_ptr, const void* t,
                                         void* out, void* lse, int n_rows, int C, int w, int G,
                                         int vec, void* stream) {
  return dgc::launch_softmax_agg<__nv_bfloat16>(msgs, nullptr, nullptr, row_ptr, nullptr, t,
                                                out, lse, n_rows, 0, C, w, G, 0.f, vec, true,
                                                stream);
}

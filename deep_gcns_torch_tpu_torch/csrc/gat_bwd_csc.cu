// K6: the backward of K5 in sender (CSC) order.  For each sender row s and
// head h, with el = T[s, H*D + h], msg = T[s, h*D : (h+1)*D],
// w = exp(leaky_relu(el) - cmax[h]) and lr' = (el >= 0 ? 1 : neg_slope),
// over the edges e in [col_ptr[s], col_ptr[s+1]) with receiver
// r = csc_receivers[e] that are kept (keep[e] != 0, or every edge without
// `keep`):
//
//   gnum = g[r, h*D : (h+1)*D],  gden = g[r, H*D + h]     (g in T's type)
//   dT[s, h*D + d] = sum_e round_T(w * gnum[d])
//   dT[s, H*D + h] = sum_e round_T((<msg, gnum> + gden) * w * lr')
//
// in float32, written in T's type, with zeros in the columns past H*D + H.
// A dropped edge's cotangent is zero in the TPU kernel (its gathered rows are
// zeroed by `keep_csc`, spmm_pallas.py:963-966), so skipping it is exact.
// Each edge term is rounded to T where the TPU kernel rounds it
// (spmm_pallas.py:881-883); the per-head dot <msg, gnum> is a float32 warp
// reduction, so it is summed in another order than the plain version's.
//
// Replaces the TPU kernel `_gat_bwd_kernel` (spmm_pallas.py:862, called at
// :969).  That kernel rebuilds each edge's T row with a transposed one-hot
// MXU product of a 128-sender block and streams g[csc_receivers], gathered by
// XLA into an [E, P] array beforehand (:963-966).  Here each edge's receiver
// row of g is gathered inside the kernel, so the [E, P] array is never
// written.  No atomics: each warp writes its own row.
//
// What bounds it on the H100: bytes.  T and g read once and dT written once
// are 3 x 133 MB at P=392 bf16, while the gathered rows of g total (kept
// edges) x P values, which the cluster order of the graph keeps mostly in
// the 50 MB L2; chip_smoke.py prints the bound and the time if every gather
// came from HBM.
//
// The first form of this kernel gave a warp to each (sender row, head), the
// lanes across the head's D columns.  For each edge every lane loaded
// csc_receivers[e] and keep[e] (one address in all 32 lanes), then the
// receiver's slice of g and gden: up to 4 edges in flight, each a chain of
// dependent loads, and the row's edge indices, keep bytes and gden fetched H
// times, once per head's warp.  1.115 ms at P=392 bf16 on the H100 (80GB
// HBM3, 700 W), 9.0x the byte bound.
//
// The design: one warp per sender row, all heads, the edge indices loaded 32
// at a time (K5's, on the CSC side).
//   1. Prologue: lanes h < H form w_h and lr'_h from el; each lane keeps the
//      row's msg at its columns in its own slots of shared memory.
//   2. Edge table: the lanes load 32 consecutive CSC slots' receivers and
//      keep bytes at once (coalesced); the kept slots are compacted, in edge
//      order, by a ballot and a popcount into a table of receiver ids in
//      shared memory.  The weights depend on the sender alone, so the table
//      holds ids only.
//   3. Walk: the lanes run across the H·D columns, receiver rows of g in
//      flight, none of their loads waiting on an index load.  For each edge
//      each column adds round_T(w_{h(c)}·gnum[r, c]) in edge order (the
//      first form's product and order, so dmsg is its bit for bit).  A lane
//      covers the same columns of a head as the first form did (D = 128 or
//      256 at 4-wide loads), and its part of each head's dot <msg_h, gnum_h>
//      runs through them in the same order; the parts of the step's (row,
//      head) dots are finished by a reduce-scatter over the lanes (pairs
//      at xor 16, 8, ... as the butterfly adds them, so the dot, and d_el,
//      are the first form's bit for bit, in about U·H shuffles where the
//      butterflies took 5·U·H).  d_el_h adds round_T((dot + gden)·w·lr') in
//      edge order, one lane a head.
//   The dot needs a whole head within one walk: a row wider than one walk
//   (32·VEC·NCH columns) walks the edge table once per group of whole heads;
//   P=776 (3 x 256) takes one walk of 6 column groups.  Narrow rows (P=48,
//   H·D = 40) take two lane groups of 16 in bf16 (`k6_layout` in
//   ops/spmm_cuda.py), each every other kept edge of the table, whose
//   butterflies stay inside the group; the groups' partials add in the
//   fixed order g = 0, 1 (their bf16-rounded terms sum exactly in float32
//   here, so dmsg and d_el came out the first form's bit for bit too).
//   float32 keeps one group and edge order.
//
// What was hard: the head slot of a column group must be a compile-time
// index.  The first build chose the slot at run time (`if (slot[c] == s)`),
// which the compiler folded into an indexed array in local memory, a load
// and a store around every multiply-add: 2.35 ms at P=392.  A head of whole
// groups (GPH = D / 128 at 4-wide loads: 1 or 2) now takes static slots; any
// other width adds each group's part into every slot through a select.
// Shuffles under a run-time condition (reducing only the walk's heads) put
// 66 WARPSYNCs into the kernel's SASS; with every slot reduced the form
// went from 2.12 to 1.38 ms, and with the static slots to 0.85.  And more
// rows in flight cost more than they gave once the walk's registers reach
// 64: one row at 3 x 128 (0.69 against 0.85 for two), where K5 keeps eight.
//
// Forms measured on the H100 (80GB HBM3, 700 W) on the RevGAT-5L graph with
// the step's hash keep (N=169,472, 1,949,008 kept edges, in- and out-degree
// up to 1,166), ms at P=392 / 776 / 48 bf16 and P=392 float32, by
// `chip_smoke.py --kernel-forms=K6` (each a copy of this source with
// constants changed, or the wrapper's walk form or lane groups): kept
// (reduce-scatter dots, rows in flight the fewer of 24 values and 3 dots a
// lane: 1 / 1 / 3 / 1, 4 blocks an SM, one walk at P=776) 0.617-0.619 /
// 1.067-1.070 / 0.209-0.210 / 0.627-0.629; butterfly dots 0.680 / 1.366-
// 1.369 / 0.209 / 0.682-0.683; 2 rows in flight 0.638-0.640 / 2.665-2.670 /
// 0.220 / 1.003-1.005; 3 blocks 0.689-0.690 / 1.121-1.122 / 0.209-0.210 /
// 0.634-0.635; 6 blocks 0.857-0.864 / 2.192-2.193 / 0.200-0.201 / 1.049-
// 1.051; three walks of one head at P=776 1.252-1.254 there; no lane
// groups 0.306 at P=48.  The first form read 1.110-1.116 / 1.731-1.740 /
// 0.415-0.417 / 0.841-0.845 by `chip_smoke.py --kernel-times`.
#include "common.cuh"

namespace dgc {

// Rows of g a lane keeps in flight in the walk: kFlightValues / (values a
// lane holds of one row), and at most kFlightDots / (head slots a walk
// reduces), between 1 and 8.
constexpr int kFlightValues = 24;
constexpr int kFlightDots = 3;
// Blocks an SM keeps resident: 64 registers a thread.
constexpr int kMinBlocks = 4;
// 1: finish the (row, head) dots of a step by a reduce-scatter over the
// lanes (about U·NS shuffles in place of 5 a dot; another order of the
// dot's float32 sum); 0: one butterfly a dot.
constexpr int kDotScatter = 1;

template <int VALS, int NS> struct BwdRowsInFlight {
  static constexpr int by_values = kFlightValues / VALS, by_dots = kFlightDots / NS;
  static constexpr int raw = by_values < by_dots ? by_values : by_dots;
  static constexpr int value = raw < 1 ? 1 : (raw > 8 ? 8 : raw);
};

__host__ __device__ constexpr int pow2_at_least(int k) { return k <= 1 ? 1 : 2 * pow2_at_least((k + 1) / 2); }
__host__ __device__ constexpr int log2_of(int k) { return k <= 1 ? 0 : 1 + log2_of(k / 2); }

// A warp's part of the dynamic shared memory: the row's msg at each lane's
// columns of a walk (32·VEC·NCH floats, each lane reading back only what it
// wrote), the table's 32 receiver ids, and w and lr' per head, padded to 16
// bytes.
__host__ __device__ inline int bwd_table_floats(int H, int vec, int nch) {
  return 32 * vec * nch + 32 + ((2 * H + 3) & ~3);
}

// Lane groups of the narrow rows (MULTI): G groups of W lanes.
constexpr int kGroupLanes = 16;
constexpr int kGroups = 2;

// What a lane holds through one walk: its columns (group c at cbase +
// c·32·VEC; at `lim` and past: none) and their head slot within the walk
// (heads h0 .. h0 + nh - 1), the weight of each column's head, where its msg
// columns are (`msg`, group c at msg + c·32·VEC), and for the lane that owns
// slot `mine` (< nh) the head's w and lr'.
template <int VEC, int NCH> struct Walk {
  int cbase, slot[NCH];
  float wc[NCH];
  const float* msg;
  int h0, nh, lim, mine;
  bool owner;
  float w, lr;
};

// The d_el term of one edge: round_T((dot + gden)·w·lr'), the first form's
// order of operations.
template <typename T>
__device__ __forceinline__ float del_term(float dot, float gden, float w, float lr) {
  return round_to<T>(__fmul_rn(__fmul_rn(__fadd_rn(dot, gden), w), lr));
}

// U table entries: i + u·G + grp for u < U (each group its own entries; an
// entry at n or past is skipped, but its lanes join the shuffles).  NS: the
// head slots whose dots the step reduces (every one of them, so that no
// shuffle sits under a condition).  GPH > 0: a head is GPH whole column
// groups (D = GPH·32·VEC), so group c is slot c / GPH in every lane and a
// lane's part of a dot runs on through its groups of the head, as the first
// form's did; GPH 0: the slot of a group depends on the lane, and each
// group's part is added to its slot (every slot takes an add, so that the
// parts stay in registers).  MULTI: kGroups groups of kGroupLanes lanes,
// whose butterflies start at offset kGroupLanes / 2 (the reduce-scatter
// takes one group of 32).
template <typename T, int VEC, int NCH, int GPH, int NS, int U, bool MULTI>
__device__ __forceinline__ void bwd_step(const T* __restrict__ g, long long P, int HD,
                                         const int* ids, int i, int n, int grp, int lane,
                                         const Walk<VEC, NCH>& wk, float (&acc)[NCH][VEC],
                                         float& acc_el) {
  constexpr int G = MULTI ? kGroups : 1, W = MULTI ? kGroupLanes : 32;
  float v[U][NCH][VEC], gd[U];
  bool ok[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int k = i + u * G + grp;
    ok[u] = k < n;
    gd[u] = 0.f;
    const T* src = g + static_cast<long long>(ok[u] ? ids[k] : 0) * P;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int c0 = wk.cbase + c * 32 * VEC;
      if (ok[u] && c0 < wk.lim) {
        Rows<T, VEC>::load(src + c0, v[u][c]);
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q) v[u][c][q] = 0.f;
      }
    }
    if (ok[u] && wk.owner) gd[u] = to_f32(src[HD + wk.h0 + wk.mine]);
  }
  // each row at once: dmsg in edge order, and the lane's part of each
  // (row, head slot) dot, its columns in order
  float part[U][NS];
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int s = 0; s < NS; ++s) part[u][s] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      float m[VEC];
      Rows<float, VEC>::load(wk.msg + c * 32 * VEC, m);
      if constexpr (GPH > 0) {
        if (c / GPH < NS)
#pragma unroll
          for (int q = 0; q < VEC; ++q)
            part[u][c / GPH] = fmaf(m[q], v[u][c][q], part[u][c / GPH]);
      } else {
        float pc = 0.f;
#pragma unroll
        for (int q = 0; q < VEC; ++q) pc = fmaf(m[q], v[u][c][q], pc);
#pragma unroll
        for (int s = 0; s < NS; ++s)
          part[u][s] = __fadd_rn(part[u][s], wk.slot[c] == s ? pc : 0.f);
      }
      if (ok[u] && wk.cbase + c * 32 * VEC < wk.lim)
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[c][q] += round_to<T>(__fmul_rn(wk.wc[c], v[u][c][q]));
    }
  }
  float dot[U];
  constexpr int K = U * NS, KP = pow2_at_least(U * NS);
  if constexpr (kDotScatter != 0 && !MULTI && KP <= 32) {
    // reduce-scatter: after log2(KP) halving steps lane l holds the sum over
    // lanes of value l >> (5 - log2 KP) within its low lanes; a butterfly
    // over those completes it, and the owner of slot s fetches value u·NS + s
    float x[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) x[k] = k < K ? part[k / NS][k % NS] : 0.f;
#pragma unroll
    for (int half = KP / 2, off = 16; half >= 1; half >>= 1, off >>= 1) {
      const bool up = (lane & off) != 0;
#pragma unroll
      for (int k = 0; k < half; ++k) {
        const float send = up ? x[k] : x[k + half];
        const float keep = up ? x[k + half] : x[k];
        x[k] = __fadd_rn(keep, __shfl_xor_sync(0xFFFFFFFFu, send, off));
      }
    }
#pragma unroll
    for (int off = 16 >> log2_of(KP); off > 0; off >>= 1)
      x[0] = __fadd_rn(x[0], __shfl_xor_sync(0xFFFFFFFFu, x[0], off));
#pragma unroll
    for (int u = 0; u < U; ++u)
      dot[u] = __shfl_sync(0xFFFFFFFFu, x[0], (u * NS + wk.mine) << (5 - log2_of(KP)));
  } else {
    // butterflies within the group of w lanes, every (row, slot) of the walk
    // interleaved; each step adds the same two values in a lane pair
#pragma unroll
    for (int off = W / 2; off > 0; off >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int s = 0; s < NS; ++s)
          part[u][s] = __fadd_rn(part[u][s], __shfl_xor_sync(0xFFFFFFFFu, part[u][s], off));
#pragma unroll
    for (int u = 0; u < U; ++u) {  // one slot's dot, by adds (a part is never -0)
      dot[u] = 0.f;
#pragma unroll
      for (int s = 0; s < NS; ++s) dot[u] = __fadd_rn(dot[u], wk.mine == s ? part[u][s] : 0.f);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (ok[u] && wk.owner) acc_el += del_term<T>(dot[u], gd[u], wk.w, wk.lr);
}

// One walk over the row's edges [start, end): 32 slots' receivers and keep
// bytes at a time into the table `ids`, then U entries a group in flight,
// every lane making the same steps so that the butterflies stay convergent.
template <typename T, int VEC, int NCH, int GPH, int NS, bool MULTI>
__device__ __forceinline__ void bwd_walk(const T* __restrict__ g, const int* __restrict__ recv,
                                         const unsigned char* __restrict__ keep, long long P,
                                         int HD, int start, int end, int* ids, int grp, int lane,
                                         const Walk<VEC, NCH>& wk, float (&acc)[NCH][VEC],
                                         float& acc_el) {
  constexpr int U = BwdRowsInFlight<NCH * VEC, NS>::value;
  constexpr int G = MULTI ? kGroups : 1;
  for (int e0 = start; e0 < end; e0 += 32) {
    const int e = e0 + lane;
    int r = 0;
    bool kept = false;
    if (e < end) {
      r = recv[e];
      kept = keep == nullptr || keep[e] != 0;
    }
    const unsigned mask = __ballot_sync(0xFFFFFFFFu, kept);
    const int n = __popc(mask);
    if (n == 0) continue;  // uniform
    if (kept) ids[__popc(mask & ((1u << lane) - 1u))] = r;
    __syncwarp();
    int i = 0;
    for (; i + U * G <= n; i += U * G)
      bwd_step<T, VEC, NCH, GPH, NS, U, MULTI>(g, P, HD, ids, i, n, grp, lane, wk, acc, acc_el);
    for (; i < n; i += G)
      bwd_step<T, VEC, NCH, GPH, NS, 1, MULTI>(g, P, HD, ids, i, n, grp, lane, wk, acc, acc_el);
    __syncwarp();  // the next slots overwrite the table
  }
}

// MULTI: the row takes kGroups lane groups of kGroupLanes lanes (then
// H·D <= kGroupLanes·VEC and nch 1); else one group of 32.  GPH as for
// bwd_step (0 with MULTI).
template <typename T, int VEC, int NCH, int GPH, bool MULTI>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocks)
gat_bwd_csc_kernel(const T* __restrict__ tab, const T* __restrict__ g,
                   const int* __restrict__ col_ptr, const int* __restrict__ recv,
                   const unsigned char* __restrict__ keep, const float* __restrict__ cmax,
                   T* __restrict__ dtab, int n_rows, int P, int D, int H, float neg_slope) {
  extern __shared__ float smem[];
  const int wib = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + wib;
  if (row >= n_rows) return;  // the whole warp leaves: the shuffles below see 32 lanes
  constexpr int G = MULTI ? kGroups : 1, w = MULTI ? kGroupLanes : 32;
  const int grp = lane / w, j = lane - grp * w;
  const int HD = H * D;
  float* base_smem = smem + wib * bwd_table_floats(H, VEC, NCH);
  float* msg_s = base_smem + lane * VEC;
  int* ids = reinterpret_cast<int*>(base_smem + 32 * VEC * NCH);
  float* wts = base_smem + 32 * VEC * NCH + 32;
  float* lrs = wts + H;
  const T* own = tab + static_cast<long long>(row) * P;
  for (int h = lane; h < H; h += 32) {
    const float el = to_f32(own[HD + h]);
    wts[h] = gat_weight(el, cmax[h], neg_slope);
    lrs[h] = el >= 0.f ? 1.f : neg_slope;
  }
  __syncwarp();
  // whole heads a walk: as many as its columns hold, at most NCH (>= 1 by
  // the launch's check)
  const int span = (MULTI ? w : 32) * VEC * NCH;
  int hw = span / D;
  hw = hw < NCH ? hw : NCH;
  hw = hw < H ? hw : H;
  const int start = col_ptr[row], end = col_ptr[row + 1];
  T* dst = dtab + static_cast<long long>(row) * P;
  for (int h0 = 0; h0 < H; h0 += hw) {
    Walk<VEC, NCH> wk;
    wk.h0 = h0;
    wk.nh = hw < H - h0 ? hw : H - h0;
    wk.lim = (h0 + wk.nh) * D;
    wk.mine = j;
    wk.owner = grp < G && j < wk.nh;
    wk.w = wk.owner ? wts[h0 + j] : 0.f;
    wk.lr = wk.owner ? lrs[h0 + j] : 0.f;
    wk.msg = msg_s;
    float acc[NCH][VEC], acc_el = 0.f;
    wk.cbase = MULTI ? (grp < G ? h0 * D + j * VEC : wk.lim) : h0 * D + lane * VEC;
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int c0 = wk.cbase + c * 32 * VEC;
      wk.slot[c] = -1;
      wk.wc[c] = 0.f;
      float m[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) m[q] = acc[c][q] = 0.f;
      if (c0 < wk.lim) {  // D is a multiple of VEC: one head a group of VEC columns
        const int h = c0 / D;
        wk.slot[c] = h - h0;
        wk.wc[c] = wts[h];
        Rows<T, VEC>::load(own + c0, m);
      }
      Rows<float, VEC>::store(msg_s + c * 32 * VEC, m);
    }
    // the head slots a walk can hold: NCH / GPH, or NCH when the slot of a
    // group depends on the lane (a walk of fewer heads reduces zeros too)
    constexpr int SLOTS = GPH > 0 ? (NCH + GPH - 1) / GPH : NCH;
    bwd_walk<T, VEC, NCH, GPH, SLOTS, MULTI>(g, recv, keep, P, HD, start, end, ids, grp, lane,
                                             wk, acc, acc_el);
    if (MULTI) {  // the groups' partial sums, added in the order g = 0, 1, ..., G-1
      float part[VEC];
#pragma unroll
      for (int q = 0; q < VEC; ++q) part[q] = acc[0][q];
      const float pe = acc_el;
      for (int k = 1; k < G; ++k) {
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[0][q] += __shfl_sync(0xFFFFFFFFu, part[q], k * w + j);
        acc_el += __shfl_sync(0xFFFFFFFFu, pe, k * w + j);
      }
      if (grp == 0 && wk.cbase < wk.lim) Rows<T, VEC>::store(dst + wk.cbase, acc[0]);
      if (grp == 0 && wk.owner) dst[HD + h0 + j] = from_f32<T>(acc_el);
    } else {
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        if (wk.cbase + c * 32 * VEC < wk.lim)
          Rows<T, VEC>::store(dst + wk.cbase + c * 32 * VEC, acc[c]);
      if (wk.owner) dst[HD + h0 + j] = from_f32<T>(acc_el);
    }
  }
  for (int c = HD + H + lane; c < P; c += 32) dst[c] = from_f32<T>(0.f);  // past [dmsg | d_el]
}

template <typename T>
int launch_gat_bwd_csc(const void* tab, const void* g, const void* col_ptr, const void* recv,
                       const void* keep, const void* cmax, void* dtab, int n_rows, int P, int D,
                       int H, float neg_slope, int vec, int nch, int w, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H < 1 || D < 1 || !((w == 32 && G == 1) || (w == kGroupLanes && G == kGroups)) ||
      (G > 1 && (nch != 1 || w * vec < H * D)) || w * vec * nch < D)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long smem =
      static_cast<long long>(kWarpsPerBlock) * bwd_table_floats(H, vec, nch) * 4;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(blocks_for_rows(n_rows)), block(kWarpsPerBlock * 32);
#define DGC_K6_LAUNCH(V, N, GPH, MULTI)                                                        \
  do {                                                                                         \
    auto kernel = gat_bwd_csc_kernel<T, V, N, GPH, MULTI>;                                     \
    if (smem > 48 * 1024) {                                                                    \
      const cudaError_t e = cudaFuncSetAttribute(                                              \
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));        \
      if (e != cudaSuccess) return static_cast<int>(e);                                        \
    }                                                                                          \
    kernel<<<grid, block, static_cast<size_t>(smem), s>>>(                                     \
        static_cast<const T*>(tab), static_cast<const T*>(g), static_cast<const int*>(col_ptr), \
        static_cast<const int*>(recv), static_cast<const unsigned char*>(keep),                \
        static_cast<const float*>(cmax), static_cast<T*>(dtab), n_rows, P, D, H, neg_slope);  \
  } while (0)
  // a head of 1 or 2 whole groups of 32·vec columns (D = 128 or 256 at vec 4)
  // takes the static slots; any other the per-lane ones
  const int gph = G == 1 && vec == 4 && D % 128 == 0 && D / 128 <= 2 ? D / 128 : 0;
#define DGC_K6_SLOTS(N)                 \
  do {                                  \
    if (gph == 1) {                     \
      DGC_K6_LAUNCH(4, N, 1, false);    \
    } else if (gph == 2) {              \
      DGC_K6_LAUNCH(4, N, 2, false);    \
    } else {                            \
      DGC_K6_LAUNCH(4, N, 0, false);    \
    }                                   \
  } while (0)
  // vec 4 (D and P multiples of 4, the tables 16-byte aligned) with nch 1,
  // 2, 3, 6 or 8 groups of 128 columns a lane's walk, or vec 1 with 8 groups
  // of 32; lane groups with nch 1
  if (G > 1) {
    if (vec == 4) {
      DGC_K6_LAUNCH(4, 1, 0, true);
    } else if (vec == 1) {
      DGC_K6_LAUNCH(1, 1, 0, true);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  } else if (vec == 4 && nch == 1) {
    if (gph == 1) {
      DGC_K6_LAUNCH(4, 1, 1, false);
    } else {
      DGC_K6_LAUNCH(4, 1, 0, false);
    }
  } else if (vec == 4 && nch == 2) {
    DGC_K6_SLOTS(2);
  } else if (vec == 4 && nch == 3) {
    DGC_K6_SLOTS(3);
  } else if (vec == 4 && nch == 6) {
    DGC_K6_SLOTS(6);
  } else if (vec == 4 && nch == 8) {
    DGC_K6_SLOTS(8);
  } else if (vec == 1 && nch == 8) {
    DGC_K6_LAUNCH(1, 8, 0, false);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DGC_K6_SLOTS
#undef DGC_K6_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes.  tab, g and dtab are [n_rows, P] of one
// type; col_ptr [n_rows + 1] and recv [E_pad] int32 in sender (CSC) order;
// keep [E_pad] uint8 in CSC order, or null when no edge was dropped; cmax [H]
// float32.  `vec` is 4 when D and P are multiples of 4 and the tables are
// aligned for wide loads, else 1; `nch` the number of 32*vec-column groups a
// lane walks at once (a walk takes whole heads); w and G the lane groups
// (G = 1, w = 32 but for narrow bf16 rows).  Returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for a form the kernel does not
// take.
#define DGC_K6_ENTRY(NAME, TT)                                                                \
  extern "C" int NAME(const void* tab, const void* g, const void* col_ptr, const void* recv,  \
                      const void* keep, const void* cmax, void* dtab, int n_rows, int P,       \
                      int D, int H, float neg_slope, int vec, int nch, int w, int G,           \
                      void* stream) {                                                          \
    return dgc::launch_gat_bwd_csc<TT>(tab, g, col_ptr, recv, keep, cmax, dtab, n_rows, P, D, \
                                       H, neg_slope, vec, nch, w, G, stream);                 \
  }

DGC_K6_ENTRY(dgc_gat_bwd_csc_f32, float)
DGC_K6_ENTRY(dgc_gat_bwd_csc_bf16, __nv_bfloat16)

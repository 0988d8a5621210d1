// K4: the backward of the fused softmax aggregation, in sender (CSC) order,
// with or without edge embeddings.  For each sender row s and channel c,
// over the edges e in [col_ptr[s], col_ptr[s+1]) with receiver
// r = csc_receivers[e]:
//
//   xj  = x[s, c] [+ ee_csc[e, c]],  m = relu(xj) + eps,
//   a   = exp(t * m - lse[r, c])          (the normalised weight, <= 1)
//   q   = qo[r, c]              (the cotangent g of out, in T)
//   dm  = q*a*(1 + t*(m - o))   with o = qo[r, C + c] = out[r, c]  (GW)
//       = q*a                                                 (otherwise)
//   dxj = xj > 0 ? dm : 0
//   dee_csc[e, c] = round_T(dxj) (EE),  dx[s, c] = sum_e round_T(dxj)  (float32 sum)
//   dt  = sum over (e, c) of q*a*m*(m - o)                           (GW only)
//
// lse is K2's per-receiver log-normaliser (softmax_agg.cu), so each edge
// reads its receiver's shift: the weights of a receiver whose scores lie far
// below another's do not underflow.  Without edge embeddings (GENConv's
// gather route, ResGEN-28) the message relu(x[s]) + eps is one row per
// sender; the TPU package factors that backward over the nodes
// (spmm_pallas.py:727-760: dx = relu'(x) * exp(t*M - cmax) * A^T(g/den), a
// segment sum), which needs one shift for every receiver: no constant keeps
// both the sender factor and the receiver factor inside float32's exp range
// once a channel's scores spread past ~87.  Here that form is this walk too.
//
// Replaces the TPU kernel `_softmax_bwd_csc_kernel` (spmm_pallas.py:466,
// called at :629).  That kernel walks 128-sender blocks, rebuilds each edge's
// x_j with a transposed one-hot MXU product, streams q[csc_receivers] that
// XLA gathered into an [E, C] or [E, 2C] array beforehand (:768), and writes
// d(ee) back through a ring of VMEM buffers.  Here a warp owns one sender
// row: x[s] is read into registers, the edge range is contiguous in CSC
// order so ee_csc and dee_csc stream coalesced, and the receiver's row of qo
// is gathered inside the kernel, so the [E, C] gathered array is never
// written.  dt is written as one float32 partial per sender row (a warp
// shuffle sum) that one torch.sum adds up: no float atomics, so the result
// does not change from run to run.  dee rows outside
// [col_ptr[0], col_ptr[n_rows]) (the sentinel padding) are zeroed by a
// grid-stride loop of the same launch.
//
// What bounds it on the H100: bytes.  Per (edge, channel) it reads one ee
// value, one or two gathered qo values and one gathered lse value and writes
// one dee value, against about 15 float32 operations and one exp; the node
// tables are small beside the edge streams at the cluster shape (780k edges,
// 13k nodes).  Without ee (ResGEN-28 at C=128 in float32) it writes no edge
// rows, and the gathered g and lse rows (two 87 MB tables, over the 50 MB
// L2) are its bytes, beside one accurate expf per (edge, channel).  What set
// the time instead was latency: with the lanes across the channels alone, 4
// to a lane, a C=40 row left 22 of 32 lanes idle and walked a ~60-edge row
// in ~15 dependent csc_receivers[e] -> qo[r] steps (0.136 ms on the H100,
// 3.5x the byte bound).
//
// The design: lane groups over edges, as K2's (softmax_agg.cu).  The warp's
// lanes split into G groups of w = ceil(C / VEC) lanes, G = 32 / w, VEC = 4
// where the rows allow 8-byte bf16 or 16-byte float32 loads, else 1.  Group
// g walks the edges e = start + g, g + G, ... with four edges in flight a
// lane, so bf16 C=40 keeps 30 lanes busy and 12 edges in flight a warp
// (3 x 10), C=64 2 x 16; C >= 128 keeps one group and walks the channels in
// chunks of 32 VEC.  Each edge belongs to one group, which writes its dee
// row: the per-edge terms round exactly where the TPU kernel rounds them
// (the explicit __f*_rn intrinsics stop nvcc from contracting them into
// fmas), so dee is bit for bit what the one-group form writes.  dx: the G
// float32 partial sums of each channel are added in the fixed order
// g = 0 .. G-1 through shuffles and rounded once, so the result is
// deterministic.  float32 keeps one group, which adds each channel's terms
// in edge order as the plain version does: a CSC row is a sender's
// out-edges, and a hub sender's long row of near-equal float32 terms
// carries an order bias above their 1e-5 agreement (the same reason as
// K2's; ops/spmm_cuda.py::k4_lane_groups chooses w and G).  dt's terms are
// now added in another order (each lane sums its group's edges, then the
// warp), which the tolerance of a float32 sum over N*C terms covers.
//
// Sender rows go to warps longest first, as K2's gather forms take theirs
// (softmax_agg.cu): `order` is the graph's `csc_order` (graph.py::
// build_graph), and a hub sender's walk then starts in the first wave.
//
// Measured on the H100 (80GB HBM3, 700 W) on the proteins cluster (N=13,000,
// E=780,000), with one global shift a channel in place of the lse rows,
// bf16: no dt at C=40 0.070 ms against 0.136 for the
// one-group form (the byte bound is 0.039), dt at C=64 0.129 against 0.200;
// float32 (one group in both) 0.182 / 0.231 against 0.183 / 0.244.
#include "common.cuh"
namespace dgc {

template <typename T, int VEC, bool GW, bool EE>
__device__ __forceinline__ void edge_terms(const float* xs, const float* ev, const float* q,
                                           const float* o, const float* l, float t,
                                           float eps, float* d, float* acc, float* dt) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float xj = EE ? xs[k] + ev[k] : xs[k];
    const float m = fmaxf(xj, 0.f) + eps;
    const float a = expf(__fsub_rn(__fmul_rn(m, t), l[k]));
    const float qa = __fmul_rn(q[k], a);
    float dm = qa;
    if (GW) {
      const float dl = __fsub_rn(m, o[k]);
      dm = __fmul_rn(qa, __fadd_rn(1.f, __fmul_rn(t, dl)));
      *dt += __fmul_rn(__fmul_rn(qa, m), dl);
    }
    d[k] = xj > 0.f ? dm : 0.f;
    acc[k] += round_to<T>(d[k]);
  }
}

// one edge's loads: its ee_csc row (EE) and its receiver's q (and out) and
// lse rows
template <typename T, int VEC, bool GW, bool EE>
__device__ __forceinline__ void load_edge(const T* __restrict__ ee, const T* __restrict__ qo,
                                          const float* __restrict__ lse,
                                          const int* __restrict__ receivers, int e, int C,
                                          long long qs, int c0, float* ev, float* q, float* o,
                                          float* l) {
  const long long r = receivers[e];
  if (EE) Rows<T, VEC>::load(ee + (long long)e * C + c0, ev);
  Rows<T, VEC>::load(qo + r * qs + c0, q);
  if (GW) Rows<T, VEC>::load(qo + r * qs + C + c0, o);
  Rows<float, VEC>::load(lse + r * C + c0, l);
}

// MULTI is false when the row takes one group (w = 32, G = 1): the layout is
// then known at compile time and the walk adds each channel's terms in edge
// order.
template <typename T, int VEC, bool GW, bool EE, bool MULTI>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
softmax_bwd_csc_kernel(const T* __restrict__ x, const T* __restrict__ ee,
                       const T* __restrict__ qo, const float* __restrict__ lse,
                       const int* __restrict__ col_ptr, const int* __restrict__ order,
                       const int* __restrict__ receivers, const float* __restrict__ t_ptr,
                       T* __restrict__ dx,
                       T* __restrict__ dee, float* __restrict__ dt_part, int n_rows, int C,
                       long long e_pad, int w_arg, int G_arg, float eps) {
  if (EE) {  // zero the dee rows that no sender range covers
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long lo = (long long)col_ptr[0] * C, hi = (long long)col_ptr[n_rows] * C;
    for (long long i = tid; i < lo; i += stride) dee[i] = from_f32<T>(0.f);
    for (long long i = hi + tid; i < e_pad * C; i += stride) dee[i] = from_f32<T>(0.f);
  }
  constexpr int U = 4;  // edges in flight a lane
  const int w = MULTI ? w_arg : 32;
  const int G = MULTI ? G_arg : 1;
  const int slot = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (slot >= n_rows) return;  // the whole warp: the shuffles below see 32 lanes
  const int row = order[slot];
  const int g = lane / w;
  const int j = lane - g * w;
  const int start = col_ptr[row];
  const int end = col_ptr[row + 1];
  const float t = *t_ptr;
  const long long qs = GW ? 2LL * C : (long long)C;  // row stride of qo
  float dt = 0.f;
  for (int base = 0; base < C; base += w * VEC) {
    const int c0 = base + j * VEC;
    const bool on = g < G && c0 < C;
    float xs[VEC], acc[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      xs[k] = 0.f;
      acc[k] = 0.f;
    }
    if (on) {
      Rows<T, VEC>::load(x + (long long)row * C + c0, xs);
      int e = start + g;
      for (; e + (U - 1) * G < end; e += U * G) {
        float ev[U][VEC], q[U][VEC], o[U][VEC], l[U][VEC];
#pragma unroll
        for (int u = 0; u < U; ++u)
          load_edge<T, VEC, GW, EE>(ee, qo, lse, receivers, e + u * G, C, qs, c0, ev[u], q[u],
                                    o[u], l[u]);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float d[VEC];
          edge_terms<T, VEC, GW, EE>(xs, ev[u], q[u], o[u], l[u], t, eps, d, acc, &dt);
          if (EE) Rows<T, VEC>::store(dee + (long long)(e + u * G) * C + c0, d);
        }
      }
      for (; e < end; e += G) {
        float ev[VEC], q[VEC], o[VEC], l[VEC], d[VEC];
        load_edge<T, VEC, GW, EE>(ee, qo, lse, receivers, e, C, qs, c0, ev, q, o, l);
        edge_terms<T, VEC, GW, EE>(xs, ev, q, o, l, t, eps, d, acc, &dt);
        if (EE) Rows<T, VEC>::store(dee + (long long)e * C + c0, d);
      }
    }
    // the groups' partial sums of dx, added in the order g = 0, 1, ..., G-1
    float p[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = acc[k];
    for (int h = 1; h < G; ++h) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += __shfl_sync(0xffffffffu, p[k], h * w + j);
    }
    if (on && g == 0) Rows<T, VEC>::store(dx + (long long)row * C + c0, acc);
  }
  if (GW) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dt += __shfl_down_sync(0xffffffffu, dt, off);
    if (lane == 0) dt_part[row] = dt;
  }
}

template <typename T, int VEC, bool GW, bool EE>
void launch_one(const void* x, const void* ee, const void* qo, const void* lse,
                const void* col_ptr, const void* order, const void* receivers, const void* t,
                void* dx, void* dee, void* dt_part, int n_rows, int C, long long e_pad, int w,
                int G, float eps, cudaStream_t s) {
  const dim3 grid(blocks_for_rows(n_rows)), block(kWarpsPerBlock * 32);
  auto kernel = softmax_bwd_csc_kernel<T, VEC, GW, EE, false>;
  if constexpr (sizeof(T) == 2) {  // lane groups: bf16 only (see the head of this file)
    if (G > 1) kernel = softmax_bwd_csc_kernel<T, VEC, GW, EE, true>;
  }
  kernel<<<grid, block, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(ee), static_cast<const T*>(qo),
      static_cast<const float*>(lse), static_cast<const int*>(col_ptr),
      static_cast<const int*>(order), static_cast<const int*>(receivers),
      static_cast<const float*>(t), static_cast<T*>(dx), static_cast<T*>(dee),
      static_cast<float*>(dt_part), n_rows, C, e_pad, w, G, eps);
}

#define DGC_K4_ARGS \
  x, ee, qo, lse, col_ptr, order, receivers, t, dx, dee, dt_part, n_rows, C, e_pad, w, G, eps, s

template <typename T, int VEC, bool GW>
void launch_ee(const void* x, const void* ee, const void* qo, const void* lse,
               const void* col_ptr, const void* order, const void* receivers, const void* t,
               void* dx, void* dee, void* dt_part, int n_rows, int C, long long e_pad, int w,
               int G, float eps, cudaStream_t s) {
  if (ee)
    launch_one<T, VEC, GW, true>(DGC_K4_ARGS);
  else
    launch_one<T, VEC, GW, false>(DGC_K4_ARGS);
}

// vec: 4 or 1, as the wrapper found the rows aligned; w and G: the lane
// groups (w * G <= 32, w * VEC >= C unless w == 32; float32 takes G = 1);
// order: the sender rows in the order the warps take them
template <typename T>
int launch_softmax_bwd_csc(const void* x, const void* ee, const void* qo, const void* lse,
                           const void* col_ptr, const void* order, const void* receivers,
                           const void* t, void* dx, void* dee, void* dt_part, int n_rows, int C,
                           long long e_pad, int w, int G, float eps, int grad_weights, int vec,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w < 1 || w > 32 || G < 1 || w * G > 32 || (sizeof(T) == 4 && G != 1) ||
      (vec != 4 && vec != 1) || (ee != nullptr) != (dee != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec == 4) {
    if (grad_weights) launch_ee<T, 4, true>(DGC_K4_ARGS);
    else launch_ee<T, 4, false>(DGC_K4_ARGS);
  } else {
    if (grad_weights) launch_ee<T, 1, true>(DGC_K4_ARGS);
    else launch_ee<T, 1, false>(DGC_K4_ARGS);
  }
  return static_cast<int>(cudaGetLastError());
}

#undef DGC_K4_ARGS

}  // namespace dgc

// Plain C interface for ctypes.  x, ee (the embeddings in CSC order, or
// null for the gather form), qo, dx and dee (null exactly when ee is) share
// one type; qo is [N_pad, C] (the cotangent g) or, with grad_weights,
// [N_pad, 2C] holding [g | out]; lse is K2's float32 [N_pad, C]; order is
// a permutation of [0, n_rows), longest rows first; dt_part is [n_rows] float32, used only
// with grad_weights (may be null otherwise); w and G the lane groups.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// a lane layout or vec the kernel does not take.
extern "C" int dgc_softmax_bwd_csc_f32(const void* x, const void* ee, const void* qo,
                                       const void* lse, const void* col_ptr, const void* order,
                                       const void* receivers, const void* t, void* dx,
                                       void* dee, void* dt_part, int n_rows, int C,
                                       long long e_pad, int w, int G, float eps,
                                       int grad_weights, int vec, void* stream) {
  return dgc::launch_softmax_bwd_csc<float>(x, ee, qo, lse, col_ptr, order, receivers, t, dx,
                                            dee, dt_part, n_rows, C, e_pad, w, G, eps,
                                            grad_weights, vec, stream);
}

extern "C" int dgc_softmax_bwd_csc_bf16(const void* x, const void* ee, const void* qo,
                                        const void* lse, const void* col_ptr, const void* order,
                                        const void* receivers, const void* t, void* dx,
                                        void* dee, void* dt_part, int n_rows, int C,
                                        long long e_pad, int w, int G, float eps,
                                        int grad_weights, int vec, void* stream) {
  return dgc::launch_softmax_bwd_csc<__nv_bfloat16>(x, ee, qo, lse, col_ptr, order, receivers,
                                                    t, dx, dee, dt_part, n_rows, C, e_pad, w, G,
                                                    eps, grad_weights, vec, stream);
}

// K11: the masked batch-statistics norm, its affine, the ReLU and the
// dropout multiply, forward and backward: RevGAT's block and head norms, and
// DeeperGCN's res+ prologues (BatchNorm -> ReLU -> dropout) with their
// running statistics and their evaluation form.  For x [N_pad, C] and the
// node mask m [N_pad]:
//
//   mu, var = the column mean and (biased) variance over the rows with m true,
//             cnt = max(sum m, 1)  (no valid row: mu = var = 0)
//   xh      = (x - mu) * rstd,  rstd = 1 / sqrt(var + eps)
//   z       = xh * w + b
//   y       = relu(z) * mult
//
// where mult is one of: a float32 tensor [N_pad, C] (RevGAT's shared dropout
// mask chunk, a view with its own row stride), a bool keep mask [N_pad, C]
// applied as keep ? v / div : 0 (inverted dropout, div = 1 - rate: RevGAT's
// head, DeeperGCN's prologues), or nothing.  The backward of the same chain,
// for the cotangent dy:
//
//   g   = dy * mult * [z > 0]                       (over every row)
//   db  = sum_i g_i,   dw = sum_i g_i * xh_i
//   dx_i = rstd * (w * g_i - m_i * (w * db + xh_i * w * dw) / cnt)
//
// which is the exact gradient of the eager chain, pad rows included: they
// use mu and rstd but add nothing to them.  mult gets no cotangent.
//
// DeeperGCN's BatchNorm (nn/core.py) adds two forms.  In training the merge
// also moves the running statistics, in place, as `BatchNorm._update_running`
// does: running = (1 - momentum) * running + momentum * batch, the variance
// made unbiased by cnt / max(cnt - 1, 1); a caller whose statistics are
// frozen (a checkpointed recompute) passes none.  In evaluation mu and rstd
// come from the running statistics, rstd = 1 / sqrt(running_var + eps): one
// elementwise launch, no reduction and no multiplier.  Its backward is the
// training backward with no row in the mask (the statistics are constants),
// dx = rstd * w * g.
//
// Replaces no TPU kernel: the JAX package's `_batch_stats_norm`
// (deep_gcns_torch_tpu/models/rev_gat.py:36-43) and `BatchNorm`
// (deep_gcns_torch_tpu/nn/core.py) are plain jnp, which XLA fuses on the TPU.
// In eager PyTorch the chain is ~10 full-width passes and two or three
// column reductions a forward, and autograd's backward 25 or more.
//
// What bounds it on the H100: bytes.  The forward reads x twice (statistics,
// then the output pass), mult once and writes y: at [169,472 x 384] float32
// with a float multiplier 1.04 GB, 0.31 ms at 3.35 TB/s; at [169,472 x 128]
// with a keep mask 282 MB, 0.084 ms.  The backward reads x, dy and mult
// twice (the column sums, then dx) and writes dx: 1.82 GB and 477 MB.
//
// The design, three launches each way, every sum in a fixed order (no float
// atomics, so two calls on one input give the same bits):
//   1. Column partials over slabs of kSlabRows rows (kWideSlabRows where one
//      block spans every column): a block is 8 warps (row lanes) by 32 lanes
//      of VEC columns; each thread walks the slab's rows
//      r = lane_row (mod 8), kUnroll rows' loads in flight.  The forward keeps
//      a Welford (count, mean, M2) per column, merged across the 8 row lanes
//      by Chan's formula in row-lane order; the backward plain sums of g and
//      g * xh.  The one-pass E[x^2] - E[x]^2 form is not used: the residual
//      stream's column means are large against its spread, and it cancels.
//   2. A merge of the slabs' partials per column, in slab order within each
//      of 32 warps and then in warp order: mu, rstd and cnt (and the running
//      statistics) forward; dw, db and the two dx coefficients backward.
//   3. The elementwise pass over rows x columns, VEC-wide loads of x (and dy)
//      and mult at their own row strides, the output contiguous.
// Each product and sum of the affine is rounded as the eager chain rounds it
// (no fma contraction), so given the same mu and rstd the output is the
// eager chain's bit for bit.

#include "common.cuh"

namespace dgc {

constexpr int kRowLanes = 8;    // warps a block, one row lane each
constexpr int kSlabRows = 256;  // rows of one partial (pass 1's block)
constexpr int kUnroll = 2;      // rows (slabs, in a merge) a thread has in flight
constexpr int kApplyRowBlocks = 1024;  // the elementwise pass's grid rows, at most
// Where one block's 32 * VEC columns span every column (ResGEN's C = 128 at
// VEC 4) pass 1 has a single block a slab: slabs twice as tall and twice the
// apply blocks time best there on the H100 (at [169,472 x 128] the backward
// 0.177 against 0.188 ms a call, the forward and the evaluation form within
// 1 %); wider rows (RevGAT's 384 and 768) keep 256 and 1024.
constexpr int kWideSlabRows = 512;
constexpr int kWideApplyRowBlocks = 2048;
constexpr int kMergeWarps = 32;  // warps of a merge block, each a share of the slabs

enum MultMode { kNone = 0, kFloat = 1, kKeep = 2 };

// Chan's merge of (nb, mb, m2b) into (n, mean, m2).
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb, float mb,
                                           float m2b) {
  if (nb == 0.f) return;
  const float nn = __fadd_rn(n, nb);
  const float d = __fsub_rn(mb, mean);
  const float f = __fdiv_rn(nb, nn);
  mean = __fadd_rn(mean, __fmul_rn(d, f));
  m2 = __fadd_rn(__fadd_rn(m2, m2b), __fmul_rn(__fmul_rn(__fmul_rn(d, d), n), f));
  n = nn;
}

// v *= the multiplier at row r, columns [col, col + VEC): a float32 mask's
// values, or a keep mask's keep ? v / div : 0 (the eager dropout's division).
template <int MODE, int VEC>
__device__ __forceinline__ void apply_mult(const void* mult, long long sm, long long r, int col,
                                           float div, float* v) {
  if constexpr (MODE == kFloat) {
    float mv[VEC];
    Rows<float, VEC>::load(static_cast<const float*>(mult) + r * sm + col, mv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = __fmul_rn(v[k], mv[k]);
  } else if constexpr (MODE == kKeep) {
    const unsigned char* kp = static_cast<const unsigned char*>(mult) + r * sm + col;
    unsigned char keep[VEC];
    if constexpr (VEC == 4) {
      const uchar4 k4 = *reinterpret_cast<const uchar4*>(kp);
      keep[0] = k4.x; keep[1] = k4.y; keep[2] = k4.z; keep[3] = k4.w;
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) keep[k] = kp[k];
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = keep[k] ? __fdiv_rn(v[k], div) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int VEC, int SLAB>
__global__ void __launch_bounds__(kRowLanes * 32)
bn_act_stats_kernel(const float* __restrict__ x, long long sx, const bool* __restrict__ mask,
                    int n_rows, int C, float* __restrict__ part_n,
                    float* __restrict__ part_mean, float* __restrict__ part_m2) {
  __shared__ float s_mean[kRowLanes][32 * VEC];
  __shared__ float s_m2[kRowLanes][32 * VEC];
  __shared__ float s_n[kRowLanes];
  const int lane = threadIdx.x, rl = threadIdx.y;
  const int col = blockIdx.x * 32 * VEC + lane * VEC;
  const int slab = blockIdx.y;
  const int r_end = min(n_rows, (slab + 1) * SLAB);
  const bool active = col < C;
  float n = 0.f, mean[VEC], m2[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) mean[k] = m2[k] = 0.f;
  for (int r0 = slab * SLAB + rl; r0 < r_end; r0 += kRowLanes * kUnroll) {
    float v[kUnroll][VEC];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * kRowLanes;
      ok[u] = r < r_end && mask[r];
      if (ok[u] && active) {
        Rows<float, VEC>::load(x + static_cast<long long>(r) * sx + col, v[u]);
      } else {
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[u][k] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!ok[u]) continue;
      n = __fadd_rn(n, 1.f);
      const float inv = __fdiv_rn(1.f, n);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float d = __fsub_rn(v[u][k], mean[k]);
        mean[k] = __fadd_rn(mean[k], __fmul_rn(d, inv));
        m2[k] = __fadd_rn(m2[k], __fmul_rn(d, __fsub_rn(v[u][k], mean[k])));
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    s_mean[rl][lane * VEC + k] = mean[k];
    s_m2[rl][lane * VEC + k] = m2[k];
  }
  if (lane == 0) s_n[rl] = n;
  __syncthreads();
  if (rl != 0) return;
  for (int j = 1; j < kRowLanes; ++j) {
    const float nb = s_n[j];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      float nk = n;
      chan_merge(nk, mean[k], m2[k], nb, s_mean[j][lane * VEC + k], s_m2[j][lane * VEC + k]);
    }
    n = __fadd_rn(n, nb);
  }
  if (blockIdx.x == 0 && lane == 0) part_n[slab] = n;
  if (!active) return;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    if (col + k < C) {
      part_mean[static_cast<long long>(slab) * C + col + k] = mean[k];
      part_m2[static_cast<long long>(slab) * C + col + k] = m2[k];
    }
  }
}

// One column a lane, 32 columns a block; warp w merges the slabs w, w + 32,
// ... in slab order, kUnroll slabs' loads in flight, then warp 0 the warps'
// results in warp order.
// RUNNING: also move running_mean and running_var in place by `momentum`
// (keep_f = 1 - momentum, rounded to float32 by the caller as the eager
// update rounds it).
template <bool RUNNING>
__global__ void __launch_bounds__(kMergeWarps * 32)
bn_act_stats_merge_kernel(const float* __restrict__ part_n, const float* __restrict__ part_mean,
                          const float* __restrict__ part_m2, int n_slabs, int C, float eps,
                          float* __restrict__ mu, float* __restrict__ rstd,
                          float* __restrict__ cnt, float* __restrict__ run_mean,
                          float* __restrict__ run_var, float momentum, float keep_f) {
  __shared__ float s_mean[kMergeWarps][32], s_m2[kMergeWarps][32], s_n[kMergeWarps];
  const int lane = threadIdx.x, w = threadIdx.y;
  const int c = blockIdx.x * 32 + lane;
  const bool active = c < C;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int s0 = w; s0 < n_slabs; s0 += kMergeWarps * kUnroll) {
    float nb[kUnroll], mb[kUnroll], m2b[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kMergeWarps;
      const bool ok = s < n_slabs;
      nb[u] = ok ? part_n[s] : 0.f;
      mb[u] = ok && active ? part_mean[static_cast<long long>(s) * C + c] : 0.f;
      m2b[u] = ok && active ? part_m2[static_cast<long long>(s) * C + c] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) chan_merge(n, mean, m2, nb[u], mb[u], m2b[u]);
  }
  s_mean[w][lane] = mean;
  s_m2[w][lane] = m2;
  if (lane == 0) s_n[w] = n;
  __syncthreads();
  if (w != 0) return;
  for (int j = 1; j < kMergeWarps; ++j)
    chan_merge(n, mean, m2, s_n[j], s_mean[j][lane], s_m2[j][lane]);
  const float cn = fmaxf(n, 1.f);
  if (blockIdx.x == 0 && lane == 0) cnt[0] = cn;
  if (!active) return;
  const float var = __fdiv_rn(m2, cn);
  mu[c] = mean;
  rstd[c] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  if constexpr (RUNNING) {
    const float unbiased = __fdiv_rn(__fmul_rn(var, cn), fmaxf(__fsub_rn(cn, 1.f), 1.f));
    run_mean[c] = __fadd_rn(__fmul_rn(run_mean[c], keep_f), __fmul_rn(mean, momentum));
    run_var[c] = __fadd_rn(__fmul_rn(run_var[c], keep_f), __fmul_rn(unbiased, momentum));
  }
}

// y = relu((x - cm) * cr * cw + cb) * mult over the rows this block's row
// lanes take (grid-strided), columns [col, col + VEC).
template <int VEC, int MODE>
__device__ __forceinline__ void apply_rows(const float* __restrict__ x, long long sx,
                                           const void* __restrict__ mult, long long sm, float div,
                                           const float* cm, const float* cr, const float* cw,
                                           const float* cb, float* __restrict__ y, int n_rows,
                                           int C, int col) {
  const int stride = gridDim.y * kRowLanes;
  for (int r0 = blockIdx.y * kRowLanes + threadIdx.y; r0 < n_rows; r0 += stride * kUnroll) {
    float v[kUnroll][VEC];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * stride;
      if (r < n_rows) Rows<float, VEC>::load(x + static_cast<long long>(r) * sx + col, v[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * stride;
      if (r >= n_rows) continue;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float z = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[u][k], cm[k]), cr[k]), cw[k]),
                                  cb[k]);
        v[u][k] = z > 0.f ? z : 0.f;
      }
      apply_mult<MODE, VEC>(mult, sm, r, col, div, v[u]);
      Rows<float, VEC>::store(y + static_cast<long long>(r) * C + col, v[u]);
    }
  }
}

template <int VEC, int MODE>
__global__ void __launch_bounds__(kRowLanes * 32)
bn_act_apply_kernel(const float* __restrict__ x, long long sx, const void* __restrict__ mult,
                    long long sm, float div, const float* __restrict__ mu,
                    const float* __restrict__ rstd, const float* __restrict__ w,
                    const float* __restrict__ b, float* __restrict__ y, int n_rows, int C) {
  const int col = blockIdx.x * 32 * VEC + threadIdx.x * VEC;
  if (col >= C) return;
  float cm[VEC], cr[VEC], cw[VEC], cb[VEC];
  Rows<float, VEC>::load(mu + col, cm);
  Rows<float, VEC>::load(rstd + col, cr);
  Rows<float, VEC>::load(w + col, cw);
  Rows<float, VEC>::load(b + col, cb);
  apply_rows<VEC, MODE>(x, sx, mult, sm, div, cm, cr, cw, cb, y, n_rows, C, col);
}

// The evaluation form: the running statistics in place of the batch's, rstd
// formed per column as the merge forms it (and written once, for the
// backward), no multiplier.
template <int VEC>
__global__ void __launch_bounds__(kRowLanes * 32)
bn_act_eval_kernel(const float* __restrict__ x, long long sx, const float* __restrict__ run_mean,
                   const float* __restrict__ run_var, const float* __restrict__ w,
                   const float* __restrict__ b, float eps, float* __restrict__ y,
                   float* __restrict__ rstd, int n_rows, int C) {
  const int col = blockIdx.x * 32 * VEC + threadIdx.x * VEC;
  if (col >= C) return;
  float cm[VEC], cr[VEC], cw[VEC], cb[VEC];
  Rows<float, VEC>::load(run_mean + col, cm);
  Rows<float, VEC>::load(run_var + col, cr);
  Rows<float, VEC>::load(w + col, cw);
  Rows<float, VEC>::load(b + col, cb);
#pragma unroll
  for (int k = 0; k < VEC; ++k) cr[k] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(cr[k], eps)));
  if (blockIdx.y == 0 && threadIdx.y == 0) Rows<float, VEC>::store(rstd + col, cr);
  apply_rows<VEC, kNone>(x, sx, nullptr, 0, 1.f, cm, cr, cw, cb, y, n_rows, C, col);
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// g = dy * mult * [z > 0] and xh for VEC columns of row r.
template <int VEC, int MODE>
__device__ __forceinline__ void bwd_terms(const float* x, long long sx, const float* dy,
                                          long long sdy, const void* mult, long long sm,
                                          float div, long long r, int col, const float* cm,
                                          const float* cr, const float* cw, const float* cb,
                                          float* g, float* xh) {
  float xv[VEC];
  Rows<float, VEC>::load(x + r * sx + col, xv);
  Rows<float, VEC>::load(dy + r * sdy + col, g);
  apply_mult<MODE, VEC>(mult, sm, r, col, div, g);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    xh[k] = __fmul_rn(__fsub_rn(xv[k], cm[k]), cr[k]);
    const float z = __fadd_rn(__fmul_rn(xh[k], cw[k]), cb[k]);
    if (!(z > 0.f)) g[k] = 0.f;
  }
}

template <int VEC, int MODE, int SLAB>
__global__ void __launch_bounds__(kRowLanes * 32)
bn_act_bwd_sums_kernel(const float* __restrict__ x, long long sx, const float* __restrict__ dy,
                       long long sdy, const void* __restrict__ mult, long long sm, float div,
                       const float* __restrict__ mu, const float* __restrict__ rstd,
                       const float* __restrict__ w, const float* __restrict__ b, int n_rows,
                       int C, float* __restrict__ part_g, float* __restrict__ part_gx) {
  __shared__ float s_g[kRowLanes][32 * VEC];
  __shared__ float s_gx[kRowLanes][32 * VEC];
  const int lane = threadIdx.x, rl = threadIdx.y;
  const int col = blockIdx.x * 32 * VEC + lane * VEC;
  const int slab = blockIdx.y;
  const int r_end = min(n_rows, (slab + 1) * SLAB);
  const bool active = col < C;
  float sg[VEC], sgx[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) sg[k] = sgx[k] = 0.f;
  if (active) {
    float cm[VEC], cr[VEC], cw[VEC], cb[VEC];
    Rows<float, VEC>::load(mu + col, cm);
    Rows<float, VEC>::load(rstd + col, cr);
    Rows<float, VEC>::load(w + col, cw);
    Rows<float, VEC>::load(b + col, cb);
    for (int r0 = slab * SLAB + rl; r0 < r_end; r0 += kRowLanes * kUnroll) {
      float g[kUnroll][VEC], xh[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * kRowLanes;
        if (r < r_end)
          bwd_terms<VEC, MODE>(x, sx, dy, sdy, mult, sm, div, r, col, cm, cr, cw, cb, g[u], xh[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r0 + u * kRowLanes >= r_end) continue;
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          sg[k] = __fadd_rn(sg[k], g[u][k]);
          sgx[k] = __fadd_rn(sgx[k], __fmul_rn(g[u][k], xh[u][k]));
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    s_g[rl][lane * VEC + k] = sg[k];
    s_gx[rl][lane * VEC + k] = sgx[k];
  }
  __syncthreads();
  if (rl != 0 || !active) return;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    for (int j = 1; j < kRowLanes; ++j) {
      sg[k] = __fadd_rn(sg[k], s_g[j][lane * VEC + k]);
      sgx[k] = __fadd_rn(sgx[k], s_gx[j][lane * VEC + k]);
    }
    if (col + k < C) {
      part_g[static_cast<long long>(slab) * C + col + k] = sg[k];
      part_gx[static_cast<long long>(slab) * C + col + k] = sgx[k];
    }
  }
}

// dw, db, and the coefficients of dx: ca = w * db / cnt, cb = w * dw / cnt;
// the slabs summed as the forward's merge takes them.
__global__ void __launch_bounds__(kMergeWarps * 32)
bn_act_bwd_merge_kernel(const float* __restrict__ part_g, const float* __restrict__ part_gx,
                        int n_slabs, int C, const float* __restrict__ w,
                        const float* __restrict__ cnt, float* __restrict__ dw,
                        float* __restrict__ db, float* __restrict__ coef_a,
                        float* __restrict__ coef_b) {
  __shared__ float s_g[kMergeWarps][32], s_gx[kMergeWarps][32];
  const int lane = threadIdx.x, wp = threadIdx.y;
  const int c = blockIdx.x * 32 + lane;
  const bool active = c < C;
  float sg = 0.f, sgx = 0.f;
  if (active) {
    for (int s0 = wp; s0 < n_slabs; s0 += kMergeWarps * kUnroll) {
      float g[kUnroll], gx[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int s = s0 + u * kMergeWarps;
        g[u] = s < n_slabs ? part_g[static_cast<long long>(s) * C + c] : 0.f;
        gx[u] = s < n_slabs ? part_gx[static_cast<long long>(s) * C + c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        sg = __fadd_rn(sg, g[u]);
        sgx = __fadd_rn(sgx, gx[u]);
      }
    }
  }
  s_g[wp][lane] = sg;
  s_gx[wp][lane] = sgx;
  __syncthreads();
  if (wp != 0 || !active) return;
  for (int j = 1; j < kMergeWarps; ++j) {
    sg = __fadd_rn(sg, s_g[j][lane]);
    sgx = __fadd_rn(sgx, s_gx[j][lane]);
  }
  db[c] = sg;
  dw[c] = sgx;
  const float cn = cnt[0];
  coef_a[c] = __fdiv_rn(__fmul_rn(w[c], sg), cn);
  coef_b[c] = __fdiv_rn(__fmul_rn(w[c], sgx), cn);
}

template <int VEC, int MODE>
__global__ void __launch_bounds__(kRowLanes * 32)
bn_act_bwd_dx_kernel(const float* __restrict__ x, long long sx, const float* __restrict__ dy,
                     long long sdy, const void* __restrict__ mult, long long sm, float div,
                     const bool* __restrict__ mask, const float* __restrict__ mu,
                     const float* __restrict__ rstd, const float* __restrict__ w,
                     const float* __restrict__ b, const float* __restrict__ coef_a,
                     const float* __restrict__ coef_b, float* __restrict__ dx, int n_rows,
                     int C) {
  const int col = blockIdx.x * 32 * VEC + threadIdx.x * VEC;
  if (col >= C) return;
  float cm[VEC], cr[VEC], cw[VEC], cb[VEC], ca[VEC], cbb[VEC];
  Rows<float, VEC>::load(mu + col, cm);
  Rows<float, VEC>::load(rstd + col, cr);
  Rows<float, VEC>::load(w + col, cw);
  Rows<float, VEC>::load(b + col, cb);
  Rows<float, VEC>::load(coef_a + col, ca);
  Rows<float, VEC>::load(coef_b + col, cbb);
  const int stride = gridDim.y * kRowLanes;
  for (int r0 = blockIdx.y * kRowLanes + threadIdx.y; r0 < n_rows; r0 += stride * kUnroll) {
    float g[kUnroll][VEC], xh[kUnroll][VEC];
    bool m[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * stride;
      if (r < n_rows) {
        m[u] = mask[r];
        bwd_terms<VEC, MODE>(x, sx, dy, sdy, mult, sm, div, r, col, cm, cr, cw, cb, g[u], xh[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int r = r0 + u * stride;
      if (r >= n_rows) continue;
      float o[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float corr = m[u] ? __fadd_rn(ca[k], __fmul_rn(xh[u][k], cbb[k])) : 0.f;
        o[k] = __fmul_rn(cr[k], __fsub_rn(__fmul_rn(cw[k], g[u][k]), corr));
      }
      Rows<float, VEC>::store(dx + static_cast<long long>(r) * C + col, o);
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// One column tile of 4-wide loads spans every column: the wide slabs and
// apply grid (kWideSlabRows).
inline bool one_tile(int C, int vec) { return vec == 4 && C <= 32 * 4; }

inline int n_slabs_for(int n_rows, bool wide) {
  const int slab = wide ? kWideSlabRows : kSlabRows;
  return (n_rows + slab - 1) / slab;
}

inline dim3 apply_grid(int n_rows, int C, int vec) {
  const int tiles = (C + 32 * vec - 1) / (32 * vec);
  const int most = one_tile(C, vec) ? kWideApplyRowBlocks : kApplyRowBlocks;
  const int rows = min(most, max(1, (n_rows + kRowLanes * kUnroll - 1) / (kRowLanes * kUnroll)));
  return dim3(tiles, rows);
}

#define DGC_K11_DISPATCH(VEC_, MODE_, CALL)                                                   \
  do {                                                                                        \
    if (VEC_ == 4 && MODE_ == kNone) { CALL(4, kNone); }                                      \
    else if (VEC_ == 4 && MODE_ == kFloat) { CALL(4, kFloat); }                               \
    else if (VEC_ == 4 && MODE_ == kKeep) { CALL(4, kKeep); }                                 \
    else if (VEC_ == 1 && MODE_ == kNone) { CALL(1, kNone); }                                 \
    else if (VEC_ == 1 && MODE_ == kFloat) { CALL(1, kFloat); }                               \
    else if (VEC_ == 1 && MODE_ == kKeep) { CALL(1, kKeep); }                                 \
    else return static_cast<int>(cudaErrorInvalidValue);                                      \
  } while (0)

int launch_bn_act_fwd(const float* x, long long sx, const bool* mask, const float* w,
                      const float* b, const void* mult, long long sm, int mode, float div,
                      float eps, float* y, float* mu, float* rstd, float* cnt, float* part,
                      float* run_mean, float* run_var, float momentum, float keep_f,
                      int n_rows, int C, int vec, cudaStream_t s) {
  const bool wide = one_tile(C, vec);
  const int n_slabs = n_slabs_for(n_rows, wide);
  if (n_rows < 1 || C < 1 || n_slabs > 65535 || (vec != 1 && vec != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  float* part_n = part;
  float* part_mean = part + n_slabs;
  float* part_m2 = part_mean + static_cast<long long>(n_slabs) * C;
  const dim3 block(32, kRowLanes);
  const dim3 sgrid((C + 32 * vec - 1) / (32 * vec), n_slabs);
  if (wide)
    bn_act_stats_kernel<4, kWideSlabRows><<<sgrid, block, 0, s>>>(x, sx, mask, n_rows, C, part_n,
                                                                  part_mean, part_m2);
  else if (vec == 4)
    bn_act_stats_kernel<4, kSlabRows><<<sgrid, block, 0, s>>>(x, sx, mask, n_rows, C, part_n,
                                                              part_mean, part_m2);
  else
    bn_act_stats_kernel<1, kSlabRows><<<sgrid, block, 0, s>>>(x, sx, mask, n_rows, C, part_n,
                                                              part_mean, part_m2);
  if (run_mean != nullptr)
    bn_act_stats_merge_kernel<true><<<(C + 31) / 32, dim3(32, kMergeWarps), 0, s>>>(
        part_n, part_mean, part_m2, n_slabs, C, eps, mu, rstd, cnt, run_mean, run_var, momentum,
        keep_f);
  else
    bn_act_stats_merge_kernel<false><<<(C + 31) / 32, dim3(32, kMergeWarps), 0, s>>>(
        part_n, part_mean, part_m2, n_slabs, C, eps, mu, rstd, cnt, nullptr, nullptr, 0.f, 1.f);
  const dim3 agrid = apply_grid(n_rows, C, vec);
#define DGC_K11_APPLY(V, M)                                                                   \
  bn_act_apply_kernel<V, M><<<agrid, block, 0, s>>>(x, sx, mult, sm, div, mu, rstd, w, b, y,  \
                                                    n_rows, C)
  DGC_K11_DISPATCH(vec, mode, DGC_K11_APPLY);
#undef DGC_K11_APPLY
  return static_cast<int>(cudaGetLastError());
}

int launch_bn_act_eval(const float* x, long long sx, const float* run_mean, const float* run_var,
                       const float* w, const float* b, float eps, float* y, float* rstd,
                       int n_rows, int C, int vec, cudaStream_t s) {
  if (n_rows < 1 || C < 1 || (vec != 1 && vec != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 agrid = apply_grid(n_rows, C, vec);
  const dim3 block(32, kRowLanes);
  if (vec == 4)
    bn_act_eval_kernel<4><<<agrid, block, 0, s>>>(x, sx, run_mean, run_var, w, b, eps, y, rstd,
                                                   n_rows, C);
  else
    bn_act_eval_kernel<1><<<agrid, block, 0, s>>>(x, sx, run_mean, run_var, w, b, eps, y, rstd,
                                                   n_rows, C);
  return static_cast<int>(cudaGetLastError());
}

int launch_bn_act_bwd(const float* x, long long sx, const float* dy, long long sdy,
                      const bool* mask, const float* w, const float* b, const void* mult,
                      long long sm, int mode, float div, const float* mu, const float* rstd,
                      const float* cnt, float* dx, float* dw, float* db, float* part,
                      int n_rows, int C, int vec, cudaStream_t s) {
  const bool wide = one_tile(C, vec);
  const int n_slabs = n_slabs_for(n_rows, wide);
  if (n_rows < 1 || C < 1 || n_slabs > 65535 || (vec != 1 && vec != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  float* part_g = part;
  float* part_gx = part + static_cast<long long>(n_slabs) * C;
  float* coef_a = part_gx + static_cast<long long>(n_slabs) * C;
  float* coef_b = coef_a + C;
  const dim3 block(32, kRowLanes);
  const dim3 sgrid((C + 32 * vec - 1) / (32 * vec), n_slabs);
#define DGC_K11_SUMS_AT(V, M, S)                                                              \
  bn_act_bwd_sums_kernel<V, M, S><<<sgrid, block, 0, s>>>(x, sx, dy, sdy, mult, sm, div, mu,  \
                                                          rstd, w, b, n_rows, C, part_g,      \
                                                          part_gx)
#define DGC_K11_SUMS(V, M)                                                                    \
  if (wide) DGC_K11_SUMS_AT(V, M, (V == 4 ? kWideSlabRows : kSlabRows));                      \
  else DGC_K11_SUMS_AT(V, M, kSlabRows)
  DGC_K11_DISPATCH(vec, mode, DGC_K11_SUMS);
#undef DGC_K11_SUMS
#undef DGC_K11_SUMS_AT
  bn_act_bwd_merge_kernel<<<(C + 31) / 32, dim3(32, kMergeWarps), 0, s>>>(
      part_g, part_gx, n_slabs, C, w, cnt, dw, db, coef_a, coef_b);
  const dim3 agrid = apply_grid(n_rows, C, vec);
#define DGC_K11_DX(V, M)                                                                      \
  bn_act_bwd_dx_kernel<V, M><<<agrid, block, 0, s>>>(x, sx, dy, sdy, mult, sm, div, mask, mu, \
                                                     rstd, w, b, coef_a, coef_b, dx, n_rows,  \
                                                     C)
  DGC_K11_DISPATCH(vec, mode, DGC_K11_DX);
#undef DGC_K11_DX
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes.  Every float tensor is float32; x, mult and
// dy are [n_rows, C] with row strides sx, sm and sdy (in elements; column
// stride 1), y and dx contiguous [n_rows, C]; mask is bool [n_rows]; w, b,
// mu, rstd, dw, db, run_mean and run_var are [C] and cnt [1].  mode is 0 (no
// mult), 1 (mult a float32 tensor) or 2 (mult a bool keep mask, kept values
// divided by div).  run_mean and run_var, when not null, are moved in place
// by momentum (keep_f = 1 - momentum).  part is scratch: 1 + 2 * C floats a
// slab of 256 rows forward, 2 * C a slab and 2 * C more backward (a launch
// with 512-row slabs uses less).  vec 4
// needs C, the row strides and the pointers aligned for 16-byte loads
// (4-byte for a keep mask).  Returns cudaGetLastError() after the launches,
// or cudaErrorInvalidValue for a form the kernels do not take.
extern "C" int dgc_bn_act_fwd_f32(const void* x, long long sx, const void* mask, const void* w,
                                  const void* b, const void* mult, long long sm, int mode,
                                  float div, float eps, void* y, void* mu, void* rstd, void* cnt,
                                  void* part, void* run_mean, void* run_var, float momentum,
                                  float keep_f, int n_rows, int C, int vec, void* stream) {
  return dgc::launch_bn_act_fwd(
      static_cast<const float*>(x), sx, static_cast<const bool*>(mask),
      static_cast<const float*>(w), static_cast<const float*>(b), mult, sm, mode, div, eps,
      static_cast<float*>(y), static_cast<float*>(mu), static_cast<float*>(rstd),
      static_cast<float*>(cnt), static_cast<float*>(part), static_cast<float*>(run_mean),
      static_cast<float*>(run_var), momentum, keep_f, n_rows, C, vec,
      static_cast<cudaStream_t>(stream));
}

// The evaluation form: y [n_rows, C] contiguous and rstd [C] from x (row
// stride sx) and the running statistics.
extern "C" int dgc_bn_act_eval_f32(const void* x, long long sx, const void* run_mean,
                                   const void* run_var, const void* w, const void* b, float eps,
                                   void* y, void* rstd, int n_rows, int C, int vec,
                                   void* stream) {
  return dgc::launch_bn_act_eval(
      static_cast<const float*>(x), sx, static_cast<const float*>(run_mean),
      static_cast<const float*>(run_var), static_cast<const float*>(w),
      static_cast<const float*>(b), eps, static_cast<float*>(y), static_cast<float*>(rstd),
      n_rows, C, vec, static_cast<cudaStream_t>(stream));
}

extern "C" int dgc_bn_act_bwd_f32(const void* x, long long sx, const void* dy, long long sdy,
                                  const void* mask, const void* w, const void* b,
                                  const void* mult, long long sm, int mode, float div,
                                  const void* mu, const void* rstd, const void* cnt, void* dx,
                                  void* dw, void* db, void* part, int n_rows, int C, int vec,
                                  void* stream) {
  return dgc::launch_bn_act_bwd(
      static_cast<const float*>(x), sx, static_cast<const float*>(dy), sdy,
      static_cast<const bool*>(mask), static_cast<const float*>(w),
      static_cast<const float*>(b), mult, sm, mode, div, static_cast<const float*>(mu),
      static_cast<const float*>(rstd), static_cast<const float*>(cnt), static_cast<float*>(dx),
      static_cast<float*>(dw), static_cast<float*>(db), static_cast<float*>(part), n_rows, C,
      vec, static_cast<cudaStream_t>(stream));
}

// K3: the band-dense window product, with an optional hash edge-drop.
//
//   for each row r (receiver block b = r / 128, window start lo = w_lo[b]):
//     out[r, :] = sum_{j < W} keep(r, lo + j) * A[r, j] * x[lo + j, :]
//
// A is an int8 count matrix [N_pad, W] (counts 0..127), x and out are
// [N_pad, C] in float32 or bf16, summed in float32 and rounded once to x's
// dtype.  keep() is the uint32 mixer of `_hash_keep`
// (deep_gcns_torch_tpu/ops/band.py:158-165) on (recv, send) = (r, lo + j),
// exchanged when `swap` is set (the transpose band's rows are senders).
//
// Replaces the TPU kernel `_band_kernel` (deep_gcns_torch_tpu/ops/band.py:425,
// called at :528), which streams each block's x window into VMEM and runs one
// dense [128, W] x [W, C] MXU product per block.  On the TPU that dense waste
// (W / degree, ~50x more MACs than edges) is free; on Hopper it is not, and
// at average degree 15 over W = 768 about 98 % of A is zeros.  So this kernel
// skips the zeros: one warp owns one receiver row, reads its A row in
// 512-column chunks (16 bytes a lane), compacts the non-zero counts of the
// chunk into a per-warp list in shared memory (ballot-free: a popcount and a
// warp prefix sum), and then walks the list with the lanes spanning the
// channels, four x-row loads in flight per step, as K1 does.  The per-entry
// terms count * x are exact in float32 for bf16 x (count < 2^7, 8-bit
// mantissa), so only the order of the float32 sums differs from a dense
// product with float32 accumulation (JAX's bf16 DEFAULT dot with
// preferred_element_type=f32); float32 x uses plain FMAs, no TF32, as
// Precision.HIGHEST does.  The drop hash runs only for non-zero counts.
//
// What bounds it on the H100: bytes.  A is read once (N_pad * W bytes), x
// once (the rows of one block's window are shared by its 128 rows, so their
// re-reads hit L1/L2), out written once; the in-band multiply-adds are far
// below the float32 rate.  chip_smoke.py prints the bound for its run.
// The dense tensor-core form (mma/wgmma over the window) computes the same
// function; choosing between the two is later work.
#include "common.cuh"

namespace dgc {

constexpr int kBandRows = 128;   // receiver rows per block of A (BN)
constexpr int kChunkCols = 512;  // A columns per compaction pass: 32 lanes x 16 bytes

// Byte k (0..15) of a 16-byte word held as four uint32, by selects rather
// than a dynamic register index (which would spill the word to local memory).
__device__ __forceinline__ uint32_t byte_at(const uint32_t* w4, int k) {
  const uint32_t w = k < 8 ? (k < 4 ? w4[0] : w4[1]) : (k < 12 ? w4[2] : w4[3]);
  return (w >> (8 * (k & 3))) & 0xFFu;
}

// NG channel groups of 32 * VEC channels per lane set; blockIdx.y picks the
// channel tile of 32 * VEC * NG channels.
template <typename T, int VEC, int NG, bool DROP>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
band_kernel(const int8_t* __restrict__ a, const int* __restrict__ w_lo,
            const T* __restrict__ x, T* __restrict__ out, int n_rows, int W, int C,
            uint32_t k0, uint32_t k1, int thresh, int swap) {
  __shared__ int lists[kWarpsPerBlock][kChunkCols];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= n_rows) return;  // no block-wide barrier below: warps finish alone
  const int lo = w_lo[row / kBandRows];
  const int c_tile = blockIdx.y * 32 * VEC * NG;
  const int8_t* arow = a + static_cast<long long>(row) * W;
  int* list = lists[warp];

  float acc[NG][VEC];
#pragma unroll
  for (int g = 0; g < NG; ++g)
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[g][k] = 0.f;

  for (int ch = 0; ch < W; ch += kChunkCols) {
    // 1. this lane's 16 counts, and which of them are non-zero (and kept)
    const int col0 = ch + lane * 16;
    int4 word = make_int4(0, 0, 0, 0);
    if (col0 < W) word = *reinterpret_cast<const int4*>(arow + col0);
    const uint32_t w4[4] = {static_cast<uint32_t>(word.x), static_cast<uint32_t>(word.y),
                            static_cast<uint32_t>(word.z), static_cast<uint32_t>(word.w)};
    uint32_t nz = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if (byte_at(w4, k) != 0u) {
        bool keep = true;
        if (DROP) {
          const uint32_t r = static_cast<uint32_t>(row);
          const uint32_t s = static_cast<uint32_t>(lo + col0 + k);
          keep = swap ? hash_keep(s, r, k0, k1, thresh) : hash_keep(r, s, k0, k1, thresh);
        }
        if (keep) nz |= 1u << k;
      }
    }
    // 2. compact (column << 8 | count) into the warp's list
    const int n = __popc(nz);
    int incl = n;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      if (lane >= off) incl += v;
    }
    const int total = __shfl_sync(0xFFFFFFFFu, incl, 31);
    int pos = incl - n;
    while (nz) {
      const int k = __ffs(nz) - 1;
      nz &= nz - 1;
      list[pos++] = ((col0 + k) << 8) | static_cast<int>(byte_at(w4, k));
    }
    __syncwarp();
    // 3. walk the list: every lane reads its channels of each listed x row
    int j = 0;
    for (; j + 4 <= total; j += 4) {
      int ent[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) ent[u] = list[j + u];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int c0 = c_tile + g * 32 * VEC + lane * VEC;
        if (c0 < C) {
          float v[4][VEC];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            Rows<T, VEC>::load(x + static_cast<long long>(lo + (ent[u] >> 8)) * C + c0, v[u]);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float cnt = static_cast<float>(ent[u] & 0xFF);
#pragma unroll
            for (int k = 0; k < VEC; ++k) acc[g][k] = fmaf(cnt, v[u][k], acc[g][k]);
          }
        }
      }
    }
    for (; j < total; ++j) {
      const int e = list[j];
      const float cnt = static_cast<float>(e & 0xFF);
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        const int c0 = c_tile + g * 32 * VEC + lane * VEC;
        if (c0 < C) {
          float v[VEC];
          Rows<T, VEC>::load(x + static_cast<long long>(lo + (e >> 8)) * C + c0, v);
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[g][k] = fmaf(cnt, v[k], acc[g][k]);
        }
      }
    }
    __syncwarp();  // the next chunk overwrites the list
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int c0 = c_tile + g * 32 * VEC + lane * VEC;
    if (c0 < C) Rows<T, VEC>::store(out + static_cast<long long>(row) * C + c0, acc[g]);
  }
}

template <typename T, int VEC, int NG>
void launch_band_ng(const int8_t* a, const int* w_lo, const T* x, T* out, int n_rows,
                    int W, int C, uint32_t k0, uint32_t k1, int thresh, int swap,
                    cudaStream_t s) {
  const int tile = 32 * VEC * NG;
  const dim3 grid(blocks_for_rows(n_rows), (C + tile - 1) / tile), block(kWarpsPerBlock * 32);
  if (thresh >= 0) {
    band_kernel<T, VEC, NG, true><<<grid, block, 0, s>>>(a, w_lo, x, out, n_rows, W, C,
                                                         k0, k1, thresh, swap);
  } else {
    band_kernel<T, VEC, NG, false><<<grid, block, 0, s>>>(a, w_lo, x, out, n_rows, W, C,
                                                          k0, k1, thresh, swap);
  }
}

template <typename T, int VEC>
void launch_band_vec(const int8_t* a, const int* w_lo, const T* x, T* out, int n_rows,
                     int W, int C, uint32_t k0, uint32_t k1, int thresh, int swap,
                     cudaStream_t s) {
  if (C > 32 * VEC) {
    launch_band_ng<T, VEC, 2>(a, w_lo, x, out, n_rows, W, C, k0, k1, thresh, swap, s);
  } else {
    launch_band_ng<T, VEC, 1>(a, w_lo, x, out, n_rows, W, C, k0, k1, thresh, swap, s);
  }
}

template <typename T>
int launch_band(const void* a, const void* w_lo, const void* x, void* out, int n_rows,
                int W, int C, int vec, uint32_t k0, uint32_t k1, int thresh, int swap,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* a8 = static_cast<const int8_t*>(a);
  const int* wl = static_cast<const int*>(w_lo);
  const T* xt = static_cast<const T*>(x);
  T* o = static_cast<T*>(out);
  if (vec == 4) {
    launch_band_vec<T, 4>(a8, wl, xt, o, n_rows, W, C, k0, k1, thresh, swap, s);
  } else {
    launch_band_vec<T, 1>(a8, wl, xt, o, n_rows, W, C, k0, k1, thresh, swap, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes.  W is a multiple of 128 (16-byte aligned A
// rows, A's base 16-byte aligned); `vec` is 4 when C % 4 == 0 and x and out
// are 16-byte aligned, else 1.  thresh < 0 means no drop; k0/k1 are the
// drop key's int32 bits.  Returns cudaGetLastError() after the launch.
extern "C" int dgc_band_f32(const void* a, const void* w_lo, const void* x, void* out,
                            int n_rows, int W, int C, int vec, uint32_t k0, uint32_t k1,
                            int thresh, int swap, void* stream) {
  return dgc::launch_band<float>(a, w_lo, x, out, n_rows, W, C, vec, k0, k1, thresh,
                                 swap, stream);
}

extern "C" int dgc_band_bf16(const void* a, const void* w_lo, const void* x, void* out,
                             int n_rows, int W, int C, int vec, uint32_t k0, uint32_t k1,
                             int thresh, int swap, void* stream) {
  return dgc::launch_band<__nv_bfloat16>(a, w_lo, x, out, n_rows, W, C, vec, k0, k1,
                                         thresh, swap, stream);
}

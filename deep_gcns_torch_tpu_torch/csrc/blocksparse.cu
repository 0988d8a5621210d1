// K10: the block-sparse SpMM out = A @ x over host-built edge tiles.
//
//   for each receiver block rb and each tile t in [tile_start[rb], tile_start[rb+1]):
//     for each edge slot j of t with so = offs[t, 0, j] < SB:
//       out[128 * rb + offs[t, 1, j], :] += x[128 * tile_sb[t] + so, :]
//
// Tiles hold at most T = 512 edges of one (receiver block, sender block) pair
// and come sorted by receiver block; a tile's real edges fill its first slots
// and the sentinel 128 fills the rest (the host builder's invariant,
// `ops/blocksparse.py`).  offs is uint8 [Nt, 2, T]: row 0 the sender offsets
// in the sender block, row 1 the receiver offsets.  x and out are [N_pad, C]
// in float32 or bf16; the sum is taken in float32 and rounded once to x's
// dtype.  Multi-edges count; a receiver block with no tile is written as 0.
//
// Replaces the TPU kernel `_bsp_kernel` (deep_gcns_torch_tpu/ops/blocksparse.py:123,
// called at :194), which DMAs each tile's 128-row sender block into VMEM and
// rebuilds the edges with two one-hot [T, 128] MXU products per tile, summed
// in a VMEM accumulator across the receiver block's tiles.  On Hopper the
// edges are read directly: one block of threads owns one receiver block and
// a chunk of kCT channels, keeps a float32 accumulator [128, kCT] in shared
// memory (32 KB), stages each tile's 1 KB of offsets into shared memory with
// one 16-byte load a thread, and walks the tile's edges in order, one thread
// per channel.  A thread alone touches its accumulator column, so there are
// no atomics and every output is summed in tile order, the order of the
// plain version's `index_add_` on the CPU.  Four x rows are loaded ahead of
// their adds; the sender block (128 rows) stays in L1/L2 across its tile.
//
// What bounds it on the H100: bytes.  x is read once, out written once, the
// offsets and tile arrays read once per channel chunk; the adds (E * C) are
// far below the float32 rate.  The shared accumulator caps the resident
// threads at ~14 warps an SM, so latency rather than bandwidth sets the time
// of this first form; chip_smoke.py prints its time and bound.
#include "common.cuh"

namespace dgc {

constexpr int kBlk = 128;   // receiver rows per block (BN) and sender rows per block (SB)
constexpr int kTile = 512;  // edge slots per tile (T)
constexpr int kCT = 64;     // channels per thread block, one thread each

template <typename T>
__global__ void __launch_bounds__(kCT)
bsp_kernel(const T* __restrict__ x, const int* __restrict__ tile_start,
           const int* __restrict__ tile_sb, const uint8_t* __restrict__ offs,
           T* __restrict__ out, int C) {
  __shared__ float acc[kBlk][kCT];
  __shared__ __align__(16) uint8_t stage[2 * kTile];  // [so row | ro row]
  __shared__ int n_edges;
  const int tid = threadIdx.x;
  const int rb = blockIdx.x;
  const int c = blockIdx.y * kCT + tid;
  const bool active = c < C;
#pragma unroll 8
  for (int r = 0; r < kBlk; ++r) acc[r][tid] = 0.f;
  const int lo = tile_start[rb];
  const int hi = tile_start[rb + 1];
  for (int t = lo; t < hi; ++t) {
    __syncthreads();  // every thread is done with the previous tile's offsets
    // 1024 bytes of offsets: 64 threads x 16 bytes, one coalesced load
    const uint4 w = reinterpret_cast<const uint4*>(offs + static_cast<long long>(t) * 2 * kTile)[tid];
    reinterpret_cast<uint4*>(stage)[tid] = w;
    if (tid < 32) {
      // warp 0 holds the sender row: a slot is real iff its byte is < 128
      int cnt = 16 - __popc(w.x & 0x80808080u) - __popc(w.y & 0x80808080u)
                   - __popc(w.z & 0x80808080u) - __popc(w.w & 0x80808080u);
      cnt = __reduce_add_sync(0xffffffffu, cnt);
      if (tid == 0) n_edges = cnt;
    }
    __syncthreads();
    if (!active) continue;
    const int n = n_edges;
    const T* xb = x + static_cast<long long>(tile_sb[t]) * kBlk * C + c;
    int j = 0;
    for (; j + 4 <= n; j += 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = to_f32(xb[static_cast<long long>(stage[j + u]) * C]);
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[stage[kTile + j + u]][tid] += v[u];
    }
    for (; j < n; ++j) acc[stage[kTile + j]][tid] += to_f32(xb[static_cast<long long>(stage[j]) * C]);
  }
  if (!active) return;
  T* ob = out + static_cast<long long>(rb) * kBlk * C + c;
#pragma unroll 8
  for (int r = 0; r < kBlk; ++r) ob[static_cast<long long>(r) * C] = from_f32<T>(acc[r][tid]);
}

template <typename T>
int launch_bsp(const void* x, const void* tile_start, const void* tile_sb, const void* offs,
               void* out, int n_blocks, int C, void* stream) {
  const dim3 grid(n_blocks, (C + kCT - 1) / kCT), block(kCT);
  bsp_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_sb), static_cast<const uint8_t*>(offs),
      static_cast<T*>(out), C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes: x and out [n_blocks * 128, C], tile_start
// int32 [n_blocks + 1], tile_sb int32 [Nt], offs uint8 [Nt, 2, 512] (16-byte
// aligned).  Returns cudaGetLastError() after the launch.
extern "C" int dgc_bsp_f32(const void* x, const void* tile_start, const void* tile_sb,
                           const void* offs, void* out, int n_blocks, int C, void* stream) {
  return dgc::launch_bsp<float>(x, tile_start, tile_sb, offs, out, n_blocks, C, stream);
}

extern "C" int dgc_bsp_bf16(const void* x, const void* tile_start, const void* tile_sb,
                            const void* offs, void* out, int n_blocks, int C, void* stream) {
  return dgc::launch_bsp<__nv_bfloat16>(x, tile_start, tile_sb, offs, out, n_blocks, C,
                                        stream);
}

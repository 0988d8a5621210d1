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
// rebuilds the edges with two one-hot [T, 128] MXU products per tile.  This
// form keeps the TPU's idea and runs it on Hopper's tensor cores: each tile
// becomes its dense [128 x 128] adjacency block A_t (edge counts), and the
// receiver block's output is the sum of the products A_t @ x[sender block].
//
//   * One thread block (8 warps) owns a receiver block and up to 128
//     channels (C > 128 is chunked across blockIdx.y).  Its float32
//     accumulator [128, C<=128] lives in registers in mma.sync's layout:
//     warp w owns rows 16w..16w+15, sixteen 16x8 tiles (64 floats a
//     thread) at C=128.
//   * Per tile: each thread takes two slots and adds their edges' counts
//     into a uint16 count plane in shared memory (32-bit shared atomics on
//     packed pairs: the counts are integers, so the order does not matter),
//     converts the touched cells in place to bf16, runs A_t @ x_sb with
//     ldmatrix and mma.sync.m16n8k16 (bf16 in, float32 out; inline PTX)
//     and resets only the touched cells.  In bf16 the 128-row sender block
//     comes in with cp.async, double buffered, so tile t+1's copy overlaps
//     tile t's work; the next tile's offsets are loaded a tile ahead.
//   * Exactness.  A count and a bf16 value multiply exactly in float32, so
//     the products are exact; their accumulation follows the tensor cores'
//     float32 adder (inside one mma it is not IEEE round-to-nearest), so
//     the sums differ from the plain version's float32 index_add_ in order
//     and in rounding, within the tests' float32 tolerance (1e-5).  The
//     result is deterministic: no float atomics, a fixed order of the
//     products.  Counts up to 256 are exact in bf16; a tile of 512 slots
//     can hold at most one cell above 256, and that cell's excess (at most
//     256) goes through a second product with the rest of the block zero.
//   * float32 x: JAX's dots use HIGHEST, so TF32 will not do.  Each value is
//     split into three bf16 parts hi + mid + lo that add up to it exactly
//     (8 + 8 + 8 significant bits), staged synchronously into three planes,
//     and the three products are accumulated smallest part first.
//   * Any C: the planes are padded with zero columns to a multiple of 16;
//     bf16 rows that are not 16-byte copies (C % 8 != 0) are staged with
//     scalar loads.
//
// What bounds it on the H100 (published peaks of the SXM part at 700 W): at
// the K10 phase's shape (6,858 tiles, C=128) the dense products are
// 2·128·128·128 flops a tile, 28.8 GFLOP in all (0.029 ms at 989 TFLOP/s
// bf16), and the bytes are x and out once (86.8 MB, 0.026 ms at 3.35 TB/s)
// plus ~225 MB of sender-block reads that mostly hit L2 (x fits the 50 MB
// L2).  mma.sync reaches well under the bf16 peak, and the per-tile work
// around the products (the scatter, five barriers, the copies) barely
// overlaps them: a build without the products runs in about half the time,
// so the two halves are the next thing to overlap (a second adjacency
// block, fewer barriers).  chip_smoke.py prints its time, its bound and
// torch.sparse.mm's time.
#include "common.cuh"

namespace dgc {

constexpr int kBlk = 128;      // receiver rows per block (BN) and sender rows per block (SB)
constexpr int kTile = 512;     // edge slots per tile (T)
constexpr int kThreads = 256;  // 8 warps of 16 receiver rows
constexpr int kCT = 128;       // channels per thread block
constexpr int kLdA = kBlk + 8; // row pitch of the adjacency block (padding against bank conflicts)
constexpr int kExact = 256;    // the largest count that bf16 holds exactly
constexpr int kN8 = kCT / 8;   // 8-channel accumulator tiles a warp holds at most

// bytes of dynamic shared memory: the adjacency block, then the sender-block
// planes (nbuf of them, row pitch cc + 8), reused at the end as the float32
// staging of the output (row pitch cc + 4)
inline size_t bsp_smem_bytes(int cc, int nbuf) {
  const size_t adj = size_t(kBlk) * kLdA * 2;
  const size_t planes = size_t(nbuf) * kBlk * (cc + 8) * 2;
  const size_t stage = size_t(kBlk) * (cc + 4) * 4;
  return adj + (planes > stage ? planes : stage);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_prev() {  // all groups but the newest one
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// four 8x8 bf16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a @ b on the tensor cores: a [16 x 16] bf16 (row), b [16 x 8] bf16 (col), d float32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the sender block's [128, cw] channels as 16-byte cp.async copies (bf16, cw % 8 == 0)
__device__ __forceinline__ void copy_block_async(const __nv_bfloat16* __restrict__ src, int C,
                                                 int cw, int ldb, __nv_bfloat16* pl, int tid) {
  const int cpr = cw >> 3;
  for (int i = tid; i < kBlk * cpr; i += kThreads) {
    const int r = i / cpr, ch = i - r * cpr;
    cp_async16(pl + r * ldb + ch * 8, src + static_cast<long long>(r) * C + ch * 8);
  }
}

// the sender block's [128, cw] channels as NP bf16 planes whose sum is x
// exactly (NP = 1 for bf16 x, 3 for float32 x: hi, mid, lo)
template <typename T, int NP>
__device__ __forceinline__ void load_block(const T* __restrict__ src, int C, int cw, int ldb,
                                           __nv_bfloat16* pl, int tid) {
  const int plane = kBlk * ldb;
  for (int i = tid; i < kBlk * cw; i += kThreads) {
    const int r = i / cw, c = i - r * cw;
    float v = to_f32(src[static_cast<long long>(r) * C + c]);
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const __nv_bfloat16 h = __float2bfloat16_rn(v);
      pl[p * plane + r * ldb + c] = h;
      v -= __bfloat162float(h);  // exact: the remainder has at most 16 significant bits
    }
  }
}

// acc += A_t[the warp's 16 rows, :] @ planes[:, :cc], smallest plane first.
// acc[n] is the [16 x 8] float32 tile of channels 8n .. 8n+7 in mma.sync's
// layout: lane l holds rows l/4 and l/4 + 8, channels 8n + 2(l%4) + {0, 1}.
template <int NP>
__device__ __forceinline__ void mma_block(const __nv_bfloat16* adj, const __nv_bfloat16* pl,
                                          int ldb, int n16, int warp, int lane,
                                          float (&acc)[kN8][4]) {
  const int plane = kBlk * ldb;
  // ldmatrix's row addresses: row lane % 16, column (lane / 16) * 8 of a 16x16 block
  const int lr = lane & 15, lc = (lane >> 4) * 8;
  const __nv_bfloat16* a_row = adj + (warp * 16 + lr) * kLdA + lc;
#pragma unroll
  for (int p = NP - 1; p >= 0; --p) {
    const __nv_bfloat16* b_row = pl + p * plane + lr * ldb + lc;
#pragma unroll 2
    for (int k = 0; k < kBlk; k += 16) {
      unsigned a[4];
      ldmatrix_x4(a, a_row + k);
#pragma unroll
      for (int n = 0; n < kN8 / 2; ++n) {
        if (n < n16) {
          unsigned b[4];  // k rows 0-7 and 8-15 of channels 16n .. 16n+7, then 16n+8 ..
          ldmatrix_x4_trans(b, b_row + k * ldb + n * 16);
          mma_bf16(acc[2 * n], a, b[0], b[1]);
          mma_bf16(acc[2 * n + 1], a, b[2], b[3]);
        }
      }
    }
  }
}

template <typename T, int NP, bool ASYNC>
__global__ void __launch_bounds__(kThreads, 2)
bsp_kernel(const T* __restrict__ x, const int* __restrict__ tile_start,
           const int* __restrict__ tile_sb, const uint8_t* __restrict__ offs,
           T* __restrict__ out, int C) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* adj = reinterpret_cast<__nv_bfloat16*>(smem);
  unsigned short* cnt = reinterpret_cast<unsigned short*>(smem);  // the same cells as counts
  __nv_bfloat16* planes = adj + kBlk * kLdA;
  __shared__ int ovf_cell, ovf_rem;
  constexpr int kBuf = ASYNC ? 2 : NP;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rb = blockIdx.x, c0 = blockIdx.y * kCT;
  const int cw = min(kCT, C - c0), cc = (cw + 15) & ~15, ldb = cc + 8, n16 = cc >> 4;
  const int plane = kBlk * ldb;
  {  // zero the adjacency block and the planes: their padding columns stay 0
    uint4* p = reinterpret_cast<uint4*>(smem);
    const int n_vec = (kBlk * kLdA + kBuf * plane) / 8;
    for (int i = tid; i < n_vec; i += kThreads) p[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (tid == 0) ovf_cell = -1;
  float acc[kN8][4];
#pragma unroll
  for (int n = 0; n < kN8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const int lo = tile_start[rb], hi = tile_start[rb + 1];
  const T* xc = x + c0;
  // tile t's slots (two a thread) and the next tile's, loaded one tile ahead
  auto slots = [&](int t, int (&so)[2], int (&ro)[2]) {
    if (t < hi) {
      const uint8_t* o = offs + static_cast<long long>(t) * 2 * kTile;
      so[0] = o[tid];
      so[1] = o[tid + kThreads];
      ro[0] = o[kTile + tid];
      ro[1] = o[kTile + tid + kThreads];
    } else {
      so[0] = so[1] = ro[0] = ro[1] = kBlk;
    }
  };
  int so[2], ro[2];
  slots(lo, so, ro);
  int sb_next = lo + 1 < hi ? tile_sb[lo + 1] : 0;
  __syncthreads();
  if constexpr (ASYNC) {
    if (lo < hi)
      copy_block_async(reinterpret_cast<const __nv_bfloat16*>(xc) +
                           static_cast<long long>(tile_sb[lo]) * kBlk * C,
                       C, cw, ldb, planes, tid);
    cp_async_commit();
  }
  for (int t = lo; t < hi; ++t) {
    const int buf = ASYNC ? ((t - lo) & 1) : 0;
    int so_n[2], ro_n[2];
    slots(t + 1, so_n, ro_n);
    const int sb_after = t + 2 < hi ? tile_sb[t + 2] : 0;
    if constexpr (ASYNC) {
      if (t + 1 < hi)
        copy_block_async(reinterpret_cast<const __nv_bfloat16*>(xc) +
                             static_cast<long long>(sb_next) * kBlk * C,
                         C, cw, ldb, planes + (buf ^ 1) * plane, tid);
      cp_async_commit();
    } else {
      load_block<T, NP>(xc + static_cast<long long>(tile_sb[t]) * kBlk * C, C, cw, ldb, planes,
                        tid);
    }
    bool real[2];
    int cell[2], n_cell[2];
    // 1. counts: one 32-bit shared atomic per edge on the pair that holds its cell
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      real[i] = so[i] < kBlk;
      cell[i] = ro[i] * kLdA + so[i];
      if (real[i])
        atomicAdd(reinterpret_cast<unsigned*>(cnt + (cell[i] & ~1)),
                  (cell[i] & 1) ? 0x10000u : 1u);
    }
    __syncthreads();
    // 2. read the counts; the one cell that may exceed 256 keeps its excess apart
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      n_cell[i] = real[i] ? cnt[cell[i]] : 0;
      if (n_cell[i] > kExact) {
        ovf_cell = cell[i];
        ovf_rem = n_cell[i] - kExact;
      }
    }
    __syncthreads();
    // 3. counts to bf16 in place (every writer of a cell writes the same value)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (real[i]) adj[cell[i]] = __float2bfloat16_rn(static_cast<float>(min(n_cell[i], kExact)));
    if constexpr (ASYNC) cp_async_wait_prev();
    __syncthreads();
    mma_block<NP>(adj, planes + buf * plane, ldb, n16, warp, lane, acc);
    __syncthreads();
    // 4. reset the touched cells; the excess of a cell above 256, alone
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (real[i]) cnt[cell[i]] = 0;
    if (ovf_cell >= 0) {
      __syncthreads();
      if (tid == 0) adj[ovf_cell] = __float2bfloat16_rn(static_cast<float>(ovf_rem));
      __syncthreads();
      mma_block<NP>(adj, planes + buf * plane, ldb, n16, warp, lane, acc);
      __syncthreads();
      if (tid == 0) {
        cnt[ovf_cell] = 0;
        ovf_cell = -1;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      so[i] = so_n[i];
      ro[i] = ro_n[i];
    }
    sb_next = sb_after;
  }
  // epilogue: each warp stages its 16 rows in float32, then writes them
  // rounded once, row by row
  const int lds = cc + 4;
  float* stage = reinterpret_cast<float*>(planes) + warp * 16 * lds;
  {
    const int r = lane >> 2, c = 2 * (lane & 3);
#pragma unroll
    for (int n = 0; n < kN8; ++n) {
      if (n < 2 * n16) {
        *reinterpret_cast<float2*>(stage + r * lds + 8 * n + c) = make_float2(acc[n][0], acc[n][1]);
        *reinterpret_cast<float2*>(stage + (r + 8) * lds + 8 * n + c) =
            make_float2(acc[n][2], acc[n][3]);
      }
    }
  }
  __syncwarp();
  T* ob = out + (static_cast<long long>(rb) * kBlk + warp * 16) * C + c0;
  if ((cw & 3) == 0 && (C & 3) == 0) {
    const int q = cw >> 2;  // four channels a lane: one 8- or 16-byte store
    for (int i = lane; i < 16 * q; i += 32) {
      const int r = i / q, c = (i - r * q) * 4;
      const float4 v = *reinterpret_cast<const float4*>(stage + r * lds + c);
      float f[4] = {v.x, v.y, v.z, v.w};
      Rows<T, 4>::store(ob + static_cast<long long>(r) * C + c, f);
    }
  } else {
    for (int i = lane; i < 16 * cw; i += 32) {
      const int r = i / cw, c = i - r * cw;
      ob[static_cast<long long>(r) * C + c] = from_f32<T>(stage[r * lds + c]);
    }
  }
}

template <typename T, int NP, bool ASYNC>
int launch_one(const void* x, const void* tile_start, const void* tile_sb, const void* offs,
               void* out, int n_blocks, int C, cudaStream_t stream) {
  const int cc = ((C < kCT ? C : kCT) + 15) & ~15;
  const size_t smem = bsp_smem_bytes(cc, ASYNC ? 2 : NP);
  auto kernel = bsp_kernel<T, NP, ASYNC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_blocks, (C + kCT - 1) / kCT), block(kThreads);
  kernel<<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_sb), static_cast<const uint8_t*>(offs),
      static_cast<T*>(out), C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes: x and out [n_blocks * 128, C], tile_start
// int32 [n_blocks + 1], tile_sb int32 [Nt], offs uint8 [Nt, 2, 512].  bf16
// rows that may be copied 16 bytes at a time (C % 8 == 0, x 16-byte aligned)
// take the cp.async form.  Returns the first CUDA error of the set-up or the
// launch, 0 if none.
extern "C" int dgc_bsp_f32(const void* x, const void* tile_start, const void* tile_sb,
                           const void* offs, void* out, int n_blocks, int C, void* stream) {
  return dgc::launch_one<float, 3, false>(x, tile_start, tile_sb, offs, out, n_blocks, C,
                                          static_cast<cudaStream_t>(stream));
}

extern "C" int dgc_bsp_bf16(const void* x, const void* tile_start, const void* tile_sb,
                            const void* offs, void* out, int n_blocks, int C, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return dgc::launch_one<__nv_bfloat16, 1, true>(x, tile_start, tile_sb, offs, out, n_blocks,
                                                   C, s);
  return dgc::launch_one<__nv_bfloat16, 1, false>(x, tile_start, tile_sb, offs, out, n_blocks,
                                                  C, s);
}

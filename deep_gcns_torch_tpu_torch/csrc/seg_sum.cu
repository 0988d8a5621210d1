// K1: CSR segment sum with an optional fused row gather.
//
//   out[n, :] = sum_{e in [ptr[n], ptr[n+1])} src[idx ? idx[e] : e, :]
//
// Replaces the TPU kernel `_seg_sum_kernel`
// (deep_gcns_torch_tpu/ops/spmm_pallas.py:252, called at :285), which scatters
// edge tiles into 128-row node blocks through a one-hot matmul on the MXU.
// On Hopper the segments are contiguous edge ranges, so each row is walked by
// the lanes that own it: no one-hot product, no atomics, and the result is
// deterministic. Every channel adds its row's edges in edge order, in
// float32, starting from +0, and is rounded once to T, so the output is the
// first form's (one warp a row, four rows in flight) bit for bit.
//
// What bounds it on the H100: bytes. Each edge reads one C-wide row of src
// (256 bytes at C=128 in bf16) and does C adds, far below the card's
// operations-per-byte balance. With `idx` the gather of the node-factored
// GENConv backward (spmm_pallas.py:747-750: take(qo, csc_receivers) then
// this sum) happens inside the kernel, so the [E, C] gathered intermediate is
// never written; those rows come mostly from L2.
//
// Design, by the width of a row (`ops/spmm_cuda.py::k1_layout` and the
// wrapper's vector width pick it):
// - A row of at most 16 vector slots takes a lane group of w = slots lanes,
//   and a warp takes G = 32 / w rows, each group walking its own row
//   (`seg_sum_groups`). bf16 rows of C % 8 == 0 up to C=128 take 16-byte
//   loads (vec 8): C=128 is two rows a warp of 16 lanes, C=48 five of 6;
//   C=8 float32 is 16 rows a warp of 2 lanes, where one warp a row kept 2 of
//   32 lanes busy.
// - A wider row takes a whole warp whose lanes hold all of the row's vector
//   slots at once (S = 1, 2, 4 or 8 slots a lane, up to kMaxSlots), so C=392
//   and C=776 (8-byte bf16 loads) walk their edges once, not once per 128
//   channels (`seg_sum_warp`).
// - Each lane keeps up to kFlightGather (gathered form) or kFlightPlain
//   (plain form) edges' loads in flight, as many as fit in kLaneRegs
//   registers beside its sums, all issued before any is added, and the
//   walks are compiled for kMinBlocks blocks an SM (64 registers; a one-slot
//   walk takes about 40, so 6 blocks run).
// Missing edges of a batch load +0.0, which leaves the sum bit for bit as it
// was: a sum started at +0 is never -0, and x + (+0) is x for every other x.
// A hub row stays in one warp or lane group: splitting it would change the
// float32 order.
//
// Forms measured and dropped (one H100 80GB HBM3 at 700 W, `chip_smoke.py
// --kernel-forms=K1`, ms, bf16 unless said; PERF.md §6):
// - two edges a warp instruction at C=128 (16-byte loads, half a warp an
//   edge, the halves swapping four channels by shuffle to keep edge order):
//   gathered 0.129-0.137 (`time_fn`) against 0.113 for two rows a warp of
//   16 lanes;
// - a row's 32 indices in one load, handed out by shuffle: no gain in bf16
//   (0.1266 against 0.1264 with an index load an edge), a loss in float32
//   (0.338 against 0.325);
// - and the forms in this table, against the kept one (device ms at K1's
//   shapes; parent = the first form, one warp a row, 4 rows in flight,
//   timed in the same run by `--kernel-times`):
//
//   form                     gath   g f32  plain  lo392  lo776  lo48   lo8f32 blo128 blo256
//   kept                     0.1126 0.3139 0.2292 0.1759 0.3968 0.0395 0.0163 0.0388 0.0709
//   parent                   0.1240 0.3164 0.2296 0.2434 0.4744 0.0574 0.0296 0.0454 0.0741
//   8-byte bf16 loads        0.1342 -      0.2289 0.1756 0.3969 0.0473 -      0.0535 0.0709
//   16-byte bf16 up to C=256 0.1126 -      0.2291 0.1757 0.3966 0.0394 -      0.0388 0.0787
//   16-byte at every width   0.1126 -      0.2291 0.1913 0.4056 0.0394 -      0.0388 0.0786
//   2 edges in flight        0.1143 0.3173 0.2296 0.1988 0.3969 0.0505 0.0150 0.0397 0.0661
//   gathered: 8 in flight    0.1219 0.3116 0.2291 0.1757 0.3967 0.0394 0.0163 0.0521 0.0878
//   plain: 4 in flight       0.1126 0.3138 0.2298 0.1757 0.3968 0.0502 0.0149 0.0389 0.0709
//   32 registers a lane      0.1126 0.3137 0.2292 0.1987 0.3967 0.0426 0.0170 0.0389 0.0710
//   64 registers a lane      0.1126 0.3138 0.2291 0.2604 0.4617 0.0395 0.0164 0.0389 0.0709
//   6 blocks                 0.1127 0.3177 0.2305 0.4211 0.6814 0.0558 0.0184 0.0388 0.0710
//   8 blocks                 0.1164 0.3767 0.2347 0.6583 0.9764 0.0938 0.0227 0.0358 0.0862
//   128 channels a walk      0.1124 0.3138 0.2291 0.2259 0.4208 0.0393 0.0165 0.0388 0.0833
//   one warp a row           0.1635 0.3138 0.2316 0.1756 0.3970 0.0743 0.0416 0.0644 0.0709
//
//   No form wins everywhere: 2 edges in flight helps the band leftover at
//   C=256 and C=8, and loses 13 % at C=392; 8 blocks helps the band
//   leftover at C=128 and loses 2-4x on the wide rows.
//
// What still bounds it: the gathered C=128 bf16 form reads 650 MB of rows,
// mostly from L2 (5.8 TB/s at 0.112 ms); the plain form at C=128 is within
// 11 % of its byte bound; the narrow leftovers (2.3 edges a row) are held by
// each row's chain of dependent loads (pointers, index, rows).
#include "common.cuh"

namespace dgc {

constexpr int kLaneRegs = 48;        // registers a lane gives its sums and loads in flight
constexpr int kFlightGather = 4;     // edges a lane keeps in flight at most, gathered
constexpr int kFlightPlain = 8;      // and plain form
constexpr int kMaxSlots = 8;         // vector slots a lane holds in one walk
constexpr int kMinBlocks = 4;        // blocks an SM: at most 64 registers a thread

// One vector slot of a row as loaded (bf16 stays packed until it is added).
template <typename T, int VEC> struct Slot;

template <> struct Slot<float, 4> {
  using Raw = float4;
  __device__ __forceinline__ static Raw zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ __forceinline__ static Raw load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ static void add(float* acc, Raw v) {
    acc[0] += v.x; acc[1] += v.y; acc[2] += v.z; acc[3] += v.w;
  }
  __device__ __forceinline__ static void store(float* p, const float* acc) {
    Rows<float, 4>::store(p, acc);
  }
};

__device__ __forceinline__ void add_bf16x2(float* acc, uint32_t w) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
  acc[0] += f.x; acc[1] += f.y;
}

template <> struct Slot<__nv_bfloat16, 4> {
  using Raw = uint2;
  __device__ __forceinline__ static Raw zero() { return make_uint2(0u, 0u); }
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint2*>(p);
  }
  __device__ __forceinline__ static void add(float* acc, Raw v) {
    add_bf16x2(acc, v.x);
    add_bf16x2(acc + 2, v.y);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* acc) {
    Rows<__nv_bfloat16, 4>::store(p, acc);
  }
};

// 16-byte bf16 slots (C % 8 == 0, rows 16-byte aligned)
template <> struct Slot<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ __forceinline__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ __forceinline__ static Raw load(const __nv_bfloat16* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ __forceinline__ static void add(float* acc, Raw v) {
    add_bf16x2(acc, v.x);
    add_bf16x2(acc + 2, v.y);
    add_bf16x2(acc + 4, v.z);
    add_bf16x2(acc + 6, v.w);
  }
  __device__ __forceinline__ static void store(__nv_bfloat16* p, const float* acc) {
    Rows<__nv_bfloat16, 4>::store(p, acc);
    Rows<__nv_bfloat16, 4>::store(p + 4, acc + 4);
  }
};

template <typename T> struct Slot<T, 1> {
  using Raw = T;
  __device__ __forceinline__ static Raw zero() { return from_f32<T>(0.f); }
  __device__ __forceinline__ static Raw load(const T* p) { return *p; }
  __device__ __forceinline__ static void add(float* acc, Raw v) { acc[0] += to_f32(v); }
  __device__ __forceinline__ static void store(T* p, const float* acc) {
    p[0] = from_f32<T>(acc[0]);
  }
};

// Edges a lane keeps in flight when it holds S slots of VEC values: as many
// as fit in kLaneRegs registers beside its S * VEC sums, from 1 to
// kFlightGather in the gathered form (each row load waits on its index, the
// rows come from L2, and the short walks need the occupancy more) or
// kFlightPlain in the plain form (rows streamed from HBM, no index).
template <typename T, int VEC, int S, bool GATHER>
__host__ __device__ constexpr int edges_in_flight() {
  constexpr int raw = VEC * static_cast<int>(sizeof(T)) / 4 > 0
                          ? VEC * static_cast<int>(sizeof(T)) / 4 : 1;
  constexpr int u = (kLaneRegs - S * VEC) / (S * raw);
  constexpr int cap = GATHER ? kFlightGather : kFlightPlain;
  return u < 1 ? 1 : (u > cap ? cap : u);
}

// A whole warp a row; S vector slots a lane: slot s*32 + lane of each pass
// of 32*S slots (one pass unless the row is wider than 32*kMaxSlots slots).
template <typename T, int VEC, int S, bool GATHER>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocks)
seg_sum_warp(const T* __restrict__ src, const int* __restrict__ idx,
             const int* __restrict__ ptr, T* __restrict__ out, int n_rows, int C) {
  using V = Slot<T, VEC>;
  constexpr int U = edges_in_flight<T, VEC, S, GATHER>();
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;  // the whole warp
  const int start = ptr[row], end = ptr[row + 1];
  const int n_slots = C / VEC;
  for (int base = 0; base < n_slots; base += 32 * S) {
    float acc[S][VEC];
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[s][k] = 0.f;
    for (int e = start; e < end; e += U) {
      typename V::Raw v[U][S];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const bool live = e + u < end;
        const long long r = !live ? 0 : (GATHER ? idx[e + u] : e + u);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const int slot = base + s * 32 + lane;
          v[u][s] = (live && slot < n_slots) ? V::load(src + r * C + slot * VEC) : V::zero();
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int s = 0; s < S; ++s) V::add(acc[s], v[u][s]);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int slot = base + s * 32 + lane;
      if (slot < n_slots) V::store(out + (long long)row * C + slot * VEC, acc[s]);
    }
  }
}

// Lane groups over rows: a warp takes G rows, w lanes (one vector slot each,
// w = the row's slots) a row; each group walks its own row.
template <typename T, int VEC, bool GATHER>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocks)
seg_sum_groups(const T* __restrict__ src, const int* __restrict__ idx,
               const int* __restrict__ ptr, T* __restrict__ out, int n_rows, int C,
               int w, int G) {
  using V = Slot<T, VEC>;
  constexpr int U = edges_in_flight<T, VEC, 1, GATHER>();
  const int lane = threadIdx.x & 31;
  const int grp = lane / w, j = lane - grp * w;
  const int row = (blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5)) * G + grp;
  if (grp >= G || row >= n_rows) return;
  const int start = ptr[row], end = ptr[row + 1];
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int e = start; e < end; e += U) {
    typename V::Raw v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (e + u < end) {
        const long long r = GATHER ? idx[e + u] : (e + u);
        v[u] = V::load(src + r * C + j * VEC);
      } else {
        v[u] = V::zero();
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) V::add(acc, v[u]);
  }
  V::store(out + (long long)row * C + j * VEC, acc);
}

template <typename T, int VEC, bool GATHER>
void launch_form(const T* src, const int* idx, const int* ptr, T* out, int n_rows, int C,
                 int w, int G, cudaStream_t s) {
  const dim3 block(kWarpsPerBlock * 32);
  if (G > 1) {
    const int rows_a_block = kWarpsPerBlock * G;
    const dim3 grid((n_rows + rows_a_block - 1) / rows_a_block);
    seg_sum_groups<T, VEC, GATHER><<<grid, block, 0, s>>>(src, idx, ptr, out, n_rows, C, w,
                                                           G);
    return;
  }
  const dim3 grid(blocks_for_rows(n_rows));
  const int per_lane = (C / VEC + 31) / 32;
  if (per_lane <= 1 || kMaxSlots == 1) {
    seg_sum_warp<T, VEC, 1, GATHER><<<grid, block, 0, s>>>(src, idx, ptr, out, n_rows, C);
  } else if (per_lane <= 2 || kMaxSlots == 2) {
    seg_sum_warp<T, VEC, 2, GATHER><<<grid, block, 0, s>>>(src, idx, ptr, out, n_rows, C);
  } else if (per_lane <= 4 || kMaxSlots == 4) {
    seg_sum_warp<T, VEC, 4, GATHER><<<grid, block, 0, s>>>(src, idx, ptr, out, n_rows, C);
  } else {
    seg_sum_warp<T, VEC, 8, GATHER><<<grid, block, 0, s>>>(src, idx, ptr, out, n_rows, C);
  }
}

template <typename T, int VEC>
void launch_vec(const T* src, const int* idx, const int* ptr, T* out, int n_rows, int C,
                int w, int G, cudaStream_t s) {
  if (idx != nullptr) {
    launch_form<T, VEC, true>(src, idx, ptr, out, n_rows, C, w, G, s);
  } else {
    launch_form<T, VEC, false>(src, idx, ptr, out, n_rows, C, w, G, s);
  }
}

template <typename T>
int launch_seg_sum(const void* src_, const void* idx_, const void* ptr_, void* out_,
                   int n_rows, int C, int vec, int w, int G, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* idx = static_cast<const int*>(idx_);
  const int* ptr = static_cast<const int*>(ptr_);
  if (vec == 8) {  // bf16 only (the wrapper's choice)
    launch_vec<__nv_bfloat16, 8>(static_cast<const __nv_bfloat16*>(src_), idx, ptr,
                                 static_cast<__nv_bfloat16*>(out_), n_rows, C, w, G, s);
  } else if (vec == 4) {
    launch_vec<T, 4>(static_cast<const T*>(src_), idx, ptr, static_cast<T*>(out_), n_rows, C,
                     w, G, s);
  } else {
    launch_vec<T, 1>(static_cast<const T*>(src_), idx, ptr, static_cast<T*>(out_), n_rows, C,
                     w, G, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dgc

// Plain C interface for ctypes. `idx` may be null (no gather). `vec` is 4
// when C % 4 == 0 and every row start is 16-byte aligned (8 for the bf16
// rows of C % 8 == 0 up to `K1_WIDE_LOADS_MAX_C`: 16-byte loads), else 1;
// (w, G) is `k1_layout(C, vec)`: G rows a warp of w lanes each when G > 1.
// Returns cudaGetLastError() after the launch.
extern "C" int dgc_seg_sum_f32(const void* src, const void* idx, const void* ptr,
                               void* out, int n_rows, int C, int vec, int w, int G,
                               void* stream) {
  return dgc::launch_seg_sum<float>(src, idx, ptr, out, n_rows, C, vec, w, G, stream);
}

extern "C" int dgc_seg_sum_bf16(const void* src, const void* idx, const void* ptr,
                                void* out, int n_rows, int C, int vec, int w, int G,
                                void* stream) {
  return dgc::launch_seg_sum<__nv_bfloat16>(src, idx, ptr, out, n_rows, C, vec, w, G,
                                            stream);
}

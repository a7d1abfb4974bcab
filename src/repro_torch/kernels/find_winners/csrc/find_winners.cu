// Find Winners on Hopper: for each signal, the two nearest active units.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/find_winners/kernel.py::_find_winners_kernel, which
// forms all distances of a (signal tile x unit tile) block with one MXU
// product and keeps a streaming top-2 in its resident output block.
//
// The distance is the TPU kernel's expansion,
//     d2 = max(|x|^2 - 2 x.w + |w|^2, 0) + (inactive ? 1e30 : 0),
// as a float32 FMA scan: a tensor-core product would round x.w to TF32
// and flip near-tie winners. Ties go to the lowest id.
//
// What bounds it. A growing pool is mostly empty (about 300 of 4096
// slots active on the main path, 228 of 32768 in the paper's
// configuration), and an inactive unit is in a top-2 only when fewer
// than two units are active. The work is 8 flops per (signal, active
// unit) pair: at M = 8192 signals and 300 units 20 MFLOP, 0.3 us of the
// card's FP32 peak, while the bytes (signals, active rows, flags,
// outputs, ~0.25 MB) take under 0.1 us; a dense pool (16384 of 32768
// active) is 1.07 GFLOP, 16 us. Operations bound both. At the main
// path's size what costs is latency: the launches, and each round trip
// to memory between reading the flags and the first distance.
//
// Two launches from one call:
//
// Launch 1 (fw_compact_kernel, one block of 1024 threads per network)
// reads every flag once and packs the active units in id order: row p
// of the packed table holds unit ids[p]'s weights and |w|^2 in the pad
// lane, Dp = round_up(d + 1, 4) floats (one 16-byte float4 at d = 3),
// and count[b] is the number of rows. Each thread owns up to 32
// consecutive flags as a bit mask; a block-wide scan of the masks'
// popcounts gives every active unit its row; then the rows are dealt to
// the threads evenly (a thread owns the flags of a crowded stretch of
// low ids, where a growing pool puts its units), each loading its rows'
// weights together. |w|^2 is summed in k order with __fadd_rn /
// __fmul_rn.
//
// Launch 2 (fw_scan_kernel) goes out with programmatic dependent launch:
// launch 1 lets it start at once (griddepcontrol), so its blocks load
// their signals and |x|^2 while the packing runs, then wait for the
// table. A block stages the first count rows and their ids in tiles of
// T rows (16-byte cp.async, double-buffered; ~300 units are one tile)
// and its threads split each tile's rows into partitions. A partition
// scans its rows upward for the block's signals, four rows in flight,
// with a top-2 in registers; rows are in id order, so a strict `<` keeps
// the lowest id among equal distances, and the partial top-2s are merged
// in (distance, id) order, by warp shuffles and then in shared memory.
// A row's id is read (from the staged ids) only when it enters a top-2.
// Two regimes, which the wrapper picks from the shapes:
//  - many signals (the main path, fleets, the paper's configuration):
//    32 signals per block, one per lane; the 8 warps are the partitions,
//    so a warp reads one row per step as a shared-memory broadcast;
//  - few signals (m = 1 in `single`, small waves): one signal per block,
//    and each of its 256 threads is a partition, so the units of one
//    signal are scanned by 256 threads, not by one lane.
// A pool with fewer than two active units is scanned unit by unit from w
// and the flags instead, inactive units biased by 1e30, as the TPU
// kernel does; rows are then ids.
//
// Each pair's distance is computed as in the one-launch kernel this
// design replaced (fmaf in k order, then
// fmaxf(__fadd_rn(__fsub_rn(x2, 2.f * xw), w2), 0.f)), and the result is
// the exact (distance, id) top-2 however the units are split, so it is
// bitwise that kernel's. No float atomics: every call is repeatable.
//
// Inputs and outputs carry a leading batch axis B (one network per
// row), so a fleet of networks is one call.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCompactThreads = 1024;   // launch 1: threads per network
constexpr int kMaxFlags = 32;           // flags a thread owns per round
constexpr int kThreads = 256;           // launch 2: threads per block
constexpr int kWarps = kThreads / 32;
constexpr float kLarge = 1e30f;
constexpr int kNone = 0x7fffffff;
constexpr unsigned kAll = 0xffffffffu;
constexpr int kGroup = 4;               // launch 1: rows loaded at once
constexpr int kFew = 1;                 // regime 1 of kernel.py; 0 is many

__host__ __device__ constexpr int padded(int D) { return (D + 4) / 4 * 4; }

// rows per staged tile: 8 KB of rows per buffer at Dp = 4 and 8, 6 KB at 12
__host__ __device__ constexpr int tile_rows(int Dp) {
  return Dp == 4 ? 512 : Dp == 8 ? 256 : 128;
}

// ids of one network: C rounded up to whole 16-byte chunks
__host__ __device__ constexpr int id_stride(int C) { return (C + 3) / 4 * 4; }

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

__device__ __forceinline__ void allow_dependent_launch() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
#endif
}

__device__ __forceinline__ void wait_for_primary_grid() {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900
  asm volatile("griddepcontrol.wait;" ::: "memory");
#endif
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

struct Top2 {
  float d1, d2;
  int i1, i2;   // rows of the packed table (ids when scanning every unit)
};

// (distance, row) order: the lower row, so the lower id, wins a tie.
__device__ __forceinline__ bool before(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

__device__ __forceinline__ void merge(Top2& t, float d, int i) {
  if (before(d, i, t.d1, t.i1)) {
    t.d2 = t.d1;
    t.i2 = t.i1;
    t.d1 = d;
    t.i1 = i;
  } else if (before(d, i, t.d2, t.i2)) {
    t.d2 = d;
    t.i2 = i;
  }
}

// Unit i, scanned after every unit t holds, with d < t.d2 (d1 <= d2
// always, so no other d changes t): a strict `<` keeps the earlier, lower
// id on a tie.
__device__ __forceinline__ void push(Top2& t, float d, int i) {
  if (d < t.d1) {
    t.d2 = t.d1;
    t.i2 = t.i1;
    t.d1 = d;
    t.i1 = i;
  } else {
    t.d2 = d;
    t.i2 = i;
  }
}

template <int D, int N>
__device__ __forceinline__ float distance(const float (&xv)[D], float x2,
                                          const float (&wv)[N], float w2) {
  float xw = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) xw = fmaf(xv[k], wv[k], xw);
  return fmaxf(__fadd_rn(__fsub_rn(x2, 2.f * xw), w2), 0.f);
}

// Launch 1: pack network blockIdx.x's active units in id order. With
// vec (C % 4 == 0 and act 4-byte aligned) a thread reads its flags as
// 32-bit words; all its loads are issued before any is used.
template <int D>
__global__ void __launch_bounds__(kCompactThreads)
fw_compact_kernel(const float* __restrict__ w,
                  const uint8_t* __restrict__ act,
                  float* __restrict__ packed, int* __restrict__ ids,
                  int* __restrict__ count, int C, int vec) {
  constexpr int Dp = padded(D);
  allow_dependent_launch();   // the scan may launch and load its signals
  __shared__ int warp_sum[kCompactThreads / 32];
  __shared__ int first[kCompactThreads];         // each thread's first row
  __shared__ unsigned flags[kCompactThreads];    // and its flags' bits
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  w += (size_t)b * C * D;
  act += (size_t)b * C;
  packed += (size_t)b * C * Dp;
  ids += (size_t)b * id_stride(C);

  // flags per thread and round: a multiple of 4 (whole words), <= 32
  constexpr int kWord = 4 * kCompactThreads;
  const int per = min(kMaxFlags, (C + kWord - 1) / kWord * 4);
  int base = 0;   // rows packed by earlier rounds
  for (int c0 = 0; c0 < C; c0 += per * kCompactThreads) {
    const int lo = c0 + tid * per;
    unsigned bits = 0;
    if (vec) {
      unsigned word[kMaxFlags / 4];
#pragma unroll
      for (int q = 0; q < kMaxFlags / 4; ++q)
        word[q] = 4 * q < per && lo + 4 * q < C
                      ? *reinterpret_cast<const unsigned*>(act + lo + 4 * q)
                      : 0u;
#pragma unroll
      for (int q = 0; q < kMaxFlags / 4; ++q)   // byte j != 0 -> bit j
        bits |= ((__vcmpne4(word[q], 0u) & 0x08040201u) * 0x01010101u >> 24)
                << (4 * q);
    } else {
      uint8_t f[kMaxFlags];
#pragma unroll
      for (int k = 0; k < kMaxFlags; ++k)
        f[k] = k < per && lo + k < C ? act[lo + k] : 0;
#pragma unroll
      for (int k = 0; k < kMaxFlags; ++k) bits |= unsigned(f[k] != 0) << k;
    }
    const int mine = __popc(bits);
    int incl = mine;   // inclusive scan over the warp, then over warps
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kAll, incl, o);
      if (lane >= o) incl += v;
    }
    if (lane == 31) warp_sum[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int s = warp_sum[lane];
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(kAll, s, o);
        if (lane >= o) s += v;
      }
      warp_sum[lane] = s;
    }
    __syncthreads();
    first[tid] = (warp ? warp_sum[warp - 1] : 0) + incl - mine;
    flags[tid] = bits;
    const int total = warp_sum[kCompactThreads / 32 - 1];
    __syncthreads();
    // Rows go to threads evenly, kGroup per thread at a time with their
    // loads together: row j belongs to the last thread o whose first row
    // is <= j (a binary search of first[]), as the bit of flags[o] that
    // is its (j - first[o])-th set bit.
    for (int j0 = 0; j0 < total; j0 += kGroup * kCompactThreads) {
      int c[kGroup];
      float v[kGroup][Dp];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int j = j0 + g * kCompactThreads + tid;
        c[g] = -1;
        if (j < total) {
          int o = 0;
#pragma unroll
          for (int step = kCompactThreads / 2; step > 0; step >>= 1)
            if (first[o + step] <= j) o += step;
          unsigned f = flags[o];
          for (int k = first[o]; k < j; ++k) f &= f - 1;
          c[g] = c0 + o * per + __ffs(f) - 1;
        }
#pragma unroll
        for (int k = 0; k < D; ++k)
          v[g][k] = c[g] >= 0 ? w[(size_t)c[g] * D + k] : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        if (c[g] < 0) break;
        float sq = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k)
          sq = __fadd_rn(sq, __fmul_rn(v[g][k], v[g][k]));
        v[g][D] = sq;
#pragma unroll
        for (int k = D + 1; k < Dp; ++k) v[g][k] = 0.f;
        const int row = base + j0 + g * kCompactThreads + tid;
        float4* dst = reinterpret_cast<float4*>(packed + (size_t)row * Dp);
#pragma unroll
        for (int q = 0; q < Dp / 4; ++q)
          dst[q] = make_float4(v[g][4 * q], v[g][4 * q + 1], v[g][4 * q + 2],
                               v[g][4 * q + 3]);
        ids[row] = c[g];
      }
    }
    base += total;
    __syncthreads();   // warp_sum, first and flags are rewritten
  }
  if (tid == 0) count[b] = base;
}

// Launch 2: the block's signals against the packed rows of network
// blockIdx.y. L signal lanes per warp (32: many signals, 1: few); the
// kThreads / L partitions split the rows.
template <int D, int L>
__global__ void __launch_bounds__(kThreads)
fw_scan_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const uint8_t* __restrict__ act,
               const float* __restrict__ packed,
               const int* __restrict__ ids, const int* __restrict__ count,
               float* __restrict__ out_d, int* __restrict__ out_i, int M,
               int C) {
  constexpr int Dp = padded(D);
  constexpr int T = tile_rows(Dp);
  constexpr int P = kThreads / L;   // partitions
  __shared__ __align__(16) float tile[2][T * Dp];
  __shared__ __align__(16) int tile_id[2][T];
  __shared__ Top2 part[kWarps][L];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int sl = lane % L;   // signal lane
  const int p = tid / L;     // partition
  x += (size_t)b * M * D;
  packed += (size_t)b * C * Dp;
  ids += (size_t)b * id_stride(C);

  // the prologue, overlapping launch 1: the signal and |x|^2
  const int m = blockIdx.x * L + sl;
  float xv[D];
  float x2 = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    xv[k] = m < M ? x[(size_t)m * D + k] : 0.f;
    x2 = __fadd_rn(x2, __fmul_rn(xv[k], xv[k]));
  }
  Top2 t{INFINITY, INFINITY, kNone, kNone};

  // rows [k T, k T + rows) of the packed table and their ids, to buffer
  // k & 1, as one cp.async group
  auto stage = [&](int k, int rows) {
    const float* src = packed + (size_t)k * T * Dp;
    for (int q = tid; q < rows * (Dp / 4); q += kThreads)
      cp_async16(&tile[k & 1][q * 4], src + q * 4);
    for (int q = tid; q < (rows + 3) / 4; q += kThreads)
      cp_async16(&tile_id[k & 1][q * 4], ids + (size_t)k * T + q * 4);
    cp_async_commit();
  };

  wait_for_primary_grid();
  const int n = count[b];
  if (n >= 2) {
    const int tiles = (n + T - 1) / T;
    stage(0, min(T, n));
    for (int k = 0; k < tiles; ++k) {
      if (k + 1 < tiles) {
        stage(k + 1, min(T, n - (k + 1) * T));
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* tb = tile[k & 1];
      const int* row_id = tile_id[k & 1];
      const int nr = min(T, n - k * T);
      auto load = [&](int r, float (&wv)[Dp]) {
        const float4* src = reinterpret_cast<const float4*>(tb + r * Dp);
#pragma unroll
        for (int q = 0; q < Dp / 4; ++q) {
          const float4 v = src[q];
          wv[4 * q] = v.x;
          wv[4 * q + 1] = v.y;
          wv[4 * q + 2] = v.z;
          wv[4 * q + 3] = v.w;
        }
      };
      int r = p;
      for (; r + 3 * P < nr; r += 4 * P) {   // four rows in flight
        float d[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float wv[Dp];
          load(r + j * P, wv);
          d[j] = distance<D>(xv, x2, wv, wv[D]);
        }
        // one compare for the four rows: most rows change nothing
        if (fminf(fminf(d[0], d[1]), fminf(d[2], d[3])) < t.d2) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (d[j] < t.d2) push(t, d[j], row_id[r + j * P]);
        }
      }
      for (; r < nr; r += P) {
        float wv[Dp];
        load(r, wv);
        const float d = distance<D>(xv, x2, wv, wv[D]);
        if (d < t.d2) push(t, d, row_id[r]);
      }
      __syncthreads();   // the next stage overwrites this buffer
    }
  } else {
    // fewer than two active units: every unit, inactive ones + 1e30
    const float* wb = w + (size_t)b * C * D;
    const uint8_t* ab = act + (size_t)b * C;
    for (int c = p; c < C; c += P) {
      float wv[D];
      float sq = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        wv[k] = wb[(size_t)c * D + k];
        sq = __fadd_rn(sq, __fmul_rn(wv[k], wv[k]));
      }
      const float d = distance<D>(xv, x2, wv, sq) + (ab[c] ? 0.f : kLarge);
      if (d < t.d2) push(t, d, c);
    }
  }

  // merge the partitions: lanes of a warp that share a signal, then warps
#pragma unroll
  for (int o = L; o < 32; o <<= 1) {
    const float d1 = __shfl_xor_sync(kAll, t.d1, o);
    const float d2 = __shfl_xor_sync(kAll, t.d2, o);
    const int i1 = __shfl_xor_sync(kAll, t.i1, o);
    const int i2 = __shfl_xor_sync(kAll, t.i2, o);
    merge(t, d1, i1);
    merge(t, d2, i2);
  }
  if (lane < L) part[warp][sl] = t;
  __syncthreads();
  if (tid >= L || m >= M) return;
  Top2 r = part[0][sl];
#pragma unroll
  for (int k = 1; k < kWarps; ++k) {
    merge(r, part[k][sl].d1, part[k][sl].i1);
    merge(r, part[k][sl].d2, part[k][sl].i2);
  }
  const size_t o = (size_t)b * M + m;
  reinterpret_cast<float2*>(out_d)[o] = make_float2(r.d1, r.d2);
  reinterpret_cast<int2*>(out_i)[o] = make_int2(r.i1, r.i2);
}

// The workspace: packed (B, C, Dp) f32, then ids (B, id_stride(C)) i32
// (rows of whole 16-byte chunks), then count (B,) i32.
struct Workspace {
  float* packed;
  int* ids;
  int* count;
};

Workspace split(void* ws, int B, int C, int Dp) {
  float* packed = static_cast<float*>(ws);
  int* ids = reinterpret_cast<int*>(packed + (size_t)B * C * Dp);
  return Workspace{packed, ids, ids + (size_t)B * id_stride(C)};
}

template <int D>
cudaError_t launch_compact(const float* w, const uint8_t* act, Workspace s,
                           int B, int C, cudaStream_t stream) {
  const int vec = C % 4 == 0 &&
                  (reinterpret_cast<uintptr_t>(act) & 3u) == 0;
  fw_compact_kernel<D><<<B, kCompactThreads, 0, stream>>>(
      w, act, s.packed, s.ids, s.count, C, vec);
  return cudaGetLastError();
}

template <int D, int L>
cudaError_t launch_scan(const float* x, const float* w, const uint8_t* act,
                        Workspace s, float* out_d, int* out_i, int B, int M,
                        int C, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((M + L - 1) / L), B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, fw_scan_kernel<D, L>, x, w, act,
                            (const float*)s.packed, (const int*)s.ids,
                            (const int*)s.count, out_d, out_i, M, C);
}

template <int D>
cudaError_t launch(const float* x, const float* w, const uint8_t* act,
                   float* out_d, int* out_i, void* ws, int B, int M, int C,
                   int regime, cudaStream_t stream) {
  const Workspace s = split(ws, B, C, padded(D));
  const cudaError_t e = launch_compact<D>(w, act, s, B, C, stream);
  if (e != cudaSuccess) return e;
  if (regime == kFew)
    return launch_scan<D, 1>(x, w, act, s, out_d, out_i, B, M, C, stream);
  return launch_scan<D, 32>(x, w, act, s, out_d, out_i, B, M, C, stream);
}

int finish(cudaError_t r) {
  if (r != cudaSuccess) {
    cudaGetLastError();   // clear the error a failed launch left
    return (int)r;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// signals (B, M, D) f32, w (B, C, D) f32, active (B, C) bool as bytes,
// ws a 16-byte aligned workspace of B * (C * Dp + round_up(C, 4) + 1)
// 32-bit words (Dp = round_up(D + 1, 4)), regime 0 (many signals) or 1
// (few)
// -> out_d (B, M, 2) f32, out_i (B, M, 2) i32. Two launches (the packing,
// then the scan with programmatic dependent launch). Returns
// cudaGetLastError().
extern "C" int repro_find_winners(const float* x, const float* w,
                                  const uint8_t* act, float* out_d,
                                  int* out_i, void* ws, int B, int M, int C,
                                  int D, int regime, cudaStream_t stream) {
  if (B < 1 || M < 1 || C < 1 || !aligned16(ws) || regime < 0 || regime > 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t r = cudaErrorInvalidValue;
  switch (D) {
#define REPRO_FW(DD)                                                    \
  case DD:                                                              \
    r = launch<DD>(x, w, act, out_d, out_i, ws, B, M, C, regime, stream); \
    break;
    REPRO_FW(1) REPRO_FW(2) REPRO_FW(3) REPRO_FW(4)
    REPRO_FW(5) REPRO_FW(6) REPRO_FW(7) REPRO_FW(8)
#undef REPRO_FW
    default: return (int)cudaErrorInvalidValue;
  }
  return finish(r);
}

// Launch 1 alone, for the tests: w (B, C, D) f32, active (B, C) bool ->
// the workspace's packed table, ids and count (rows past count are not
// written). Returns cudaGetLastError().
extern "C" int repro_compact_active(const float* w, const uint8_t* act,
                                    void* ws, int B, int C, int D,
                                    cudaStream_t stream) {
  if (B < 1 || C < 1 || !aligned16(ws)) return (int)cudaErrorInvalidValue;
  cudaError_t r = cudaErrorInvalidValue;
  switch (D) {
#define REPRO_FW(DD)                                             \
  case DD:                                                       \
    r = launch_compact<DD>(w, act, split(ws, B, C, padded(DD)), B, \
                           C, stream);                           \
    break;
    REPRO_FW(1) REPRO_FW(2) REPRO_FW(3) REPRO_FW(4)
    REPRO_FW(5) REPRO_FW(6) REPRO_FW(7) REPRO_FW(8)
#undef REPRO_FW
    default: return (int)cudaErrorInvalidValue;
  }
  return finish(r);
}

// Find Winners on Hopper: for each signal, the two nearest active units.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/find_winners/kernel.py::_find_winners_kernel, which
// forms all distances of a (signal tile x unit tile) block with one MXU
// product and keeps a streaming top-2 in its resident output block.
//
// Here the design is the paper's own CUDA one: one signal per lane, unit
// tiles of w staged in shared memory, a top-2 kept in registers. The
// distance is the same expansion as the TPU kernel,
//     d2 = max(|x|^2 - 2 x.w + |w|^2, 0) + (inactive ? 1e30 : 0),
// as a float32 FMA scan: a tensor-core product would round x.w to TF32
// and flip near-tie winners.
//
// Layout of one block: 32 signals (one per lane) x 8 warps. A growing
// pool is mostly empty (about 300 of 4096 slots active on the main
// path), so each tile is compacted while it is staged: warp ballots over
// the active flags give every active unit its place, in id order, and
// only those units are scanned. Every warp scans its own eighth of the
// staged units for the same 32 signals, so all lanes of a warp read the
// same unit (a shared-memory broadcast) and the block has 8 independent
// scans in flight. Ids grow along each warp's scan, so a strict `<`
// keeps the lowest id among equal distances; the 8 partial top-2s are
// then merged in (distance, id) order, which keeps that rule across
// warps. Only a pool with fewer than two active units has an inactive
// unit in a top-2; the block then scans every unit, as the TPU kernel
// does.
//
// Bound at the main path's shapes (M = 8192 signals, n_active active
// units of C = 4096, d = 3): 8 flops per (signal, active unit) pair,
// 20 MFLOP at 300 units, 0.3 us of the card's FP32 peak; the bytes
// (signals, active rows, the flags and the outputs, about 0.25 MB) take
// under 0.1 us. At this size the launch and the staging of every tile
// by each of the 256 blocks cost more than the scan.
//
// Inputs and outputs carry a leading batch axis B (one network per
// row), so a fleet of networks is one launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSigs = 32;      // signals per block, one per lane
constexpr int kSlices = 8;     // warps per block, each scans a slice
constexpr int kTile = 512;     // units staged per tile (32 KB at most)
constexpr int kPerWarp = kTile / kSlices;   // units each warp stages
constexpr float kLarge = 1e30f;
constexpr unsigned kAll = 0xffffffffu;

struct Top2 {
  float d1, d2;
  int i1, i2;
};

// (distance, id) order: the lower id wins a tie.
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

struct Stage {
  float* w;      // (kTile, D) staged unit rows, in id order
  float* w2;     // (kTile,) |w|^2
  float* bias;   // (kTile,) 0 or kLarge
  int* id;       // (kTile,) unit ids
  int* count;    // (kSlices,) units staged by each warp
};

// One pass over the pool for this block's 32 signals. With all_units
// false only active units are staged (compacted, in id order) and
// scanned; with it true every unit is, inactive ones biased by kLarge.
// Returns the number of units scanned, the same in every thread.
template <int D>
__device__ int scan(const float* __restrict__ w,
                    const uint8_t* __restrict__ act, int C, bool all_units,
                    const float (&xv)[D], float x2, Stage s, Top2& t) {
  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  int scanned = 0;
  for (int c0 = 0; c0 < C; c0 += kTile) {
    const int n = min(kTile, C - c0);
    // ballot which of this warp's kPerWarp units are staged
    unsigned take[kPerWarp / 32];
    int mine = 0;
#pragma unroll
    for (int r = 0; r < kPerWarp / 32; ++r) {
      const int u = slice * kPerWarp + r * 32 + lane;
      take[r] = __ballot_sync(kAll, u < n && (all_units || act[c0 + u]));
      mine += __popc(take[r]);
    }
    __syncthreads();  // the previous tile is no longer read
    if (lane == 0) s.count[slice] = mine;
    __syncthreads();
    int pos = 0, total = 0;
#pragma unroll
    for (int k = 0; k < kSlices; ++k) {
      pos += k < slice ? s.count[k] : 0;
      total += s.count[k];
    }
#pragma unroll
    for (int r = 0; r < kPerWarp / 32; ++r) {
      if ((take[r] >> lane) & 1u) {
        const int u = slice * kPerWarp + r * 32 + lane;
        const int at = pos + __popc(take[r] & ((1u << lane) - 1u));
        const float* wu = w + (size_t)(c0 + u) * D;
        float sq = 0.f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float v = wu[k];
          s.w[at * D + k] = v;
          sq = __fadd_rn(sq, __fmul_rn(v, v));
        }
        s.w2[at] = sq;
        s.bias[at] = act[c0 + u] ? 0.f : kLarge;
        s.id[at] = c0 + u;
      }
      pos += __popc(take[r]);
    }
    __syncthreads();
    scanned += total;
    // each warp scans a contiguous slice of the staged units, ids upward
    const int per = (total + kSlices - 1) / kSlices;
    const int lo = slice * per;
    const int hi = min(total, lo + per);
    for (int j = lo; j < hi; ++j) {
      float xw = 0.f;
#pragma unroll
      for (int k = 0; k < D; ++k) xw = fmaf(xv[k], s.w[j * D + k], xw);
      const float d =
          fmaxf(__fadd_rn(__fsub_rn(x2, 2.f * xw), s.w2[j]), 0.f) + s.bias[j];
      if (d < t.d1) {
        t.d2 = t.d1;
        t.i2 = t.i1;
        t.d1 = d;
        t.i1 = s.id[j];
      } else if (d < t.d2) {
        t.d2 = d;
        t.i2 = s.id[j];
      }
    }
  }
  return scanned;
}

template <int D>
__global__ void __launch_bounds__(kSigs * kSlices)
find_winners_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    const uint8_t* __restrict__ act,
                    float* __restrict__ out_d, int* __restrict__ out_i,
                    int M, int C) {
  __shared__ float w_s[kTile * D];
  __shared__ float w2_s[kTile];
  __shared__ float bias_s[kTile];
  __shared__ int id_s[kTile];
  __shared__ int count_s[kSlices];
  __shared__ Top2 part[kSlices][kSigs];

  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int m = blockIdx.x * kSigs + lane;
  x += (size_t)b * M * D;
  w += (size_t)b * C * D;
  act += (size_t)b * C;

  float xv[D];
  float x2 = 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    xv[k] = m < M ? x[(size_t)m * D + k] : 0.f;
    x2 = __fadd_rn(x2, __fmul_rn(xv[k], xv[k]));
  }

  const Stage s{w_s, w2_s, bias_s, id_s, count_s};
  const Top2 none{INFINITY, INFINITY, 0x7fffffff, 0x7fffffff};
  Top2 t = none;
  // An inactive unit (distance + 1e30) is in a top-2 only when the pool
  // has fewer than two active units: then scan every unit, as the TPU
  // kernel does.
  if (scan<D>(w, act, C, false, xv, x2, s, t) < 2) {
    t = none;
    scan<D>(w, act, C, true, xv, x2, s, t);
  }
  part[slice][lane] = t;
  __syncthreads();
  if (slice != 0 || m >= M) return;
  Top2 r = part[0][lane];
#pragma unroll
  for (int k = 1; k < kSlices; ++k) {
    merge(r, part[k][lane].d1, part[k][lane].i1);
    merge(r, part[k][lane].d2, part[k][lane].i2);
  }
  const size_t o = ((size_t)b * M + m) * 2;
  out_d[o] = r.d1;
  out_d[o + 1] = r.d2;
  out_i[o] = r.i1;
  out_i[o + 1] = r.i2;
}

template <int D>
void launch(const float* x, const float* w, const uint8_t* act, float* out_d,
            int* out_i, int B, int M, int C, cudaStream_t stream) {
  const dim3 grid((M + kSigs - 1) / kSigs, B);
  find_winners_kernel<D>
      <<<grid, kSigs * kSlices, 0, stream>>>(x, w, act, out_d, out_i, M, C);
}

}  // namespace

// signals (B, M, D) f32, w (B, C, D) f32, active (B, C) bool as bytes
// -> out_d (B, M, 2) f32, out_i (B, M, 2) i32. Returns cudaGetLastError().
extern "C" int repro_find_winners(const float* x, const float* w,
                                  const uint8_t* act, float* out_d,
                                  int* out_i, int B, int M, int C, int D,
                                  cudaStream_t stream) {
  if (B < 1 || M < 1 || C < 1) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 1: launch<1>(x, w, act, out_d, out_i, B, M, C, stream); break;
    case 2: launch<2>(x, w, act, out_d, out_i, B, M, C, stream); break;
    case 3: launch<3>(x, w, act, out_d, out_i, B, M, C, stream); break;
    case 4: launch<4>(x, w, act, out_d, out_i, B, M, C, stream); break;
    case 5: launch<5>(x, w, act, out_d, out_i, B, M, C, stream); break;
    case 6: launch<6>(x, w, act, out_d, out_i, B, M, C, stream); break;
    case 7: launch<7>(x, w, act, out_d, out_i, B, M, C, stream); break;
    case 8: launch<8>(x, w, act, out_d, out_i, B, M, C, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

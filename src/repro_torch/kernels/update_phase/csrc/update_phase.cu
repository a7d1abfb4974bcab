// The dense Update phase on Hopper: winner lock, per-unit accumulators
// and edge aging. Three entry points, one per Pallas TPU kernel of
// src/repro/kernels/update_phase/kernel.py. Every array carries a leading
// batch axis B (one network per row), so a fleet is one launch.
//
// The TPU kernels turn the GPU's atomic scatters into one-hot products on
// the MXU. On this card the scatters come back, in forms that are
// deterministic: an integer atomicMin for the lock (min commutes), and a
// gather walk with a fixed order for the float sums (no float atomics),
// so that a run repeats bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBigPrio = 0x7fffffff;

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

__global__ void fill_i32(int* __restrict__ p, int v, long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n) p[e] = v;
}

// ---------------------------------------------------------------------------
// B2. Winner lock. Replaces _lock_kernel (kernel.py:68): for each unit,
// the minimum priority over the signals that it won; kBigPrio where none
// did. Masked rows carry kBigPrio and are skipped. Bound: 8 bytes a signal
// in and 4 a unit out (about 0.08 MB at M = 8192, C = 4096), so
// launch-bound; one thread per signal, one atomicMin each.

__global__ void lock_kernel(const int* __restrict__ wid,
                            const int* __restrict__ prio,
                            int* __restrict__ best, int M, int C) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int p = prio[(size_t)b * M + i];
  const int c = wid[(size_t)b * M + i];
  if (p == kBigPrio || c < 0 || c >= C) return;
  atomicMin(&best[(size_t)b * C + c], p);
}

// ---------------------------------------------------------------------------
// B3. Per-unit accumulators. Replaces _update_accum_kernel (kernel.py:124).
//
// After the lock each winner has exactly one selected signal, its owner.
// Pass 1 marks owner[c] (no two selected signals share a winner, so the
// writes never collide). Pass 2 runs one thread per unit c:
//   * winner fields from its own owner o: w1 = w + scale_b[o] (x_o - w)
//     if o adapts (a copy, not a sum), err = d2b[o], dec_b = dec_b[o],
//     the winner indicator;
//   * neighbor sums by walking its own row nbr[c]: for each neighbor b
//     whose owner o adapts, find c's slot j in nbr[b] and add scale_n[o,j],
//     scale_n[o,j] x_o and dec_n[o,j].
// The walk relies on the symmetric-edge invariant (c in nbr[b] iff b in
// nbr[c], each at most once), which every topology op keeps; the plain
// version in kernel.py scatters by nbr[wid] and does not rely on it.
// The sums run in slot order, the same on every run. Products and sums are
// rounded one by one (no FMA contraction), as PyTorch's separate
// elementwise ops round them, so the winner fields are bitwise those of
// the plain version.
//
// Bound at M = 8192, C = 4096, K = 16, d = 3: about 1.3 MB read (signals,
// the per-signal scales, nbr, w) and 0.2 MB written, under a microsecond
// of memory time; the walk's gathers of nbr rows (K^2 per unit) hit L2.

__global__ void owner_kernel(const int* __restrict__ wid,
                             const uint8_t* __restrict__ sel,
                             int* __restrict__ owner, int M, int C) {
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M || !sel[(size_t)b * M + i]) return;
  const int c = wid[(size_t)b * M + i];
  if (c >= 0 && c < C) owner[(size_t)b * C + c] = i;
}

template <int D>
__global__ void accum_kernel(
    const float* __restrict__ x, const uint8_t* __restrict__ adapt,
    const float* __restrict__ scale_b, const float* __restrict__ d2b,
    const float* __restrict__ dec_b, const float* __restrict__ scale_n,
    const float* __restrict__ dec_n, const int* __restrict__ nbr,
    const float* __restrict__ w, const int* __restrict__ owner,
    float* __restrict__ w1, float* __restrict__ nsc, float* __restrict__ nsx,
    float* __restrict__ err, float* __restrict__ decb_u,
    float* __restrict__ decn_u, float* __restrict__ wind, int M, int C,
    int K) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  x += (size_t)b * M * D;
  adapt += (size_t)b * M;
  scale_b += (size_t)b * M;
  d2b += (size_t)b * M;
  dec_b += (size_t)b * M;
  scale_n += (size_t)b * M * K;
  dec_n += (size_t)b * M * K;
  nbr += (size_t)b * C * K;
  owner += (size_t)b * C;
  const size_t u = (size_t)b * C + c;

  const int o = owner[c];
  const bool win_adapts = o >= 0 && adapt[o];
  const float s = win_adapts ? scale_b[o] : 0.f;
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float wk = w[u * D + k];
    w1[u * D + k] =
        win_adapts
            ? __fadd_rn(wk, __fmul_rn(s, __fsub_rn(x[(size_t)o * D + k], wk)))
            : wk;
  }
  err[u] = o >= 0 ? d2b[o] : 0.f;
  wind[u] = o >= 0 ? 1.f : 0.f;
  decb_u[u] = win_adapts ? dec_b[o] : 0.f;

  float sc = 0.f, dn = 0.f, sx[D];
#pragma unroll
  for (int k = 0; k < D; ++k) sx[k] = 0.f;
  const int* row = nbr + (size_t)c * K;
  for (int j = 0; j < K; ++j) {
    const int nb = row[j];
    if (nb < 0) continue;
    const int ob = owner[nb];
    if (ob < 0 || !adapt[ob]) continue;
    const int* back = nbr + (size_t)nb * K;
    for (int jj = 0; jj < K; ++jj) {
      if (back[jj] != c) continue;
      const float sn = scale_n[(size_t)ob * K + jj];
      sc = __fadd_rn(sc, sn);
      dn = __fadd_rn(dn, dec_n[(size_t)ob * K + jj]);
#pragma unroll
      for (int k = 0; k < D; ++k)
        sx[k] = __fadd_rn(sx[k], __fmul_rn(sn, x[(size_t)ob * D + k]));
      break;
    }
  }
  nsc[u] = sc;
  decn_u[u] = dn;
#pragma unroll
  for (int k = 0; k < D; ++k) nsx[u * D + k] = sx[k];
}

template <int D>
void launch_accum(const float* x, const uint8_t* adapt, const float* scale_b,
                  const float* d2b, const float* dec_b, const float* scale_n,
                  const float* dec_n, const int* nbr, const float* w,
                  const int* owner, float* w1, float* nsc, float* nsx,
                  float* err, float* decb_u, float* decn_u, float* wind,
                  int B, int M, int C, int K, cudaStream_t stream) {
  const dim3 grid(blocks_for(C), B);
  accum_kernel<D><<<grid, kThreads, 0, stream>>>(
      x, adapt, scale_b, d2b, dec_b, scale_n, dec_n, nbr, w, owner, w1, nsc,
      nsx, err, decb_u, decn_u, wind, M, C, K);
}

// ---------------------------------------------------------------------------
// B4. Edge aging + winner-second refresh. Replaces _edge_age_kernel
// (kernel.py:272): age + (win + winat) * valid * (1 - prot * protat), then 0
// where reset marks the slot. valid, winat and protat are formed here from
// nbr and the per-unit flags instead of being read as (C, K) float arrays.
// Every term is a whole number, so the result is exact. Bound: about 0.5 MB
// moved at C = 4096, K = 16 (0.15 us at 3.35 TB/s): launch-bound; one
// thread per slot.

__global__ void edge_age_kernel(const float* __restrict__ age,
                                const int* __restrict__ nbr,
                                const uint8_t* __restrict__ win,
                                const uint8_t* __restrict__ stable,
                                const uint8_t* __restrict__ reset,
                                float* __restrict__ out, int C, int K,
                                long long n) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const long long ck = (long long)C * K;
  const long long b = e / ck;
  const int c = (int)((e / K) % C);
  const int nb = nbr[e];
  const bool valid = nb >= 0;
  const uint8_t* win_b = win + b * C;
  const uint8_t* st_b = stable + b * C;
  const float winat = valid && win_b[nb] ? 1.f : 0.f;
  const float keep = valid && st_b[c] && st_b[nb] ? 1.f : 0.f;
  const float inc =
      (float(win_b[c] != 0) + winat) * (valid ? 1.f : 0.f) * (1.f - keep);
  out[e] = reset[e] ? 0.f : __fadd_rn(age[e], inc);
}

}  // namespace

// wid, prio (B, M) i32 -> best (B, C) i32. Returns cudaGetLastError().
extern "C" int repro_winner_lock(const int* wid, const int* prio, int* best,
                                 int B, int M, int C, cudaStream_t stream) {
  if (B < 1 || M < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * C;
  fill_i32<<<blocks_for(n), kThreads, 0, stream>>>(best, kBigPrio, n);
  lock_kernel<<<dim3(blocks_for(M), B), kThreads, 0, stream>>>(wid, prio,
                                                              best, M, C);
  return (int)cudaGetLastError();
}

// x (B, M, D) f32; wid (B, M) i32; sel, adapt (B, M) bool; scale_b, d2b,
// dec_b (B, M) f32; scale_n, dec_n (B, M, K) f32; nbr (B, C, K) i32;
// w (B, C, D) f32; owner (B, C) i32 scratch -> w1, nsx (B, C, D) f32 and
// nsc, err, decb_u, decn_u, wind (B, C) f32. Returns cudaGetLastError().
extern "C" int repro_update_accum(
    const float* x, const int* wid, const uint8_t* sel, const uint8_t* adapt,
    const float* scale_b, const float* d2b, const float* dec_b,
    const float* scale_n, const float* dec_n, const int* nbr, const float* w,
    int* owner, float* w1, float* nsc, float* nsx, float* err, float* decb_u,
    float* decn_u, float* wind, int B, int M, int C, int K, int D,
    cudaStream_t stream) {
  if (B < 1 || M < 1 || C < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * C;
  fill_i32<<<blocks_for(n), kThreads, 0, stream>>>(owner, -1, n);
  owner_kernel<<<dim3(blocks_for(M), B), kThreads, 0, stream>>>(wid, sel,
                                                               owner, M, C);
#define REPRO_ACCUM(DD)                                                    \
  launch_accum<DD>(x, adapt, scale_b, d2b, dec_b, scale_n, dec_n, nbr, w,  \
                   owner, w1, nsc, nsx, err, decb_u, decn_u, wind, B, M, C, \
                   K, stream)
  switch (D) {
    case 1: REPRO_ACCUM(1); break;
    case 2: REPRO_ACCUM(2); break;
    case 3: REPRO_ACCUM(3); break;
    case 4: REPRO_ACCUM(4); break;
    case 5: REPRO_ACCUM(5); break;
    case 6: REPRO_ACCUM(6); break;
    case 7: REPRO_ACCUM(7); break;
    case 8: REPRO_ACCUM(8); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef REPRO_ACCUM
  return (int)cudaGetLastError();
}

// age (B, C, K) f32, nbr (B, C, K) i32, win, stable (B, C) bool,
// reset (B, C, K) bool -> out (B, C, K) f32. Returns cudaGetLastError().
extern "C" int repro_edge_age(const float* age, const int* nbr,
                              const uint8_t* win, const uint8_t* stable,
                              const uint8_t* reset, float* out, int B, int C,
                              int K, cudaStream_t stream) {
  if (B < 1 || C < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * C * K;
  edge_age_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      age, nbr, win, stable, reset, out, C, K, n);
  return (int)cudaGetLastError();
}

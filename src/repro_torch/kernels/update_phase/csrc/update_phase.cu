// The dense Update phase on Hopper: winner lock, per-unit accumulators
// and edge aging. Two entry points for the three Pallas TPU kernels of
// src/repro/kernels/update_phase/kernel.py: the lock, and the
// accumulators with edge aging folded into their per-slot launch. Every
// array carries a leading batch axis B (one network per row), so a fleet
// is one launch.
//
// The TPU kernels turn the GPU's atomic scatters into one-hot products on
// the MXU. On this card the scatters come back, in forms that are
// deterministic: an integer min in shared memory for the lock (min
// commutes), and a gather over neighbor slots with a fixed order for the
// float sums (no float atomics), so that a run repeats bit for bit.
//
// At the main path's sizes each entry point moves about a megabyte or
// less, a fraction of a microsecond at 3.35 TB/s: both are bound by the
// launch and by chains of dependent L2 loads, not by bytes or
// operations. The designs below cut launches and shorten those chains.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBigPrio = 0x7fffffff;

inline unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------------------
// B2. Winner lock. Replaces _lock_kernel (kernel.py:68): for each unit,
// the minimum priority over the signals that it won; kBigPrio where none
// did. Masked rows carry kBigPrio and are skipped.
//
// One launch, no global atomics. The grid is (ceil(C / kLockTile), B):
// each block owns one tile of kLockTile units of one network in shared
// memory, sets it to kBigPrio, reads every (wid, prio) pair of its
// network (16-byte loads where the rows allow, 64 KB at M = 8192, from
// L2), takes a shared-memory atomicMin for the winners that fall in its
// tile, and stores the tile with coalesced writes. min commutes, so the
// result is exact and repeatable. A pool larger than one tile (the JAX
// package runs pools of 64k units) takes several blocks per network,
// each reading the whole signal row.
//
// Bound: 8 bytes a signal in and 4 a unit out (about 0.08 MB at
// M = 8192, C = 4096, 0.02 us). What costs is the launch and one SM
// reading the 64 KB row through its own port to L2; the first two
// 16-byte pairs of each thread are loaded before the tile is set, so
// that their latency overlaps it. Splitting the row over the blocks of a
// thread-block cluster, merged through distributed shared memory, was
// tried and was slower at these sizes: the cluster's launch and syncs
// cost more than the read it shares out.

constexpr int kLockThreads = 1024;
constexpr int kLockTile = 8192;   // units per block: 32 KB of shared memory
constexpr int kLockPre = 2;       // 16-byte pairs a thread loads early

__device__ __forceinline__ void lock_one(int* tile, int lo, int n, int c,
                                         int p) {
  if (p != kBigPrio && c >= lo && c - lo < n) atomicMin(&tile[c - lo], p);
}

__device__ __forceinline__ void lock_four(int* tile, int lo, int n, int4 c,
                                          int4 p) {
  lock_one(tile, lo, n, c.x, p.x);
  lock_one(tile, lo, n, c.y, p.y);
  lock_one(tile, lo, n, c.z, p.z);
  lock_one(tile, lo, n, c.w, p.w);
}

__global__ void __launch_bounds__(kLockThreads)
lock_tile_kernel(const int* __restrict__ wid, const int* __restrict__ prio,
                 int* __restrict__ best, int M, int C, int vec) {
  __shared__ int tile[kLockTile];
  const int b = blockIdx.y;
  const int lo = blockIdx.x * kLockTile;
  const int n = min(kLockTile, C - lo);
  wid += (size_t)b * M;
  prio += (size_t)b * M;
  // 16-byte pairs, where M % 4 == 0 and both rows are 16-byte aligned
  const int q4 = vec ? M / 4 : 0;
  const int4* w4 = reinterpret_cast<const int4*>(wid);
  const int4* p4 = reinterpret_cast<const int4*>(prio);
  int4 cw[kLockPre], pw[kLockPre];
#pragma unroll
  for (int r = 0; r < kLockPre; ++r) {
    const int q = threadIdx.x + r * kLockThreads;
    pw[r] = make_int4(kBigPrio, kBigPrio, kBigPrio, kBigPrio);
    cw[r] = pw[r];
    if (q < q4) {
      cw[r] = w4[q];
      pw[r] = p4[q];
    }
  }
  for (int t = threadIdx.x; t < n; t += kLockThreads) tile[t] = kBigPrio;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kLockPre; ++r) lock_four(tile, lo, n, cw[r], pw[r]);
#pragma unroll 2
  for (int q = threadIdx.x + kLockPre * kLockThreads; q < q4;
       q += kLockThreads)
    lock_four(tile, lo, n, w4[q], p4[q]);
  for (int i = 4 * q4 + threadIdx.x; i < M; i += kLockThreads)
    lock_one(tile, lo, n, wid[i], prio[i]);
  __syncthreads();
  int* out = best + (size_t)b * C + lo;
  for (int t = threadIdx.x; t < n; t += kLockThreads) out[t] = tile[t];
}

// ---------------------------------------------------------------------------
// B3 + B4. Per-unit accumulators and edge aging, one entry point. Replaces
// _update_accum_kernel (kernel.py:124) and _edge_age_kernel (kernel.py:272).
//
// Precondition: the selected signals have distinct winners (the lock
// keeps one signal per unit, and priorities are distinct). The selected
// signal of unit c is its owner.
//
// Launch 1 (owner_scatter_kernel, one thread per signal) writes
// owner[c] = i for each selected signal i with winner c; no two writes
// collide. The scratch is not cleared first: owner[c] is trusted only if
// o = owner[c] passes 0 <= o < M, sel[o] and wid[o] == c. A stale or
// garbage value cannot pass by mistake: if it passes, c has a selected
// signal o, so the scatter wrote owner[c] = o in this call. Every o is
// bounds-checked before it indexes anything.
//
// Launch 2 (accum_group_kernel) gives each unit c a group of G lanes, one
// per neighbor slot (G = K rounded up to a power of two in [8, 32];
// slots beyond 32 loop in chunks of G). Lane j reads nb = nbr[c, j],
// finds c's slot jj in nbr[nb] and the first slot of nb in nbr[c] (16-byte
// loads where K % 4 == 0), and loads age[c, j], stable[c] and stable[nb];
// this part reads only inputs, so it runs before the owner map is
// complete. The kernel goes out with programmatic dependent launch (the
// scatter lets it launch at once, griddepcontrol), so its launch and this
// first part overlap launch 1; griddepcontrol.wait then waits for the
// owner map. Each lane validates the owner on of nb; lane 0 validates c's
// own owner ow and hands it, and sid[ow] where ow adapts, to its group
// with a shuffle.
//
// Accumulators. If on adapts and c sits in slot jj of nb's row, the lane
// stages scale_n[on, jj], dec_n[on, jj] and scale_n x_on in shared
// memory; lane f of the group then adds field f over the slots in slot
// order (exact zeros for empty slots, which change no sum), so the
// neighbor fields round exactly as a serial walk of nbr[c] does, the same
// on every run. Lane 0 writes the winner fields from ow: w1 = w +
// scale_b (x_o - w) if ow adapts (a copy, not a sum), err = d2b[ow],
// dec_b = dec_b[ow], the winner indicator. Products and sums are rounded
// one by one (no FMA contraction), as PyTorch's separate elementwise ops
// round them, so the winner fields are bitwise those of the plain
// version. The neighbor walk relies on the symmetric-edge invariant (c in
// nbr[b] iff b in nbr[c], each at most once), which every topology op
// keeps; the plain version in kernel.py scatters by nbr[wid] and does not
// rely on it.
//
// Edge aging. Lane j writes age_out[c, j] = 0 if the slot is reset, else
// age[c, j] + (win_c + winat) valid (1 - stable[c] stable[nb]), the
// formula of _edge_age_kernel, with win_c = (ow exists), winat = (on
// exists), valid = (nb >= 0); every term is a whole number, so the sum
// (__fadd_rn) is exact. The reset is the winner-second refresh that the
// JAX package forms outside its kernel, edge_slots(nbr, wid, sid, adapt):
// the slot of edge (wid[i], sid[i]) in both rows, for every adapting i,
// where a slot is the first one of its row that holds the other end. An
// adapting signal is selected, so the only adapting signal with winner c
// is ow and the only one with winner nb is on: slot j of c is reset iff
// it is the first slot of row c that holds nb and (ow adapts and sid[ow]
// == nb, or on adapts and sid[on] == c). sid of both owners is loaded
// beside the adapt loads the chain makes already, so aging adds no
// dependent step. The owner of nb is taken for every valid slot, not only
// where c is found in nb's row, so aging does not rely on symmetric edges
// and equals the plain version on any table whose entries lie in [-1, C).
// The TPU design fed its aging kernel seven (C, K)-sized planes formed by
// a chain of small ops; here the lane that holds the slot already has nb
// and both owners in registers, and the launch of its own is gone.
//
// Bound at M = 8192, C = 4096, K = 16, d = 3: about 1.1 MB that the
// function needs (the flags of every signal, the other inputs and sid of
// the selected ones, nbr, w, the age table in and out, stable and the
// other outputs), 0.33 us at 3.35 TB/s. What costs is the launches and,
// per unit, a chain of about five dependent L2 loads (nbr[c] -> nbr[nb]
// -> owner -> sel/wid/adapt/sid -> scale_n/x): still launch- and
// latency-bound, with the chain spread over lanes and the ~300 active
// units of the main path over ~19 blocks.

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

__global__ void owner_scatter_kernel(const int* __restrict__ wid,
                                     const uint8_t* __restrict__ sel,
                                     int* __restrict__ owner, int M, int C) {
  allow_dependent_launch();
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M || !sel[(size_t)b * M + i]) return;
  const int c = wid[(size_t)b * M + i];
  if (c >= 0 && c < C) owner[(size_t)b * C + c] = i;
}

// o if signal o owns unit c, else -1 (see the validation note above).
// Both loads go out together.
__device__ __forceinline__ int checked_owner(int o, const int* wid,
                                             const uint8_t* sel, int c,
                                             int M) {
  if (o < 0 || o >= M) return -1;
  const bool s = sel[o];
  const int wo = wid[o];
  return s && wo == c ? o : -1;
}

// The first slot of row nbr[r] that holds v, or -1.
__device__ __forceinline__ int first_slot(const int* nbr, int r, int v,
                                          int K, bool vec) {
  const int* row = nbr + (size_t)r * K;
  int jj = -1;
  if (vec) {   // K % 4 == 0, rows 16-byte aligned
    const int4* r4 = reinterpret_cast<const int4*>(row);
#pragma unroll 4
    for (int q = K / 4 - 1; q >= 0; --q) {
      const int4 t = r4[q];
      if (t.w == v) jj = 4 * q + 3;
      if (t.z == v) jj = 4 * q + 2;
      if (t.y == v) jj = 4 * q + 1;
      if (t.x == v) jj = 4 * q;
    }
  } else {
    for (int q = K - 1; q >= 0; --q)
      if (row[q] == v) jj = q;
  }
  return jj;
}

template <int D, int G>
__global__ void __launch_bounds__(kThreads)
accum_group_kernel(
    const float* __restrict__ x, const int* __restrict__ wid,
    const uint8_t* __restrict__ sel, const uint8_t* __restrict__ adapt,
    const float* __restrict__ scale_b, const float* __restrict__ d2b,
    const float* __restrict__ dec_b, const float* __restrict__ scale_n,
    const float* __restrict__ dec_n, const int* __restrict__ nbr,
    const float* __restrict__ w, const int* __restrict__ sid,
    const float* __restrict__ age, const uint8_t* __restrict__ stable,
    const int* __restrict__ owner, float* __restrict__ w1,
    float* __restrict__ nsc, float* __restrict__ nsx,
    float* __restrict__ err, float* __restrict__ decb_u,
    float* __restrict__ decn_u, float* __restrict__ wind,
    float* __restrict__ age_out, int M, int C, int K, int vec) {
  constexpr int F = D + 2;   // staged per slot: scale_n, dec_n, scale_n x
  constexpr int kUnits = kThreads / G;
  constexpr int kPerLane = (F + G - 1) / G;   // fields summed per lane
  __shared__ float stage[F][kThreads + 1];

  const int b = blockIdx.y;
  const int lane = threadIdx.x % G;
  const int first = threadIdx.x - lane;   // the group's lane 0
  const int c = blockIdx.x * kUnits + threadIdx.x / G;
  const bool live = c < C;
  const bool leader = live && lane == 0;
  x += (size_t)b * M * D;
  wid += (size_t)b * M;
  sel += (size_t)b * M;
  adapt += (size_t)b * M;
  scale_b += (size_t)b * M;
  d2b += (size_t)b * M;
  dec_b += (size_t)b * M;
  scale_n += (size_t)b * M * K;
  dec_n += (size_t)b * M * K;
  sid += (size_t)b * M;
  nbr += (size_t)b * C * K;
  age += (size_t)b * C * K;
  age_out += (size_t)b * C * K;
  stable += (size_t)b * C;
  owner += (size_t)b * C;
  const size_t u = (size_t)b * C + c;

  // ---- before the owner map is complete: inputs only
  const bool st_c = live && stable[c];
  int nb = -1, nbc = -1;   // slot j's neighbor, clamped to C - 1
  int jj = -1, js = -1;    // c's slot in nb's row; nb's first slot in c's
  float age_j = 0.f;
  bool st_nb = false;
  auto find = [&](int j) {
    const bool slot = live && j < K;
    nb = slot ? nbr[(size_t)c * K + j] : -1;
    nbc = min(nb, C - 1);
    const bool in = nb >= 0 && nb < C;
    jj = in ? first_slot(nbr, nb, c, K, vec) : -1;
    js = in ? first_slot(nbr, c, nb, K, vec) : -1;
    age_j = slot ? age[(size_t)c * K + j] : 0.f;
    st_nb = nb >= 0 && stable[nbc];
  };
  find(lane);
  float wrow[D];
#pragma unroll
  for (int k = 0; k < D; ++k) wrow[k] = leader ? w[u * D + k] : 0.f;
  wait_for_primary_grid();

  // The unit's own owner (lane 0) and its neighbor's (every lane) are
  // fetched side by side, so that the two chains of loads overlap.
  int ow = leader ? owner[c] : -1;
  int on = nb >= 0 ? owner[nbc] : -1;
  ow = checked_owner(ow, wid, sel, c, M);
  on = checked_owner(on, wid, sel, nbc, M);

  // ---- winner fields, and the second of c's owner where it adapts
  int second = -1;
  if (leader) {
    bool win_adapts = false;
    int so = -1;
    float s = 0.f, e = 0.f, db = 0.f, xo[D];
#pragma unroll
    for (int k = 0; k < D; ++k) xo[k] = 0.f;
    if (ow >= 0) {
      win_adapts = adapt[ow];
      so = sid[ow];
      s = scale_b[ow];
      e = d2b[ow];
      db = dec_b[ow];
#pragma unroll
      for (int k = 0; k < D; ++k) xo[k] = x[(size_t)ow * D + k];
    }
    second = win_adapts ? so : -1;
#pragma unroll
    for (int k = 0; k < D; ++k)
      w1[u * D + k] =
          win_adapts
              ? __fadd_rn(wrow[k], __fmul_rn(s, __fsub_rn(xo[k], wrow[k])))
              : wrow[k];
    err[u] = ow >= 0 ? e : 0.f;
    wind[u] = ow >= 0 ? 1.f : 0.f;
    decb_u[u] = win_adapts ? db : 0.f;
  }
  // groups are aligned G-lane segments of a warp: lane 0 is segment lane 0
  const float win_c = __shfl_sync(0xffffffffu, ow, 0, G) >= 0 ? 1.f : 0.f;
  second = __shfl_sync(0xffffffffu, second, 0, G);

  // ---- G slots at a time: neighbor fields summed in slot order, ages
  float acc[kPerLane];
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) acc[r] = 0.f;
  for (int base = 0;;) {
    float v[F];
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = 0.f;
    bool back = false;   // nb's owner adapts and has c as its second
    if (on >= 0) {
      const bool a = adapt[on];
      const int so = sid[on];
      back = a && so == c;
      if (jj >= 0) {
        const float sn = scale_n[(size_t)on * K + jj];
        const float dn = dec_n[(size_t)on * K + jj];
        float xo[D];
#pragma unroll
        for (int k = 0; k < D; ++k) xo[k] = x[(size_t)on * D + k];
        if (a) {
          v[0] = sn;
          v[1] = dn;
#pragma unroll
          for (int k = 0; k < D; ++k) v[2 + k] = __fmul_rn(sn, xo[k]);
        }
      }
    }
    const int j = base + lane;
    if (live && j < K) {
      // js == j only for the first slot of an in-range neighbor
      const bool reset = js == j && (second == nb || back);
      const float winat = on >= 0 ? 1.f : 0.f;
      const float valid = nb >= 0 ? 1.f : 0.f;
      const float unkept = st_c && st_nb ? 0.f : 1.f;
      const float inc =
          __fmul_rn(__fmul_rn(__fadd_rn(win_c, winat), valid), unkept);
      age_out[(size_t)c * K + j] = reset ? 0.f : __fadd_rn(age_j, inc);
    }
#pragma unroll
    for (int f = 0; f < F; ++f) stage[f][threadIdx.x] = v[f];
    __syncwarp();
#pragma unroll
    for (int r = 0; r < kPerLane; ++r) {
      const int f = lane + r * G;
      if (f < F) {
#pragma unroll
        for (int t = 0; t < G; ++t)
          acc[r] = __fadd_rn(acc[r], stage[f][first + t]);
      }
    }
    __syncwarp();
    base += G;
    if (base >= K) break;
    find(base + lane);
    on = checked_owner(nb >= 0 ? owner[nbc] : -1, wid, sel, nbc, M);
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < kPerLane; ++r) {
    const int f = lane + r * G;
    if (f == 0) nsc[u] = acc[r];
    else if (f == 1) decn_u[u] = acc[r];
    else if (f < F) nsx[u * D + (f - 2)] = acc[r];
  }
}

template <int D, int G>
cudaError_t launch_accum(const float* x, const int* wid, const uint8_t* sel,
                         const uint8_t* adapt, const float* scale_b,
                         const float* d2b, const float* dec_b,
                         const float* scale_n, const float* dec_n,
                         const int* nbr, const float* w, const int* sid,
                         const float* age, const uint8_t* stable,
                         const int* owner, float* w1, float* nsc, float* nsx,
                         float* err, float* decb_u, float* decn_u,
                         float* wind, float* age_out, int B, int M, int C,
                         int K, int vec, cudaStream_t stream) {
  constexpr int kUnits = kThreads / G;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((C + kUnits - 1) / kUnits), B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, accum_group_kernel<D, G>, x, wid, sel,
                            adapt, scale_b, d2b, dec_b, scale_n, dec_n, nbr,
                            w, sid, age, stable, owner, w1, nsc, nsx, err,
                            decb_u, decn_u, wind, age_out, M, C, K, vec);
}

}  // namespace

// wid, prio (B, M) i32 -> best (B, C) i32. Returns cudaGetLastError().
extern "C" int repro_winner_lock(const int* wid, const int* prio, int* best,
                                 int B, int M, int C, cudaStream_t stream) {
  if (B < 1 || M < 1 || C < 1) return (int)cudaErrorInvalidValue;
  const int vec = M % 4 == 0 && aligned16(wid) && aligned16(prio);
  const dim3 grid((unsigned)((C + kLockTile - 1) / kLockTile), B);
  lock_tile_kernel<<<grid, kLockThreads, 0, stream>>>(wid, prio, best, M, C,
                                                      vec);
  return (int)cudaGetLastError();
}

// x (B, M, D) f32; wid (B, M) i32; sel, adapt (B, M) bool; scale_b, d2b,
// dec_b (B, M) f32; scale_n, dec_n (B, M, K) f32; nbr (B, C, K) i32;
// w (B, C, D) f32; sid (B, M) i32; age (B, C, K) f32; stable (B, C) bool;
// owner (B, C) i32 scratch, any contents -> w1, nsx (B, C, D) f32, nsc,
// err, decb_u, decn_u, wind (B, C) f32 and age_out (B, C, K) f32, which
// must not alias age. Returns cudaGetLastError().
extern "C" int repro_update_accum(
    const float* x, const int* wid, const uint8_t* sel, const uint8_t* adapt,
    const float* scale_b, const float* d2b, const float* dec_b,
    const float* scale_n, const float* dec_n, const int* nbr, const float* w,
    const int* sid, const float* age, const uint8_t* stable, int* owner,
    float* w1, float* nsc, float* nsx, float* err, float* decb_u,
    float* decn_u, float* wind, float* age_out, int B, int M, int C, int K,
    int D, cudaStream_t stream) {
  if (B < 1 || M < 1 || C < 1 || K < 1 || D < 1 || D > 8)
    return (int)cudaErrorInvalidValue;
  owner_scatter_kernel<<<dim3(blocks_for(M), B), kThreads, 0, stream>>>(
      wid, sel, owner, M, C);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int vec = K % 4 == 0 && aligned16(nbr);
  const int G = K <= 8 ? 8 : K <= 16 ? 16 : 32;
  cudaError_t r = cudaErrorInvalidValue;
#define REPRO_ACCUM(DD, GG)                                                  \
  r = launch_accum<DD, GG>(x, wid, sel, adapt, scale_b, d2b, dec_b, scale_n, \
                           dec_n, nbr, w, sid, age, stable, owner, w1, nsc,  \
                           nsx, err, decb_u, decn_u, wind, age_out, B, M, C, \
                           K, vec, stream)
#define REPRO_ACCUM_D(DD)              \
  case DD:                             \
    if (G == 8) REPRO_ACCUM(DD, 8);    \
    else if (G == 16) REPRO_ACCUM(DD, 16); \
    else REPRO_ACCUM(DD, 32);          \
    break
  switch (D) {
    REPRO_ACCUM_D(1);
    REPRO_ACCUM_D(2);
    REPRO_ACCUM_D(3);
    REPRO_ACCUM_D(4);
    REPRO_ACCUM_D(5);
    REPRO_ACCUM_D(6);
    REPRO_ACCUM_D(7);
    REPRO_ACCUM_D(8);
  }
#undef REPRO_ACCUM_D
#undef REPRO_ACCUM
  if (r != cudaSuccess) {
    cudaGetLastError();   // clear the error the failed launch left
    return (int)r;
  }
  return (int)cudaGetLastError();
}

// The SOAM topology refresh on Hopper: every unit's state ladder.
//
// Replaces no Pallas kernel: the JAX package's refresh
// (src/repro/core/gson/topology.py::compute_topo_states) is plain jnp. Its
// plain PyTorch twin, repro_torch.core.gson.topology.
// compute_topo_states_plain, builds for every slot of the pool the (K, K)
// link graph of its neighborhood as a (B, C, K, K, K) comparison reduced
// by `any`, and its connectivity by repeated squaring with `bmm`: several
// GB of intermediates a refresh on the paper's pool of 32768 slots, of
// which under 1% hold a unit with edges. This kernel computes the same
// states, bit for bit, with no intermediate larger than the (B, C) output.
//
// What bounds it: bytes. The least the work needs is the id table, the
// firing counters, the flags and the states, each byte once: at the
// paper.fleet32 shape (B = 32, C = 32768, K = 16) 76.5 MB, 23 us at
// 3.35 TB/s; at sphere4k.fleet64 (B = 64, C = 4096) 19 MB, 6 us. The
// kernel moves more: the rows that have edges (under 1% and ~13% of the
// rows there) read their neighbors' rows again, and a byte of scratch per
// row is written and read. A row's work is a few thousand integer
// compares.
//
// Launch 1 (topo_ladder_kernel, one thread per row). A row reads its K ids
// with 16-byte loads. A row with no valid id (id < 0) gets its state at
// once: HABITUATED if firing < threshold, else ACTIVE. Any other row
// builds its link graph as K bit masks in registers and local memory:
// bit j of mask i is set when the row's id j (valid, j != i) appears in
// the row of its neighbor i, nbr[b, min(id_i, C - 1), :]. Popcounts give
// each neighbor's links; a walk over the masks from the first valid slot
// gives connectivity (the fixed point that the plain version's repeated
// squaring reaches); then the ladder. Each row writes its state before the
// active mask to a byte of scratch, flagged when the row is active and a
// DISK (a candidate for PATCH), and its final state to the output unless
// it is such a candidate.
//
// Launch 2 (topo_patch_kernel, programmatic dependent launch) decides the
// candidates: a candidate becomes PATCH when every valid neighbor's state
// before the mask, read from the scratch at min(id, C - 1), is a DISK.
//
// A row with edges gets its whole ladder even when it is inactive, since
// a neighbor's PATCH test reads its state before the mask. Ids >= C are
// valid and read clamped, as `take` reads them; a row with no valid id
// counts as connected; the threshold is compared in float32, as PyTorch
// compares a float32 tensor with a Python float. No atomics: every call is
// repeatable.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kActive = 0, kHabituated = 1, kConnected = 2, kHalfDisk = 3,
              kDisk = 4, kPatch = 5, kSingular = 6;  // state.py's ladder
constexpr uint8_t kCandidate = 0x80;  // scratch flag: an active DISK row
constexpr uint8_t kStateBits = 0x7f;

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

// One row of K ids into KP registers (KP >= K), -1 past K. VEC: K is a
// multiple of 4 and the table 16-byte aligned, so the row is K / 4 int4s.
template <int KP, bool VEC>
__device__ __forceinline__ void load_row(const int* __restrict__ row, int K,
                                         int (&v)[KP]) {
  if (VEC) {
    const int4* r4 = reinterpret_cast<const int4*>(row);
#pragma unroll
    for (int c = 0; c < KP / 4; ++c) {
      const int4 q = 4 * c < K ? __ldg(r4 + c) : make_int4(-1, -1, -1, -1);
      v[4 * c] = q.x;
      v[4 * c + 1] = q.y;
      v[4 * c + 2] = q.z;
      v[4 * c + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < KP; ++j) v[j] = j < K ? __ldg(row + j) : -1;
  }
}

template <int KP, bool VEC>
__global__ void __launch_bounds__(kThreads)
    topo_ladder_kernel(const int* __restrict__ nbr,
                       const uint8_t* __restrict__ active,
                       const float* __restrict__ firing, float threshold,
                       long long rows, int C, int K,
                       uint8_t* __restrict__ pre, int* __restrict__ out) {
  allow_dependent_launch();
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= rows) return;
  const long long first_row = r - r % C;  // row 0 of this network
  int id[KP];
  load_row<KP, VEC>(nbr + r * K, K, id);
  uint32_t valid = 0;
#pragma unroll
  for (int j = 0; j < KP; ++j) valid |= (uint32_t)(id[j] >= 0) << j;
  const bool habituated = __ldg(firing + r) < threshold;
  const bool act = __ldg(active + r) != 0;

  int s = habituated ? kHabituated : kActive;
  if (valid != 0) {
    // links[i]: the valid slots j != i whose id is in neighbor i's row
    uint32_t links[KP];
    int n_end = 0, n_mid = 0;
    bool over = false, all_linked = true;
    for (uint32_t todo = valid; todo; todo &= todo - 1) {
      const int i = __ffs(todo) - 1;
      const int p = min(__ldg(nbr + r * K + i), C - 1);
      int q[KP];
      load_row<KP, VEC>(nbr + (first_row + p) * K, K, q);
      uint32_t hit = 0;
#pragma unroll
      for (int t = 0; t < KP; ++t) {
#pragma unroll
        for (int j = 0; j < KP; ++j) hit |= (uint32_t)(q[t] == id[j]) << j;
      }
      hit &= valid & ~(1u << i);
      links[i] = hit;
      const int n = __popc(hit);
      n_end += n == 1;
      n_mid += n == 2;
      over |= n > 2;
      all_linked &= n >= 1;
    }
    // the valid slots reachable from the first one along the links
    uint32_t seen = valid & (0u - valid);
    for (uint32_t front = seen; front;) {
      uint32_t next = 0;
      for (; front; front &= front - 1) next |= links[__ffs(front) - 1];
      front = next & ~seen;
      seen |= next;
    }
    const bool conn = seen == valid;
    const int deg = __popc(valid);
    const bool path_s = deg >= 2 && conn && n_end == 2 && n_mid == deg - 2;
    const bool cycle_s = deg >= 3 && conn && n_mid == deg && !over;
    const bool conn_s = deg >= 2 && all_linked;
    if (habituated) {
      if (conn_s) s = kConnected;
      if (path_s) s = kHalfDisk;
      if (cycle_s) s = kDisk;
      if (deg >= K || (over && !cycle_s && deg >= 3)) s = kSingular;
    }
  }
  const bool candidate = act && s == kDisk;
  pre[r] = (uint8_t)(s | (candidate ? kCandidate : 0));
  if (!candidate) out[r] = act ? s : kActive;
}

__global__ void __launch_bounds__(kThreads)
    topo_patch_kernel(const int* __restrict__ nbr,
                      const uint8_t* __restrict__ pre, long long rows, int C,
                      int K, int* __restrict__ out) {
  wait_for_primary_grid();
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  // the scratch is read from L2 (__ldcg): launch 1 wrote it on other SMs
  if (r >= rows || !(__ldcg(pre + r) & kCandidate)) return;
  const long long first_row = r - r % C;
  bool all_disk = true;
  for (int j = 0; j < K; ++j) {
    const int p = nbr[r * K + j];
    if (p >= 0)
      all_disk &= (__ldcg(pre + first_row + min(p, C - 1)) & kStateBits) ==
                  kDisk;
  }
  out[r] = all_disk ? kPatch : kDisk;
}

template <int KP, bool VEC>
cudaError_t launch_ladder(const int* nbr, const uint8_t* act,
                          const float* firing, float threshold,
                          long long rows, int C, int K, uint8_t* pre,
                          int* out, cudaStream_t stream) {
  const unsigned blocks = (unsigned)((rows + kThreads - 1) / kThreads);
  topo_ladder_kernel<KP, VEC><<<blocks, kThreads, 0, stream>>>(
      nbr, act, firing, threshold, rows, C, K, pre, out);
  return cudaGetLastError();
}

template <bool VEC>
cudaError_t launch_ladder_k(const int* nbr, const uint8_t* act,
                            const float* firing, float threshold,
                            long long rows, int C, int K, uint8_t* pre,
                            int* out, cudaStream_t stream) {
  if (K <= 4)
    return launch_ladder<4, VEC>(nbr, act, firing, threshold, rows, C, K,
                                 pre, out, stream);
  if (K <= 8)
    return launch_ladder<8, VEC>(nbr, act, firing, threshold, rows, C, K,
                                 pre, out, stream);
  if (K <= 16)
    return launch_ladder<16, VEC>(nbr, act, firing, threshold, rows, C, K,
                                  pre, out, stream);
  return launch_ladder<32, VEC>(nbr, act, firing, threshold, rows, C, K,
                                pre, out, stream);
}

cudaError_t launch_patch(const int* nbr, const uint8_t* pre, long long rows,
                         int C, int K, int* out, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((rows + kThreads - 1) / kThreads));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, topo_patch_kernel, nbr, pre, rows, C, K,
                            out);
}

}  // namespace

// nbr (B, C, K) i32 with 1 <= K <= 32, active (B, C) bool as bytes, firing
// (B, C) f32, the threshold's float32 bits, pre a (B, C) byte scratch
// -> out (B, C) i32 states. Two launches (the ladder, then PATCH with
// programmatic dependent launch). Returns cudaGetLastError().
extern "C" int repro_topo_states(const int* nbr, const uint8_t* act,
                                 const float* firing, uint8_t* pre, int* out,
                                 int B, int C, int K, int threshold_bits,
                                 cudaStream_t stream) {
  if (B < 1 || C < 1 || K < 1 || K > 32) return (int)cudaErrorInvalidValue;
  float threshold;
  memcpy(&threshold, &threshold_bits, sizeof threshold);
  const long long rows = (long long)B * C;
  const bool vec = K % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(nbr) & 15u) == 0;
  cudaError_t r =
      vec ? launch_ladder_k<true>(nbr, act, firing, threshold, rows, C, K,
                                  pre, out, stream)
          : launch_ladder_k<false>(nbr, act, firing, threshold, rows, C, K,
                                   pre, out, stream);
  if (r == cudaSuccess) r = launch_patch(nbr, pre, rows, C, K, out, stream);
  if (r != cudaSuccess) {
    cudaGetLastError();  // clear the error the failed launch left
    return (int)r;
  }
  return (int)cudaGetLastError();
}

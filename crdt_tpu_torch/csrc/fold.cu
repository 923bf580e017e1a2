// K1 and K2 — streamed lattice folds over the replica axis, for Hopper
// (sm_90a). One kernel body, two join rules chosen at compile time.
//
// K1 replaces the JAX package's Pallas TPU kernel `_fold_kernel` with the
// element join rule `_join_step` (crdt_tpu/ops/pallas_kernels.py, launched
// by `_fold_entries_fused`): the dense ORSWOT entry matrices. K2 replaces
// the same `_fold_kernel` with the cell rule `_join_step_cells`
// (`_fold_entries_fused(..., cellwise=True)` from `_fold_fused_map_jit`):
// the dense per-(key, actor) witness counters of Map<K, MVReg>. Both
// compute, for top[R, A] and ctr[R, N, A] (uint32, row-major):
//
//     top_out[A]    = max_r top[r]
//     ctr_out[N, A] = the join of every replica's row n
//
// with the join of (acc_top, acc) and (b_top, b) per row, lane by lane:
//     wa = acc > b_top ? acc : 0          wb = b > acc_top ? b : 0
//   K1 (element rule, a presence term across the row):
//     pa = any(acc > 0)                   pb = any(b > 0)
//     acc = pa && pb ? max(min(acc, b), max(wa, wb)) : (pa ? wa : wb)
//   K2 (cell rule, no presence term):
//     acc = acc == b ? acc : max(wa, wb)
//   both:
//     acc_top = max(acc_top, b_top)
// starting from the join identity (all zeros). Each join is associative,
// commutative and idempotent on the states replicas reach, so folding the
// replicas in sequence gives the bits of the TPU kernel's halving tree;
// `n_passes` re-walks the batch (same result, by idempotence).
//
// What bounds them: each reads R*N*A*4 bytes once, writes N*A*4, and does
// ~10 integer operations per lane, far below the card's integer rate, so
// both are bound by device-memory bandwidth. K1 at config 3 (R=10240,
// N=E=102400, A=8) reads 33.55 GB: >= 10.0 ms at the H100 SXM's nominal
// 3.35 TB/s. K2 at config 4 (R=8, N=K=1,000,000, A=4) reads 128 MB and
// writes 16 MB: >= 0.043 ms; at R=64 it reads 1.02 GB: >= 0.31 ms.
//
// Design: the TPU kernel transposes to [A, N] so N rides the 128-wide
// lanes, pads N and R, and reduces power-of-two replica chunks in VMEM;
// none of that is needed here. One thread owns one row and walks the R
// replicas with the running (acc_top, acc) in registers. At A = 8 a row is
// 32 bytes (two 16-byte loads), at A = 4 16 bytes (one), and neighbouring
// threads read neighbouring rows, so each warp's load of one replica is
// contiguous. The replica loop is unrolled so UNROLL replicas' rows are in
// flight per thread before any is joined. top[r] is the same 4*A bytes for
// every thread (a broadcast through L1). Block 0 also reduces top_out with
// shared-memory atomics. A is a runtime value bounded by the template's
// AMAX (<= 32); rows past N are masked.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;  // small blocks spread the rows evenly over SMs

template <int AMAX, bool VEC>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ p, int a,
                                         uint32_t (&row)[AMAX]) {
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < AMAX; k += 4) {
      if (k < a) {
        uint4 v = __ldg(reinterpret_cast<const uint4*>(p + k));
        row[k] = v.x; row[k + 1] = v.y; row[k + 2] = v.z; row[k + 3] = v.w;
      } else {
        row[k] = row[k + 1] = row[k + 2] = row[k + 3] = 0u;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < AMAX; ++k) row[k] = k < a ? __ldg(p + k) : 0u;
  }
}

template <int AMAX>
__device__ __forceinline__ void join_row(uint32_t (&acc_top)[AMAX], uint32_t (&acc)[AMAX],
                                         const uint32_t (&b_top)[AMAX],
                                         const uint32_t (&b)[AMAX]) {
  bool pa = false, pb = false;
#pragma unroll
  for (int k = 0; k < AMAX; ++k) {
    pa |= acc[k] != 0u;
    pb |= b[k] != 0u;
  }
#pragma unroll
  for (int k = 0; k < AMAX; ++k) {
    const uint32_t wa = acc[k] > b_top[k] ? acc[k] : 0u;
    const uint32_t wb = b[k] > acc_top[k] ? b[k] : 0u;
    const uint32_t common = max(min(acc[k], b[k]), max(wa, wb));
    acc[k] = (pa && pb) ? common : (pa ? wa : wb);
    acc_top[k] = max(acc_top[k], b_top[k]);
  }
}

template <int AMAX>
__device__ __forceinline__ void join_cells(uint32_t (&acc_top)[AMAX], uint32_t (&acc)[AMAX],
                                           const uint32_t (&b_top)[AMAX],
                                           const uint32_t (&b)[AMAX]) {
#pragma unroll
  for (int k = 0; k < AMAX; ++k) {
    const uint32_t wa = acc[k] > b_top[k] ? acc[k] : 0u;
    const uint32_t wb = b[k] > acc_top[k] ? b[k] : 0u;
    acc[k] = acc[k] == b[k] ? acc[k] : max(wa, wb);
    acc_top[k] = max(acc_top[k], b_top[k]);
  }
}

template <bool CELLS, int AMAX>
__device__ __forceinline__ void join(uint32_t (&acc_top)[AMAX], uint32_t (&acc)[AMAX],
                                     const uint32_t (&b_top)[AMAX], const uint32_t (&b)[AMAX]) {
  if constexpr (CELLS)
    join_cells<AMAX>(acc_top, acc, b_top, b);
  else
    join_row<AMAX>(acc_top, acc, b_top, b);
}

template <bool CELLS, int AMAX, bool VEC, int UNROLL>
__global__ void __launch_bounds__(kBlock)
fold_kernel(const uint32_t* __restrict__ top, const uint32_t* __restrict__ ctr,
            uint32_t* __restrict__ top_out, uint32_t* __restrict__ ctr_out, long long R,
            long long N, int A, int n_passes) {
  if (blockIdx.x == 0) {
    __shared__ unsigned int smax[AMAX];
    for (int k = threadIdx.x; k < A; k += blockDim.x) smax[k] = 0u;
    __syncthreads();
    for (long long i = threadIdx.x; i < R * A; i += blockDim.x)
      atomicMax(&smax[i % A], top[i]);
    __syncthreads();
    for (int k = threadIdx.x; k < A; k += blockDim.x) top_out[k] = smax[k];
  }

  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;

  uint32_t acc_top[AMAX], acc[AMAX];
#pragma unroll
  for (int k = 0; k < AMAX; ++k) acc_top[k] = acc[k] = 0u;

  const size_t row_stride = (size_t)N * A;  // elements between replicas
  const uint32_t* row0 = ctr + (size_t)n * A;
  for (int pass = 0; pass < n_passes; ++pass) {
    long long r = 0;
    for (; r + UNROLL <= R; r += UNROLL) {
      uint32_t rows[UNROLL][AMAX], tops[UNROLL][AMAX];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        load_row<AMAX, VEC>(row0 + (size_t)(r + u) * row_stride, A, rows[u]);
        load_row<AMAX, VEC>(top + (size_t)(r + u) * A, A, tops[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) join<CELLS, AMAX>(acc_top, acc, tops[u], rows[u]);
    }
    for (; r < R; ++r) {
      uint32_t row[AMAX], t[AMAX];
      load_row<AMAX, VEC>(row0 + (size_t)r * row_stride, A, row);
      load_row<AMAX, VEC>(top + (size_t)r * A, A, t);
      join<CELLS, AMAX>(acc_top, acc, t, row);
    }
  }

  uint32_t* out = ctr_out + (size_t)n * A;
#pragma unroll
  for (int k = 0; k < AMAX; ++k)
    if (k < A) out[k] = acc[k];
}

template <bool CELLS, int AMAX, bool VEC, int UNROLL>
void launch(const uint32_t* top, const uint32_t* ctr, uint32_t* top_out, uint32_t* ctr_out,
            long long R, long long N, int A, int n_passes, cudaStream_t stream) {
  long long blocks = (N + kBlock - 1) / kBlock;
  if (blocks < 1) blocks = 1;  // block 0 still writes top_out
  fold_kernel<CELLS, AMAX, VEC, UNROLL><<<(unsigned)blocks, kBlock, 0, stream>>>(
      top, ctr, top_out, ctr_out, R, N, A, n_passes);
}

template <bool CELLS>
int fold(const void* top, const void* ctr, void* top_out, void* ctr_out, long long R,
         long long N, int A, int n_passes, int vec, void* stream) {
  if (A < 1 || A > 32 || R < 0 || N < 0 || n_passes < 1) return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error so the check below is ours
  auto t = static_cast<const uint32_t*>(top);
  auto c = static_cast<const uint32_t*>(ctr);
  auto to = static_cast<uint32_t*>(top_out);
  auto co = static_cast<uint32_t*>(ctr_out);
  auto s = static_cast<cudaStream_t>(stream);
  if (vec && A <= 8)
    launch<CELLS, 8, true, 4>(t, c, to, co, R, N, A, n_passes, s);
  else if (vec)
    launch<CELLS, 32, true, 1>(t, c, to, co, R, N, A, n_passes, s);
  else
    launch<CELLS, 32, false, 1>(t, c, to, co, R, N, A, n_passes, s);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes): K1 (orswot entry rule) and K2
// (Map<K, MVReg> cell rule). Each returns the cudaError_t of the launch
// (0 = cudaSuccess). `vec` asks for 16-byte row loads: the caller
// guarantees A % 4 == 0 and 16-byte aligned `top` and `ctr`.
extern "C" int crdt_fold_entries(const void* top, const void* ctr, void* top_out,
                                 void* ctr_out, long long R, long long E, int A,
                                 int n_passes, int vec, void* stream) {
  return fold<false>(top, ctr, top_out, ctr_out, R, E, A, n_passes, vec, stream);
}

extern "C" int crdt_fold_cells(const void* top, const void* wctr, void* top_out,
                               void* wctr_out, long long R, long long K, int A,
                               int n_passes, int vec, void* stream) {
  return fold<true>(top, wctr, top_out, wctr_out, R, K, A, n_passes, vec, stream);
}

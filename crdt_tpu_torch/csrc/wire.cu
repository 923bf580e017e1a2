// K3 — the fused δ wire pass, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel `_wire_kernel`
// (crdt_tpu/ops/wire_kernels.py, launched by its `wire_pack`). For a stack
// of B slot matrices (the δ ring's P links of one round), per slot row
// (b, n) of clocks[B, N, LC] with watermark base[B, N, LC] and valid[B, N]:
//
//   encb[c] = clocks[c] - base[c] + 32768     (wrapping in T, u32 or u64)
//   fits[c] = encb[c] < 65536                 fit = all c
//   gated:  cov_d = valid && all(ctx cols == know) && all(know <= dig)
//   acked:  cov_a = valid && !cov_d && ack_ok && all(non-ctx cols == winc)
//                   && all(ctx cols <= winc)
//   keep  = valid && !cov_d && !cov_a && fit
//   defer = valid && !cov_d && !cov_a && !fit
//   word j = keep ? (encb[j] & 0xFFFF) | (encb[W + j] & 0xFFFF) << 16 : 0
//
// with W = ceil(LC / 2); for odd LC lane W + j = LC is a padding column
// holding clocks = base = winc = 0 (it fits, and a kept slot encodes it as
// 0x8000, as the TPU kernel's padded block does). Per batch b it also sums
//   nnz[b] = #(words != 0)      chk[b] = sum words * (2 * (n * W + j) + 1)
// modulo 2^32, n the row index within batch b (from 0, unpadded): the
// checksum partial `faults.integrity` computes for the words leaf.
//
// `base`, `know` and `dig` are read through a batch and a row stride
// (their lanes are unit-stride): a row stride of 0 broadcasts one stored
// row per batch over its N slots, and `know` may point into `clocks`
// itself. The δ ring passes its per-link watermark and digest so, and the
// dense gate's `know` as the clock matrix's rows columns, so a launch
// reads no materialised copy of either.
//
// What bounds it: one pass over the rows, reading LC lanes of clocks (LC
// of base and A of know and dig when they are per-row, LC of winc when
// acked) and writing W words and three flags, with ~10 integer operations
// per lane: bound by device-memory bandwidth. On the δ ring at config 3
// (8 links x 4,096 slots x LC 16, u32, gated) a launch moves ~3.3 MB,
// >= 1.0 us at the H100 SXM's nominal 3.35 TB/s — below launch overhead.
//
// Design: the TPU kernel walks row chunks in sequence and carries the two
// scalars in a revisited output block. Here one thread owns one row: it
// streams the row's lanes once, builds the W packed words in registers
// (WMAX <= 32 words, fully unrolled), decides keep/defer/covered, then
// writes the words and folds them into its nnz/chk. A warp-shuffle sum
// then one u32 atomicAdd per warp per scalar reduces into stats[B, 2]
// (zeroed by the caller); u32 addition wraps mod 2^32, so any order gives
// the same bits. blockIdx.y is the batch, so a warp never mixes batches
// and the row index restarts at 0 for every b.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr uint32_t kBias = 32768u;

// Element strides (batch, row) of the inputs that may be broadcast views.
struct RowStrides {
  long long base_b, base_n, know_b, know_n, dig_b, dig_n;
};

template <typename T, bool GATED, bool ACKED, int WMAX>
__global__ void __launch_bounds__(kBlock)
wire_kernel(const T* __restrict__ clocks, const T* __restrict__ base,
            const uint8_t* __restrict__ valid, const T* __restrict__ know,
            const T* __restrict__ dig, const T* __restrict__ winc,
            const uint8_t* __restrict__ ack_ok, uint32_t* __restrict__ words,
            uint8_t* __restrict__ keep_out, uint8_t* __restrict__ defer_out,
            uint8_t* __restrict__ cov_out, uint32_t* __restrict__ stats, long long N,
            int LC, int A, int ctx_lo, int ctx_hi, RowStrides st) {
  const int b = blockIdx.y;
  const long long n = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int W = (LC + 1) / 2;
  uint32_t nnz = 0u, chk = 0u;

  if (n < N) {
    const size_t row = (size_t)b * (size_t)N + (size_t)n;
    const T* c = clocks + row * LC;
    const T* bs = base + b * st.base_b + n * st.base_n;
    const T* wc = ACKED ? winc + row * LC : nullptr;
    const T* kn = GATED ? know + b * st.know_b + n * st.know_n : nullptr;

    bool fit = true, addonly = true, same = true, covc = true;
    uint32_t w[WMAX];
#pragma unroll
    for (int j = 0; j < WMAX; ++j) {
      w[j] = 0u;
      if (j < W) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int col = j + half * W;
          const bool real = col < LC;
          const T cv = real ? c[col] : T(0);
          const T bv = real ? bs[col] : T(0);
          const T e = cv - bv + T(kBias);
          fit = fit && e < T(65536);
          w[j] |= (uint32_t)(e & T(0xFFFF)) << (16 * half);
          const bool is_ctx = col >= ctx_lo && col < ctx_hi;
          if (GATED && is_ctx) addonly = addonly && cv == kn[col - ctx_lo];
          if (ACKED) {
            const T wv = real ? wc[col] : T(0);
            if (is_ctx)
              covc = covc && cv <= wv;
            else
              same = same && cv == wv;
          }
        }
      }
    }

    const bool v = valid[row] != 0;
    bool cov_d = false, cov_a = false;
    if (GATED) {
      const T* dg = dig + b * st.dig_b + n * st.dig_n;
      bool under = true;
      for (int k = 0; k < A; ++k) under = under && kn[k] <= dg[k];
      cov_d = v && addonly && under;
    }
    if (ACKED) cov_a = v && !cov_d && ack_ok[row] != 0 && same && covc;
    const bool keep = v && !cov_d && !cov_a && fit;
    keep_out[row] = keep;
    defer_out[row] = v && !cov_d && !cov_a && !fit;
    cov_out[row] = cov_a;

    uint32_t* out = words + row * W;
    const uint32_t wbase = (uint32_t)((unsigned long long)n * (unsigned long long)W);
#pragma unroll
    for (int j = 0; j < WMAX; ++j) {
      if (j < W) {
        const uint32_t word = keep ? w[j] : 0u;
        out[j] = word;
        nnz += word != 0u;
        chk += word * (2u * (wbase + (uint32_t)j) + 1u);
      }
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    nnz += __shfl_down_sync(0xffffffffu, nnz, off);
    chk += __shfl_down_sync(0xffffffffu, chk, off);
  }
  if ((threadIdx.x & 31) == 0 && (nnz | chk) != 0u) {
    atomicAdd(&stats[2 * b], nnz);
    atomicAdd(&stats[2 * b + 1], chk);
  }
}

template <typename T, bool GATED, bool ACKED, int WMAX>
void run(const void* clocks, const void* base, const void* valid, const void* know,
         const void* dig, const void* winc, const void* ack_ok, void* words, void* keep,
         void* defer, void* cov, void* stats, long long B, long long N, int LC, int A,
         int ctx_lo, int ctx_hi, RowStrides st, cudaStream_t s) {
  const dim3 grid((unsigned)((N + kBlock - 1) / kBlock), (unsigned)B);
  wire_kernel<T, GATED, ACKED, WMAX><<<grid, kBlock, 0, s>>>(
      static_cast<const T*>(clocks), static_cast<const T*>(base),
      static_cast<const uint8_t*>(valid), static_cast<const T*>(know),
      static_cast<const T*>(dig), static_cast<const T*>(winc),
      static_cast<const uint8_t*>(ack_ok), static_cast<uint32_t*>(words),
      static_cast<uint8_t*>(keep), static_cast<uint8_t*>(defer), static_cast<uint8_t*>(cov),
      static_cast<uint32_t*>(stats), N, LC, A, ctx_lo, ctx_hi, st);
}

template <typename T, bool GATED, bool ACKED>
int launch(const void* clocks, const void* base, const void* valid, const void* know,
           const void* dig, const void* winc, const void* ack_ok, void* words, void* keep,
           void* defer, void* cov, void* stats, long long B, long long N, int LC, int A,
           int ctx_lo, int ctx_hi, RowStrides st, cudaStream_t s) {
  if ((LC + 1) / 2 <= 8)
    run<T, GATED, ACKED, 8>(clocks, base, valid, know, dig, winc, ack_ok, words, keep, defer,
                            cov, stats, B, N, LC, A, ctx_lo, ctx_hi, st, s);
  else
    run<T, GATED, ACKED, 32>(clocks, base, valid, know, dig, winc, ack_ok, words, keep, defer,
                             cov, stats, B, N, LC, A, ctx_lo, ctx_hi, st, s);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int gated, int acked, const void* clocks, const void* base, const void* valid,
             const void* know, const void* dig, const void* winc, const void* ack_ok,
             void* words, void* keep, void* defer, void* cov, void* stats, long long B,
             long long N, int LC, int A, int ctx_lo, int ctx_hi, RowStrides st,
             cudaStream_t s) {
  if (gated && acked)
    return launch<T, true, true>(clocks, base, valid, know, dig, winc, ack_ok, words, keep,
                                 defer, cov, stats, B, N, LC, A, ctx_lo, ctx_hi, st, s);
  if (gated)
    return launch<T, true, false>(clocks, base, valid, know, dig, winc, ack_ok, words, keep,
                                  defer, cov, stats, B, N, LC, A, ctx_lo, ctx_hi, st, s);
  if (acked)
    return launch<T, false, true>(clocks, base, valid, know, dig, winc, ack_ok, words, keep,
                                  defer, cov, stats, B, N, LC, A, ctx_lo, ctx_hi, st, s);
  return launch<T, false, false>(clocks, base, valid, know, dig, winc, ack_ok, words, keep,
                                 defer, cov, stats, B, N, LC, A, ctx_lo, ctx_hi, st, s);
}

}  // namespace

// Plain C entry point (loaded with ctypes). `clock_bytes` is 4 (uint32_t
// lanes) or 8 (uint64_t); `know`/`dig` are read only when `gated`,
// `winc`/`ack_ok` only when `acked`. `clocks`, `valid`, `winc`, `ack_ok`
// and the outputs are contiguous; `base`, `know` and `dig` are read at
// element strides (batch `*_b`, row `*_n`, >= 0) over unit-stride lanes.
// `valid`, `ack_ok` and the three flag outputs are one byte per row
// (torch.bool); `stats` is uint32[B, 2] (nnz, chk), zeroed by the caller.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int crdt_wire_pack(int clock_bytes, int gated, int acked, const void* clocks,
                              const void* base, const void* valid, const void* know,
                              const void* dig, const void* winc, const void* ack_ok,
                              void* words, void* keep, void* defer, void* cov, void* stats,
                              long long B, long long N, int LC, int A, int ctx_lo,
                              int ctx_hi, long long base_b, long long base_n, long long know_b,
                              long long know_n, long long dig_b, long long dig_n,
                              void* stream) {
  const RowStrides st{base_b, base_n, know_b, know_n, dig_b, dig_n};
  if (B < 1 || N < 1 || B > 65535 || LC < 1 || LC > 64 || ctx_lo < 0 || ctx_lo > ctx_hi ||
      ctx_hi > LC || (gated && A != ctx_hi - ctx_lo) || (clock_bytes != 4 && clock_bytes != 8) ||
      (st.base_b | st.base_n | st.know_b | st.know_n | st.dig_b | st.dig_n) < 0)
    return (int)cudaErrorInvalidValue;
  (void)cudaGetLastError();  // clear a stale error so the check below is ours
  auto s = static_cast<cudaStream_t>(stream);
  if (clock_bytes == 4)
    return dispatch<uint32_t>(gated, acked, clocks, base, valid, know, dig, winc, ack_ok, words,
                              keep, defer, cov, stats, B, N, LC, A, ctx_lo, ctx_hi, st, s);
  return dispatch<uint64_t>(gated, acked, clocks, base, valid, know, dig, winc, ack_ok, words,
                            keep, defer, cov, stats, B, N, LC, A, ctx_lo, ctx_hi, st, s);
}

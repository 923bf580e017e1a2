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
// dense gate's `know` as the clock matrix's rows columns.
//
// One launch packs a GROUP of up to kMaxInst such instances that share the
// clock type (the δ round's slot and parked instances): their descriptors
// travel by value in the kernel's parameters, and blocks map to
// (instance, batch, row tile) by the prefix sums of the instances' block
// counts.
//
// What bounds it: one pass over the rows, reading LC lanes of clocks (LC of
// base and A of know and dig when they are per-row, LC of winc when acked)
// and writing W words and three flag bytes, with ~12 integer operations
// per lane: device-memory bytes. At the δ ring's slot shape (8 links x
// 4,096 slots x LC 16 u32, gated, watermark and digest one row per link,
// know inside clocks) that is 3,277,632 distinct bytes, 0.98 us at the H100
// SXM's nominal 3.35 TB/s: below one launch's latency, so at that shape a
// launch costs its fixed part (grid ramp, stats tail, row-loop issue;
// PERF.md). Bytes set the bound only from ~10^5 rows up (the fan-out
// plane's B*E subscriber rows).
//
// Design, against what held back the thread-per-row version:
// 1. A row per group of G threads, G the power of two >= W (1..32). Thread
//    j of a group loads lanes j and W + j, the two halves of wire word j,
//    so a warp reads 32/G consecutive rows as contiguous bytes and stores
//    their words as contiguous lines; each thread builds its own word, so
//    nothing is exchanged but the row's verdicts. Those are AND-reductions
//    over the group, taken as the group's bits of one `__ballot_sync` per
//    verdict (fit; digest = ctx == know and know <= dig, with k spread over
//    the group; ack = same and covc): one instruction each, where width-G
//    `__shfl_xor_sync`s take log2(G) dependent steps per verdict bit. Group
//    lane 0 writes the three flag bytes. With one word per thread there is
//    no register array, so G and the flag set are runtime values: the
//    clock type is the only template parameter, 2 instantiations (there
//    were 16); ptxas (CUDA 12.8): 64 registers for uint32_t lanes, 73 for
//    uint64_t, no spills.
// 2. Few instructions per row, since every row's scalar work runs on its
//    G threads: the row loop is straight-line (columns and rows clamped
//    into the batch, so every load is in bounds and needs no branch; what
//    does not exist is masked after), row offsets are 32-bit, each thread
//    keeps byte pointers to its own columns in registers (`pin`) and
//    reaches a row with one wide multiply-add per load, through the
//    read-only path. (With branches around each conditional load and
//    64-bit row arithmetic the loop was issue-bound at every size.)
// 3. Rows in flight: 256-thread blocks of 256/G rows. A batch gets one
//    block per row tile while one wave of the card (the occupancy API's
//    blocks per SM x SMs) holds every tile of the launch, else its share of
//    that wave in proportion to its tiles, whose blocks stride over the
//    tiles; each step loads the next step's clock lanes and validity
//    before it decides its own row. With a row stride of 0 a thread's
//    watermark and digest lanes are loop-invariant and are loaded once.
// 4. Stats with no zeroing launch and no hot atomics: each block reduces
//    nnz/chk (warp shuffles, then shared memory) to one partial of each.
//    A batch of one block stores them. Otherwise the block adds each into
//    one 64-bit counter of its batch: the low word counts the blocks, the
//    high word sums the stat mod 2^32 (u32 addition wraps, so the order of
//    the adds does not change the bits). The block whose add brings the
//    count to the batch's block count holds the whole sum in the value its
//    atomic returned: it stores the stat with a plain store and sets the
//    counter back to 0. No fence, no second pass over partials: one
//    atomic per block and stat. The counters live in a scratch buffer that
//    is zeroed ONCE and that no two launches in flight together share:
//    an eager launch takes the scratch of its (device, stream), a launch
//    captured into a CUDA graph the scratch of its capture
//    (`crdt_wire_graph_scratch`), and every launch leaves it at 0.
//    Per-block partials summed by the batch's last block would need a fence
//    and a ticket before a second pass: a longer tail. A cluster reduction
//    through distributed shared memory was not taken: at B = 1 it caps a
//    batch at one cluster (8-16 blocks), too few to fill 132 SMs.
// 5. One launch per δ round: the grouped entry packs the slot and parked
//    instances together (82 -> 41 launches per ring at config 3), and the
//    wrapper allocates every output of a launch as one tensor. The
//    instance is found by comparing the block index with the instances'
//    first blocks; a switch then makes its index static, so the kernel
//    reads its descriptor from the constant bank at fixed offsets.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <map>
#include <mutex>
#include <utility>
#include <vector>

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr int kMaxInst = 4;  // instances per grouped launch
constexpr int kMaxBatches = 65536;  // batches per launch (two scratch counters each)
constexpr long long kMaxRows = 1LL << 28;  // rows per batch (32-bit row arithmetic)
constexpr uint32_t kBias = 32768u;
constexpr unsigned kFull = 0xffffffffu;

// One instance of a grouped launch, as the kernel reads it. Row offsets
// within a batch are 32-bit (the entry point refuses larger batches).
struct Inst {
  const void* clocks;
  const void* base;
  const uint8_t* valid;
  const void* know;
  const void* dig;
  const void* winc;
  const uint8_t* ack_ok;
  uint32_t* words;    // [B, N, W]
  uint8_t* keep;      // [B, N] rows of the flags [3, B, N]
  uint8_t* defer;     // [B, N]
  uint8_t* cov;       // [B, N]
  uint32_t* stats;    // [B, 2]: nnz, chk
  unsigned long long* acc;  // [B, 2] counters (scratch), 0 between launches
  long long batches;
  long long base_b, know_b, dig_b;
  int n, base_n, know_n, dig_n;
  int lc, w, log_g, a, ctx_lo, ctx_hi, gated, acked;
  int bpb;     // blocks per batch
  int block0;  // first block of this instance in the grid
};

struct Group {
  Inst inst[kMaxInst];
  int count;
};

// Whether `pred` holds on every thread of the caller's row group (the
// lanes `first` .. `first` + G - 1 of the warp, `gmask` = G low bits).
__device__ __forceinline__ bool group_all(bool pred, unsigned first, unsigned gmask) {
  return ((__ballot_sync(kFull, !pred) >> first) & gmask) == 0u;
}

// `p` kept in a register: the compiler cannot recompute a value that has
// passed through an opaque asm, so the row loop does not rematerialise the
// thread's column addresses from its thread index on every row.
template <typename P>
__device__ __forceinline__ P pin(P p) {
  asm volatile("" : "+l"(p));
  return p;
}

// Read-only global loads of a clock lane (the inputs are not written
// while the kernel runs; `know` may alias `clocks`).
__device__ __forceinline__ uint32_t ldg(const uint32_t* p) { return __ldg(p); }
__device__ __forceinline__ uint64_t ldg(const uint64_t* p) {
  return __ldg(reinterpret_cast<const unsigned long long*>(p));
}

// The element of row `n` of a per-thread column pointer `p` whose rows are
// `stride` bytes apart: one wide multiply-add per address.
template <typename T>
__device__ __forceinline__ T at(const char* __restrict__ p, unsigned n, unsigned stride) {
  return ldg(reinterpret_cast<const T*>(p + (unsigned long long)n * stride));
}

// The blocks of one instance. `in` is a kernel parameter read at fixed
// offsets (the caller's switch makes the index static), so every field
// comes from the constant bank. The row loop is straight-line: each thread
// holds byte pointers to its own columns, clamped into the row, and a row
// past the batch's end is clamped to its last row, so every load is in
// bounds and needs no branch; what does not exist is masked after.
template <typename T>
__device__ __forceinline__ void pack(const Inst& in, int local) {
  __shared__ uint32_t red[2][kWarps];

  const unsigned N = in.n, LC = in.lc, W = in.w, A = in.a, lo = in.ctx_lo, hi = in.ctx_hi;
  const unsigned G = 1u << in.log_g;
  const int bpb = in.bpb;
  const bool gated = in.gated != 0 && A > 0u, acked = in.acked != 0;
  const int b = local / bpb;
  const unsigned tile = local - b * bpb;
  const unsigned j = threadIdx.x & (G - 1);       // lane within the row's group
  const unsigned sub = threadIdx.x >> in.log_g;   // row within the block's step
  const unsigned rpb = kBlock >> in.log_g;        // rows per block per step
  const unsigned step = bpb * rpb;                // rows between a block's steps
  const unsigned first = (threadIdx.x & 31u) & ~(G - 1);
  const unsigned gmask = G == 32u ? kFull : (1u << G) - 1u;

  // This thread's two lanes of wire word j (clamped into the row; masked
  // by `lane` and `real1`), the ctx columns they compare with `know`, and
  // the two digest lanes it checks (k = j, j + G: A <= LC <= 2G).
  const bool lane = j < W, real1 = lane && W + j < LC;
  const unsigned c0 = lane ? j : 0u, c1 = real1 ? W + j : c0;
  const bool x0 = lane && c0 >= lo && c0 < hi, x1 = real1 && c1 >= lo && c1 < hi;
  const bool u0 = j < A, u1 = j + G < A;

  // Byte pointers to this thread's columns of batch b, and row strides.
  // Inputs an instance does not read point at its clocks: never null.
  const long long bn = (long long)b * N;
  const unsigned ts = sizeof(T), rs = LC * ts;
  const char* clk = static_cast<const char*>(in.clocks) + bn * rs;
  const char* __restrict__ pc0 = pin(clk + c0 * ts);
  const char* __restrict__ pc1 = pin(clk + c1 * ts);
  const char* bs = static_cast<const char*>(in.base) + b * in.base_b * ts;
  const char* __restrict__ pb0 = pin(bs + c0 * ts);
  const char* __restrict__ pb1 = pin(bs + c1 * ts);
  const unsigned bstr = in.base_n * ts;
  const char* kn = gated ? static_cast<const char*>(in.know) + b * in.know_b * ts : clk;
  const char* __restrict__ pm0 = pin(kn + (x0 ? c0 - lo : 0u) * ts);
  const char* __restrict__ pm1 = pin(kn + (x1 ? c1 - lo : 0u) * ts);
  const char* __restrict__ pr0 = pin(kn + (u0 ? j : 0u) * ts);
  const char* __restrict__ pr1 = pin(kn + (u1 ? j + G : 0u) * ts);
  const unsigned kstr = in.know_n * ts;
  const char* dg = gated ? static_cast<const char*>(in.dig) + b * in.dig_b * ts : clk;
  const char* __restrict__ pd0 = pin(dg + (u0 ? j : 0u) * ts);
  const char* __restrict__ pd1 = pin(dg + (u1 ? j + G : 0u) * ts);
  const unsigned dstr = in.dig_n * ts;
  const char* wc = acked ? static_cast<const char*>(in.winc) + bn * rs : clk;
  const char* __restrict__ pw0 = pin(wc + c0 * ts);
  const char* __restrict__ pw1 = pin(wc + c1 * ts);
  const uint8_t* __restrict__ val = in.valid + bn;
  const uint8_t* __restrict__ ack = acked ? in.ack_ok + bn : val;
  uint32_t* __restrict__ out = in.words + bn * W + j;
  uint8_t* __restrict__ keep_out = in.keep + bn;
  uint8_t* __restrict__ defer_out = in.defer + bn;
  uint8_t* __restrict__ cov_out = in.cov + bn;

  // Broadcast rows (row stride 0) are loop-invariant: load them once.
  T b0 = at<T>(pb0, 0u, 0u), b1 = at<T>(pb1, 0u, 0u), d0 = T(0), d1 = T(0);
  b1 = real1 ? b1 : T(0);
  if (gated) {
    d0 = at<T>(pd0, 0u, 0u);
    d1 = at<T>(pd1, 0u, 0u);
  }

  uint32_t nnz = 0u, chk = 0u;
  // Each step's clock lanes and validity are loaded one step ahead, so a
  // row's loads are in flight while the previous row is decided.
  unsigned nx = min(tile * rpb + sub, N - 1u);
  T p0 = at<T>(pc0, nx, rs), p1 = at<T>(pc1, nx, rs);
  uint8_t pv = val[nx];
  // The loop bound depends on the block's first row only, so every warp
  // reaches the ballots with all its lanes.
  for (unsigned t0 = tile * rpb; t0 < N; t0 += step) {
    const unsigned row = t0 + sub;
    const bool on = row < N;
    const unsigned n = on ? row : N - 1u;
    const T a0 = p0, a1 = real1 ? p1 : T(0);
    const bool v = pv != 0;
    nx = min(row + step, N - 1u);
    p0 = at<T>(pc0, nx, rs);
    p1 = at<T>(pc1, nx, rs);
    pv = val[nx];
    if (bstr != 0u) {
      b0 = at<T>(pb0, n, bstr);
      const T s1 = at<T>(pb1, n, bstr);
      b1 = real1 ? s1 : T(0);
    }
    const T e0 = a0 - b0 + T(kBias), e1 = a1 - b1 + T(kBias);
    const uint32_t word = (uint32_t)(e0 & T(0xFFFF)) | (uint32_t)(e1 & T(0xFFFF)) << 16;
    const bool fit = group_all(!lane || (e0 < T(65536) && e1 < T(65536)), first, gmask);
    // The digest verdict (ctx == know, know <= dig) and the ack verdict
    // (same, covc); an empty ctx plane gates by validity alone.
    bool digest = in.gated != 0, acked_row = false;
    if (gated) {
      if (dstr != 0u) {
        d0 = at<T>(pd0, n, dstr);
        d1 = at<T>(pd1, n, dstr);
      }
      const T m0 = at<T>(pm0, n, kstr), m1 = at<T>(pm1, n, kstr);
      const T r0 = at<T>(pr0, n, kstr), r1 = at<T>(pr1, n, kstr);
      digest = group_all((!x0 || a0 == m0) && (!x1 || a1 == m1) && (!u0 || r0 <= d0) &&
                             (!u1 || r1 <= d1),
                         first, gmask);
    }
    if (acked) {
      const T w0 = at<T>(pw0, n, rs), s1 = at<T>(pw1, n, rs), w1 = real1 ? s1 : T(0);
      const bool window = group_all(
          !lane || ((x0 ? a0 <= w0 : a0 == w0) && (x1 ? a1 <= w1 : a1 == w1)), first, gmask);
      acked_row = ack[n] != 0 && window;
    }
    const bool cov_d = v && digest;
    const bool cov_a = v && !cov_d && acked_row;
    const bool live = v && !cov_d && !cov_a;
    const bool keep = live && fit;
    const uint32_t wd = keep ? word : 0u;
    if (on && lane) {
      out[(unsigned long long)n * W] = wd;
      nnz += wd != 0u;
      chk += wd * (2u * (n * W + j) + 1u);
    }
    if (on && j == 0u) {
      keep_out[n] = keep;
      defer_out[n] = live && !fit;
      cov_out[n] = cov_a;
    }
  }

  // The block's sums, then into the batch's two counters.
  const int warp = threadIdx.x >> 5, ln = threadIdx.x & 31;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    nnz += __shfl_down_sync(kFull, nnz, off);
    chk += __shfl_down_sync(kFull, chk, off);
  }
  if (ln == 0) {
    red[0][warp] = nnz;
    red[1][warp] = chk;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  uint32_t sum[2] = {0u, 0u};
  for (int w = 0; w < kWarps; ++w) {
    sum[0] += red[0][w];
    sum[1] += red[1][w];
  }
  uint32_t* stats = in.stats + 2 * b;
  if (bpb == 1) {
    stats[0] = sum[0];
    stats[1] = sum[1];
    return;
  }
  // One 64-bit atomic per block and stat: the block count in the low word,
  // the stat's running sum mod 2^32 in the high word (its carry leaves the
  // word). The block that brings the count to bpb holds the whole sum in
  // what its atomic returned, stores it and sets the counter back to 0.
  unsigned long long* acc = in.acc + 2 * b;
  for (int k = 0; k < 2; ++k) {
    const unsigned long long old =
        atomicAdd(acc + k, (unsigned long long)sum[k] << 32 | 1ull);
    if ((uint32_t)old == (uint32_t)(bpb - 1)) {
      stats[k] = (uint32_t)(old >> 32) + sum[k];
      acc[k] = 0ull;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kBlock) wire_kernel(const __grid_constant__ Group grp) {
  const int bid = blockIdx.x;
  int i = 0;
#pragma unroll
  for (int k = 1; k < kMaxInst; ++k)
    if (k < grp.count && bid >= grp.inst[k].block0) i = k;
  switch (i) {
    case 0: pack<T>(grp.inst[0], bid - grp.inst[0].block0); break;
    case 1: pack<T>(grp.inst[1], bid - grp.inst[1].block0); break;
    case 2: pack<T>(grp.inst[2], bid - grp.inst[2].block0); break;
    default: pack<T>(grp.inst[3], bid - grp.inst[3].block0); break;
  }
}
static_assert(kMaxInst == 4, "wire_kernel's switch has one case per instance");

// Blocks one wave of wire_kernel<T> holds on the current device.
template <typename T>
int resident_blocks() {
  static int cached[64][2];  // [device][sms, blocks per SM]
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  int* c = cached[dev];
  if (c[0] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wire_kernel<T>, kBlock, 0) !=
            cudaSuccess)
      return 0;
    c[1] = per_sm;
    c[0] = sms;
  }
  return c[0] * c[1];
}

// Host-side descriptor layout (int64 each), one row per instance.
enum Desc {
  kClocks, kBase, kValid, kKnow, kDig, kWinc, kAckOk, kWords, kFlags, kStats,
  kB, kN, kLC, kA, kCtxLo, kCtxHi, kGated, kAcked,
  kBaseB, kBaseN, kKnowB, kKnowN, kDigB, kDigN, kDescLen
};

// (N - 1) * row stride + lanes, the span of a batch's rows in elements,
// fits the kernel's 32-bit row offsets.
bool fits32(long long n, long long stride, long long lanes) {
  return (n - 1) * stride + lanes <= INT_MAX;
}

// log2 of the row-group width of a row of LC lanes, and its row tiles.
int group_log(long long lc) {
  int log_g = 0;
  while ((1LL << log_g) < (lc + 1) / 2) ++log_g;
  return log_g;
}
long long row_tiles(long long n, int log_g) {
  return (n + (kBlock >> log_g) - 1) / (kBlock >> log_g);
}

template <typename T>
int launch(Group& grp, int count, const long long* desc, uint32_t* scratch,
           long long scratch_words, cudaStream_t s) {
  long long batches = 0, tiles_all = 0;
  for (int i = 0; i < count; ++i) {
    const long long* d = desc + (long long)i * kDescLen;
    batches += d[kB];
    tiles_all += d[kB] * row_tiles(d[kN], group_log(d[kLC]));
  }
  const int resident = resident_blocks<T>();
  if (resident < 1) {
    const cudaError_t e = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : cudaErrorUnknown);
  }
  if (batches > kMaxBatches || 4 * batches > scratch_words) return (int)cudaErrorInvalidValue;
  long long blocks = 0, first_batch = 0;
  for (int i = 0; i < count; ++i) {
    const long long* d = desc + (long long)i * kDescLen;
    Inst& in = grp.inst[i];
    const long long B = d[kB], N = d[kN], LC = d[kLC];
    const int log_g = group_log(LC);
    // Blocks per batch: one per row tile while one wave holds them all,
    // else the batch's share of one wave in proportion to its tiles (at
    // least one), each block then striding over several tiles.
    const long long tiles = row_tiles(N, log_g);
    const long long share = tiles * resident / tiles_all;
    const long long bpb = tiles_all <= resident ? tiles : (share > 1 ? share : 1);
    in.clocks = reinterpret_cast<const void*>(d[kClocks]);
    in.base = reinterpret_cast<const void*>(d[kBase]);
    in.valid = reinterpret_cast<const uint8_t*>(d[kValid]);
    in.know = reinterpret_cast<const void*>(d[kKnow]);
    in.dig = reinterpret_cast<const void*>(d[kDig]);
    in.winc = reinterpret_cast<const void*>(d[kWinc]);
    in.ack_ok = reinterpret_cast<const uint8_t*>(d[kAckOk]);
    in.words = reinterpret_cast<uint32_t*>(d[kWords]);
    in.keep = reinterpret_cast<uint8_t*>(d[kFlags]);
    in.defer = in.keep + B * N;
    in.cov = in.defer + B * N;
    in.stats = reinterpret_cast<uint32_t*>(d[kStats]);
    in.acc = reinterpret_cast<unsigned long long*>(scratch) + 2 * first_batch;
    in.batches = B;
    in.base_b = d[kBaseB];
    in.know_b = d[kKnowB];
    in.dig_b = d[kDigB];
    in.n = (int)N;
    in.base_n = (int)d[kBaseN];
    in.know_n = (int)d[kKnowN];
    in.dig_n = (int)d[kDigN];
    in.lc = (int)LC;
    in.w = (int)(LC + 1) / 2;
    in.log_g = log_g;
    in.a = (int)d[kA];
    in.ctx_lo = (int)d[kCtxLo];
    in.ctx_hi = (int)d[kCtxHi];
    in.gated = d[kGated] != 0;
    in.acked = d[kAcked] != 0;
    in.bpb = (int)bpb;
    in.block0 = (int)blocks;
    blocks += B * bpb;
    first_batch += B;
  }
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  wire_kernel<T><<<(unsigned)blocks, kBlock, 0, s>>>(grp);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes): one launch of K3 over `count`
// instances (1..4) whose clock lanes are `clock_bytes` wide (4: uint32_t,
// 8: uint64_t). `desc` holds `count` rows of 24 int64 in `Desc` order:
// the pointers clocks, base, valid, know, dig, winc, ack_ok (know/dig read
// only when gated, winc/ack_ok only when acked), words, flags, stats; then
// B, N, LC, A, ctx_lo, ctx_hi, gated, acked; then the batch and row element
// strides (>= 0) of base, know and dig, whose lanes are unit-stride.
// `clocks`, `valid`, `winc`, `ack_ok` and the outputs are contiguous;
// `valid`, `ack_ok` and the flags [3, B, N] (keep, defer, covered) are one
// byte per row; `stats` is uint32 [B, 2] (nnz, chk). The kernel writes
// every output: nothing need be zeroed. `scratch` holds `scratch_words`
// uint32, all 0 (every launch leaves them at 0), of which a launch uses two
// uint64 counters per batch (at most 65,536 batches); no two launches in
// flight at once may share it. A batch holds at most 2^28 rows, spanning
// under 2^31 elements of each input.
// Returns the cudaError_t of the launch (0 = cudaSuccess).
extern "C" int crdt_wire_pack_many(int clock_bytes, int count, const long long* desc,
                                   void* scratch, long long scratch_words, void* stream) {
  if (count < 1 || count > kMaxInst || (clock_bytes != 4 && clock_bytes != 8) ||
      desc == nullptr || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < count; ++i) {
    const long long* d = desc + (long long)i * kDescLen;
    const long long B = d[kB], N = d[kN], LC = d[kLC];
    const bool gated = d[kGated] != 0, acked = d[kAcked] != 0;
    if (B < 1 || N < 1 || N > kMaxRows || LC < 1 || LC > 64 || d[kCtxLo] < 0 || d[kCtxLo] > d[kCtxHi] ||
        d[kCtxHi] > LC || (gated && d[kA] != d[kCtxHi] - d[kCtxLo]) ||
        (d[kBaseB] | d[kBaseN] | d[kKnowB] | d[kKnowN] | d[kDigB] | d[kDigN]) < 0 ||
        !fits32(N, LC, LC) || !fits32(N, d[kBaseN], LC) ||
        (gated && (!fits32(N, d[kKnowN], d[kA]) || !fits32(N, d[kDigN], d[kA]))) ||
        !d[kClocks] || !d[kBase] || !d[kValid] || !d[kWords] || !d[kFlags] || !d[kStats] ||
        (gated && (!d[kKnow] || !d[kDig])) || (acked && (!d[kWinc] || !d[kAckOk])))
      return (int)cudaErrorInvalidValue;
  }
  (void)cudaGetLastError();  // clear a stale error so the check below is ours
  Group grp{};
  grp.count = count;
  const auto s = static_cast<cudaStream_t>(stream);
  auto* sc = static_cast<uint32_t*>(scratch);
  if (clock_bytes == 4) return launch<uint32_t>(grp, count, desc, sc, scratch_words, s);
  return launch<uint64_t>(grp, count, desc, sc, scratch_words, s);
}

// ---- the stats scratch of a captured launch --------------------------------
//
// A graph's replays are ordered behind one another, but two graphs may be
// replayed on two streams at once, and a graph may run beside eager
// launches. So a launch captured into a graph must not count in the scratch
// of its capture stream: it gets a scratch that belongs to its capture. The
// scratch is allocated and zeroed outside the graph (no node joins it), and
// a CUDA user object hands it back to a free list when the graph and its
// executable graphs are destroyed, after their last launch. Every launch
// leaves the counters at 0, but a scratch taken from the free list is
// zeroed again all the same.

namespace {

struct GraphScratch {
  void* ptr;
  long long bytes;
  unsigned long long capture;
  void* stream;
};

std::mutex g_mu;
std::map<std::pair<unsigned long long, void*>, GraphScratch*> g_live;  // by (capture, stream)
std::vector<std::pair<void*, long long>> g_free;  // scratch of destroyed graphs

// Runs on a CUDA thread when the last graph holding the scratch is gone:
// no CUDA call may be made here.
void CUDART_CB release_scratch(void* data) {
  auto* gs = static_cast<GraphScratch*>(data);
  std::lock_guard<std::mutex> lock(g_mu);
  g_live.erase({gs->capture, gs->stream});
  g_free.emplace_back(gs->ptr, gs->bytes);
  delete gs;
}

// Zeroes `bytes` at `p` and waits, on a stream of its own that no capture
// holds.
cudaError_t zero_outside(void* p, long long bytes) {
  cudaStream_t side = nullptr;
  cudaError_t e = cudaStreamCreateWithFlags(&side, cudaStreamNonBlocking);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(p, 0, (size_t)bytes, side);
  const cudaError_t w = cudaStreamSynchronize(side);
  cudaStreamDestroy(side);
  return e != cudaSuccess ? e : w;
}

}  // namespace

// The stats scratch (`bytes`, zeroed) of K3 launches on `stream` while
// `stream` is capturing a CUDA graph: one per (capture, stream), owned by
// the graph being captured. Sets `*out` to null when `stream` is not
// capturing. Returns a cudaError_t (0 = cudaSuccess).
extern "C" int crdt_wire_graph_scratch(void* stream, long long bytes, void** out) {
  if (out == nullptr || bytes <= 0) return (int)cudaErrorInvalidValue;
  *out = nullptr;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long capture = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, &capture, &graph);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return 0;
  void* p = nullptr;
  {
    std::lock_guard<std::mutex> lock(g_mu);
    const auto it = g_live.find({capture, stream});
    if (it != g_live.end() && it->second->bytes >= bytes) {
      *out = it->second->ptr;
      return 0;
    }
    if (it != g_live.end()) return (int)cudaErrorInvalidValue;
    for (size_t i = 0; i < g_free.size(); ++i) {
      if (g_free[i].second == bytes) {
        p = g_free[i].first;
        g_free.erase(g_free.begin() + (long)i);
        break;
      }
    }
  }
  // The capture forbids allocating and waiting on this thread unless its
  // mode is relaxed; the work goes to memory and a stream the capture does
  // not hold, so it records nothing into the graph.
  cudaStreamCaptureMode mode = cudaStreamCaptureModeRelaxed;
  e = cudaThreadExchangeStreamCaptureMode(&mode);
  if (e != cudaSuccess) return (int)e;
  if (p == nullptr) e = cudaMalloc(&p, (size_t)bytes);
  if (e == cudaSuccess) e = zero_outside(p, bytes);
  cudaThreadExchangeStreamCaptureMode(&mode);
  if (e != cudaSuccess) return (int)e;
  auto* gs = new GraphScratch{p, bytes, capture, stream};
  cudaUserObject_t obj = nullptr;
  e = cudaUserObjectCreate(&obj, gs, release_scratch, 1, cudaUserObjectNoDestructorSync);
  if (e != cudaSuccess) {
    delete gs;
    std::lock_guard<std::mutex> lock(g_mu);
    g_free.emplace_back(p, bytes);
    return (int)e;
  }
  {
    std::lock_guard<std::mutex> lock(g_mu);
    g_live[{capture, stream}] = gs;
  }
  e = cudaGraphRetainUserObject(graph, obj, 1, cudaGraphUserObjectMove);
  if (e != cudaSuccess) {
    cudaUserObjectRelease(obj, 1);  // the destructor returns the scratch
    return (int)e;
  }
  *out = p;
  return 0;
}

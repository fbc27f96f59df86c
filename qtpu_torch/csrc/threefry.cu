// Threefry-2x32 protocol randomness for Hopper (sm_90a), bit for bit
// jax.random's default PRNG in its partitionable mode.
//
// Replaces what XLA fused inside each jitted window program of the
// reference: qtpu/window_programs.py:280-308 (_block_keys, _keys_at,
// _seed_rows_at, _seed_rows: per-block keys folded by global block index,
// then LSB-first bit rows of jax.random.bits) and :339 (the per-block test
// offsets, jax.random.randint), i.e. jax.random's threefry2x32 with
// jax_threefry_partitionable=True.  In the partitionable mode, for every
// shape below 2^32 elements,
//
//     fold_in(k, d)    = threefry(k, (0, d))             (both words)
//     split(k, n)[i]   = threefry(k, (0, i))             (both words)
//     bits(k, (W,))[j] = x0 ^ x1 of threefry(k, (0, j))
//
// (qtpu_torch/random.py states the same layout; its plain PyTorch
// functions are this file's oracle, on the CPU and on the card).
//
// Two entry points, all on uint32 words:
//  * qtpu_threefry_draws: a table of up to kMaxDraws draws in one launch.
//    Each draw is one of
//      - seed rows: (b, length) uint8 bit rows.  Row i's key is
//        fold_in(... fold_in(key, tag) ..., row_i), row_i = row0 + i or
//        rows[i]; word j of the row is bits(key_i, (W,))[j], written
//        LSB-first as 32 bytes, the last word cut at `length`;
//      - randint: (b,) int64, jax.random.randint(key_i, (), 0, span,
//        uint32) on the same row keys (split into two keys, one word of
//        bits from each, JAX's two-word remainder in uint32 arithmetic).
//  * qtpu_threefry_hash: keys (K, 2) x counters -> (K, W, 2) words or
//    (K, W) x0 ^ x1, for fold_in, split, bits and uniform on any caller's
//    key tensors.  Int64 at the edges, uint32 values, as random.py keeps
//    them.
//
// What bounds it on an H100.  The largest draw on the main path is the PA
// seed: 128 rows of P + l_max - 1 = 110,460 bits (14.1 MB of uint8) at the
// production rung, 441,856 cipher calls.  Writing 14.1 MB takes 4.2 us at
// 3.35 TB/s.  A word's cipher call, its counter's high word 0, is 72 int32
// operations: 31 adds (x1's first key word, an add a round, 5 injections
// of two) and 41 shifts and xors (a funnel-shift rotate and an xor a
// round, the output's x0 ^ x1).  The adds may issue as IMAD on the FMA
// pipe, so the floor is the 41 on the 64-lane INT32 pipe: 18.1 M of them,
// ~1.1 us at 16.7 T/s (64 lanes an SM x 132 SMs x 1.98 GHz).  So the PA
// seed is bound by its bytes, and every other draw (a verify seed of 1,986
// words, 128 offsets, a puncture pad of 8,192 words) by the launch itself:
// the window programs draw 2-4 of those each, so the host's launches
// (a ctypes call each) cost more than the card's work.
//
// What the design does about it.
//  * One launch per table: a window program passes all of its draws at
//    once, by value in the kernel's parameters (no copy to the card), and
//    one grid covers them all; a block finds its draw from the prefix
//    block offsets in the table.  The key chain of a draw's tags is the
//    same for all its rows, so the entry point folds it on the host.
//  * Seed rows: a block of kThreads owns a segment of kSegWords words of
//    one row (7 blocks for a PA seed row).  One thread folds the row into
//    the key (one cipher call) and shares it through shared memory; the
//    block then computes the segment's words into shared memory (2 a
//    thread) and writes the row's bytes as 16-byte stores at 16-byte
//    aligned addresses, 512 contiguous bytes a warp instruction.  A store
//    takes its 16 bits from one or two words with a funnel shift, so a
//    row that starts off alignment (110,460-byte rows do) is written as
//    fast as an aligned one; segments end on 16-byte aligned addresses,
//    the few bytes before a row's first and after its last aligned
//    address are byte stores, and no byte past `length` is written.
//  * Randint: a thread a row, five cipher calls (the row's fold, the
//    split, one word from each half).
//
// Each entry point launches on the caller's stream, does not synchronise
// and returns cudaGetLastError() after its launch (0 on success), or -1
// for arguments it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

// One draw of a table, as the caller fills it (qtpu_torch/random.py's
// _DrawEntry mirrors this layout).
struct QtpuDraw {
  int32_t kind;          // 0: seed rows, 1: randint
  int32_t ntags;         // 0-2
  uint32_t key[2];       // the draw's key words
  uint32_t tag[2];       // tags folded into the key, in order
  const int64_t* rows;   // device (b,) int64 row index, or null: row0 + i
  uint32_t row0;
  int32_t b;             // rows
  long long size;        // seed rows: bits a row; randint: span (< 2^32)
  void* out;             // (b, size) uint8 or (b,) int64, contiguous
};

namespace {

constexpr int kMaxDraws = 8;
constexpr int kThreads = 256;              // threads a block
constexpr int kSegWords = 512;             // words a seed-row block owns
constexpr long long kSegBytes = 32LL * kSegWords;
enum Kind { kSeedRows = 0, kRandint = 1 };

__host__ __device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// The Threefry-2x32 block cipher, 20 rounds, in place on (x0, x1); the
// rotations (13, 15, 26, 6) in even groups of four rounds, (17, 29, 16,
// 24) in odd ones.
__host__ __device__ __forceinline__ void threefry2x32(uint32_t k0,
                                                      uint32_t k1,
                                                      uint32_t& x0,
                                                      uint32_t& x1) {
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl(x1, rot[g & 1][i]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
}

// fold_in: the key becomes threefry(key, (0, d)).
__host__ __device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                                 uint32_t d) {
  uint32_t x0 = 0, x1 = d;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// A draw as the kernel reads it: the key with its tags folded in, and the
// first block of the launch's grid that works on it.
struct Job {
  uint32_t k0, k1;
  const int64_t* rows;
  uint32_t row0;
  int32_t kind;
  int32_t b;
  int32_t segs;          // seed rows: blocks a row
  long long size;        // bits a row, or the span
  void* out;
  long long first;       // first block
};

struct Jobs {
  int32_t n;
  Job job[kMaxDraws];
};

__device__ __forceinline__ uint32_t row_of(const Job& J, long long i) {
  return J.rows ? (uint32_t)J.rows[i] : J.row0 + (uint32_t)i;
}

// Bits q..q+3 of a nibble to bytes 0..3: bit q lands on bit 8q.
__device__ __forceinline__ uint32_t spread4(uint32_t v) {
  return ((v & 0xFu) * 0x00204081u) & 0x01010101u;
}

// Segment `seg` of row i: the row's bytes [lo, hi), where lo and hi are
// 16-byte aligned addresses (or the row's ends).
__device__ void seed_segment(const Job& J, long long i, long long seg,
                             uint32_t* key, uint32_t* words) {
  const int tid = threadIdx.x;
  const long long length = J.size;
  uint8_t* row = static_cast<uint8_t*>(J.out) + i * length;
  const long long mis = (long long)((uintptr_t)row & 15);
  long long lo = seg * kSegBytes - mis;
  long long hi = lo + kSegBytes;
  lo = lo < 0 ? 0 : lo;
  hi = hi > length ? length : hi;
  if (lo >= hi) return;                     // (uniform in the block)
  if (tid == 0) {
    uint32_t k0 = J.k0, k1 = J.k1;
    fold_in(k0, k1, row_of(J, i));
    key[0] = k0;
    key[1] = k1;
  }
  __syncthreads();
  const uint32_t k0 = key[0], k1 = key[1];
  const long long w_lo = lo >> 5;
  const int nw = (int)(((hi + 31) >> 5) - w_lo);
  for (int w = tid; w < nw; w += kThreads) {
    uint32_t x0 = 0, x1 = (uint32_t)(w_lo + w);
    threefry2x32(k0, k1, x0, x1);
    words[w] = x0 ^ x1;
  }
  if (tid == 0) words[nw] = 0;             // read, masked, by the last store
  __syncthreads();
  // The bytes before the first aligned address, then 16-byte stores, then
  // the bytes after the last one.
  const long long a0 = lo + ((16 - ((mis + lo) & 15)) & 15);
  const long long head = (a0 < hi ? a0 : hi) - lo;
  const long long full = a0 < hi ? (hi - a0) >> 4 : 0;
  const long long tail0 = a0 + 16 * full;
  const long long tail = a0 < hi ? hi - tail0 : 0;
  for (long long c = tid; c < full; c += kThreads) {
    const long long o = a0 + 16 * c;
    const int w = (int)((o >> 5) - w_lo);
    const uint32_t v = __funnelshift_r(words[w], words[w + 1], (int)(o & 31));
    *reinterpret_cast<uint4*>(row + o) = make_uint4(
        spread4(v), spread4(v >> 4), spread4(v >> 8), spread4(v >> 12));
  }
  if (tid < head + tail) {
    const long long o = tid < head ? lo + tid : tail0 + (tid - head);
    row[o] = (uint8_t)((words[(o >> 5) - w_lo] >> (o & 31)) & 1u);
  }
}

// Row i's offset: randint(key_i, (), 0, span) as JAX computes it.
__device__ void randint_row(const Job& J, long long i) {
  uint32_t k0 = J.k0, k1 = J.k1;
  fold_in(k0, k1, row_of(J, i));
  // split(k, 2): the two keys threefry(k, (0, 0)) and threefry(k, (0, 1)).
  uint32_t h0 = 0, h1 = 0, l0 = 0, l1 = 1;
  threefry2x32(k0, k1, h0, h1);
  threefry2x32(k0, k1, l0, l1);
  // bits(key, (1,))[0] of each.
  uint32_t a0 = 0, a1 = 0, c0 = 0, c1 = 0;
  threefry2x32(h0, h1, a0, a1);
  threefry2x32(l0, l1, c0, c1);
  const uint32_t higher = a0 ^ a1, lower = c0 ^ c1;
  // JAX's remainder of the 64-bit draw, in wrapping uint32 arithmetic.
  const uint32_t span = (uint32_t)J.size;
  uint32_t multiplier = 65536u % span;
  multiplier = (multiplier * multiplier) % span;
  uint32_t offset = (higher % span) * multiplier;
  offset += lower % span;
  static_cast<int64_t*>(J.out)[i] = (int64_t)(offset % span);
}

__global__ void __launch_bounds__(kThreads)
draws_kernel(const __grid_constant__ Jobs jobs) {
  __shared__ uint32_t key[2];
  __shared__ uint32_t words[kSegWords + 2];
  int d = 0;
  while (d + 1 < jobs.n && (long long)blockIdx.x >= jobs.job[d + 1].first)
    ++d;
  const Job& J = jobs.job[d];
  const long long local = (long long)blockIdx.x - J.first;
  if (J.kind == kSeedRows) {
    seed_segment(J, local / J.segs, local % J.segs, key, words);
  } else {
    const long long i = local * kThreads + threadIdx.x;
    if (i < J.b) randint_row(J, i);
  }
}

__global__ void hash_kernel(const int64_t* __restrict__ keys, long long K,
                            const int64_t* __restrict__ counts,
                            uint32_t count0, long long W, int pair,
                            int64_t* __restrict__ out) {
  const long long total = K * W;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long k = K == 1 ? 0 : t / W;
    const long long j = t - k * W;
    uint32_t x0 = 0;
    uint32_t x1 = counts ? (uint32_t)counts[j] : count0 + (uint32_t)j;
    threefry2x32((uint32_t)keys[2 * k], (uint32_t)keys[2 * k + 1], x0, x1);
    if (pair) {
      reinterpret_cast<longlong2*>(out)[t] =
          make_longlong2((long long)x0, (long long)x1);
    } else {
      out[t] = (int64_t)(x0 ^ x1);
    }
  }
}

}  // namespace

// `n` draws of `table` (host memory, read before this returns) in one
// launch.  -1: n outside [1, kMaxDraws], a kind, tag count, row count or
// size it does not take (b and size positive, a span below 2^32), or a
// grid of 2^31 blocks or more.
extern "C" int qtpu_threefry_draws(const QtpuDraw* table, int n,
                                   void* stream) {
  if (n < 1 || n > kMaxDraws) return -1;
  Jobs jobs = {};
  jobs.n = n;
  long long blocks = 0;
  for (int d = 0; d < n; ++d) {
    const QtpuDraw& D = table[d];
    if (D.ntags < 0 || D.ntags > 2 || D.b <= 0 || D.size <= 0
        || (D.kind != kSeedRows && D.kind != kRandint)
        || (D.kind == kRandint && D.size >= (1LL << 32)))
      return -1;
    Job& J = jobs.job[d];
    J.k0 = D.key[0];
    J.k1 = D.key[1];
    for (int t = 0; t < D.ntags; ++t) fold_in(J.k0, J.k1, D.tag[t]);
    J.rows = D.rows;
    J.row0 = D.row0;
    J.kind = D.kind;
    J.b = D.b;
    J.size = D.size;
    J.out = D.out;
    J.first = blocks;
    // A segment boundary lies at every kSegBytes-th aligned address of a
    // row, so a row of `size` bytes starting anywhere spans at most
    // ceil((size + 15) / kSegBytes) segments.
    J.segs = D.kind == kSeedRows
                 ? (int)((D.size + 15 + kSegBytes - 1) / kSegBytes) : 0;
    blocks += D.kind == kSeedRows ? (long long)D.b * J.segs
                                  : (D.b + kThreads - 1) / kThreads;
  }
  if (blocks >= (1LL << 31)) return -1;
  draws_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(jobs);
  return (int)cudaGetLastError();
}

// keys (K, 2) int64 x counters -> `out`: (K, W, 2) words when `pair`,
// else (K, W) x0 ^ x1, all int64 holding uint32.  Counter j is counts[j]
// (a device int64 (W,)) or count0 + j when `counts` is null.  -1: K or W
// not positive.
extern "C" int qtpu_threefry_hash(const int64_t* keys, long long K,
                                  const int64_t* counts, uint32_t count0,
                                  long long W, int pair, int64_t* out,
                                  void* stream) {
  if (K <= 0 || W <= 0) return -1;
  const int threads = 256;
  const long long need = (K * W + threads - 1) / threads;
  const unsigned blocks = (unsigned)(need < (1 << 20) ? need : (1 << 20));
  hash_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      keys, K, counts, count0, W, pair, out);
  return (int)cudaGetLastError();
}

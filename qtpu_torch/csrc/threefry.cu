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
// Three entry points, all on uint32 words:
//  * qtpu_threefry_seed_rows: (b, length) uint8 bit rows.  Row i's key is
//    fold_in(... fold_in(key, tag) ..., row_i), row_i = row0 + i or
//    rows[i]; word j of the row is bits(key_i, (W,))[j], written LSB-first
//    as 32 bytes, the last word cut at `length`.
//  * qtpu_threefry_randint: (b,) int64, jax.random.randint(key_i, (), 0,
//    span, uint32) on the same row keys (split into two keys, one word of
//    bits from each, JAX's two-word remainder in uint32 arithmetic).
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
// words, 128 offsets, a puncture pad of 8,192 words) by the launch itself.
//
// What the design does about it.
//  * One launch per draw: the key chain, the cipher and the bit unpack are
//    fused, so no key or word ever goes to device memory, and the window
//    programs launch one kernel where the eager int64 ops launched ~175
//    per cipher call.
//  * The row key chain (1-3 cipher calls) is recomputed by every thread of
//    the row, not shared: sharing it through shared memory would cost a
//    barrier and a serial chain in one thread per block, while the copy in
//    each thread runs in parallel and, where the work is large enough to
//    matter (the PA seed), is spread over 4 chunks a warp (+25% cipher
//    work on top of the one call a word).
//  * A warp owns 32 consecutive words (1,024 output bytes) of one row.
//    Each lane computes its word, then in 8 passes the lanes fetch the
//    nibble they write with a warp shuffle, so each pass stores 128
//    contiguous bytes, 4 a lane (one 32-bit store where the row is 4-byte
//    aligned, else four byte stores), and no byte past `length` is
//    written.
//  * Rows lie on the grid's y axis (a grid-stride loop above 65,535), the
//    row's 32-word chunks on its x axis.
//
// Each entry point launches on the caller's stream, does not synchronise
// and returns cudaGetLastError() after its launch (0 on success), or -1
// for arguments it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;                  // warps a seed-row block
constexpr int kFullCard = 132 * 64;        // warps the card holds at once
constexpr int kRowsPerGrid = 65535;        // gridDim.y limit

__device__ __forceinline__ int rotation(int g, int i) {
  // (13, 15, 26, 6) in even groups of four rounds, (17, 29, 16, 24) in odd
  return (g & 1) ? (i == 0 ? 17 : i == 1 ? 29 : i == 2 ? 16 : 24)
                 : (i == 0 ? 13 : i == 1 ? 15 : i == 2 ? 26 : 6);
}

// The Threefry-2x32 block cipher, 20 rounds, in place on (x0, x1).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = __funnelshift_l(x1, x1, rotation(g, i)) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + (uint32_t)(g + 1);
  }
}

// fold_in: the key becomes threefry(key, (0, d)).
__device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                        uint32_t d) {
  uint32_t x0 = 0, x1 = d;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

// Row i's key: fold_in(... fold_in(key, tag0) ..., row_i).
__device__ __forceinline__ void row_key(uint32_t& k0, uint32_t& k1,
                                        int ntags, uint32_t tag0,
                                        uint32_t tag1,
                                        const int64_t* __restrict__ rows,
                                        uint32_t row0, int i) {
  if (ntags > 0) fold_in(k0, k1, tag0);
  if (ntags > 1) fold_in(k0, k1, tag1);
  fold_in(k0, k1, rows ? (uint32_t)rows[i] : row0 + (uint32_t)i);
}

__global__ void __launch_bounds__(32 * kWarps)
seed_rows_kernel(uint32_t key0, uint32_t key1, int ntags, uint32_t tag0,
                 uint32_t tag1, const int64_t* __restrict__ rows,
                 uint32_t row0, int b, long long length, long long chunks,
                 uint8_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long first = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long stride = (long long)gridDim.x * kWarps;
  // Pass p stores bytes [128p, 128p + 128) of the warp's 1,024: lane l
  // writes 4 of them, nibble (l & 7) of the chunk's word 4p + (l >> 3).
  const int src = lane >> 3;
  const int nibble_shift = 4 * (lane & 7);
  for (int i = blockIdx.y; i < b; i += gridDim.y) {
    uint32_t k0 = key0, k1 = key1;
    row_key(k0, k1, ntags, tag0, tag1, rows, row0, i);
    uint8_t* row = out + (long long)i * length;
    const bool aligned = ((uintptr_t)row & 3) == 0;
    for (long long c = first; c < chunks; c += stride) {
      uint32_t x0 = 0, x1 = (uint32_t)(c * 32 + lane);
      threefry2x32(k0, k1, x0, x1);
      const uint32_t word = x0 ^ x1;
      const long long base = c * 1024 + 4 * lane;
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        const uint32_t v = __shfl_sync(0xffffffffu, word, 4 * p + src);
        // Bits 0-3 of the nibble to bytes 0-3: bit q lands on bit 8q.
        const uint32_t four = (((v >> nibble_shift) & 0xFu) * 0x00204081u)
                              & 0x01010101u;
        const long long pos = base + 128 * p;
        if (aligned && pos + 4 <= length) {
          *reinterpret_cast<uint32_t*>(row + pos) = four;
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (pos + q < length) row[pos + q] = (uint8_t)(four >> (8 * q));
        }
      }
    }
  }
}

__global__ void randint_kernel(uint32_t key0, uint32_t key1, int ntags,
                               uint32_t tag0, uint32_t tag1,
                               const int64_t* __restrict__ rows,
                               uint32_t row0, int b, uint32_t span,
                               int64_t* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b) return;
  uint32_t k0 = key0, k1 = key1;
  row_key(k0, k1, ntags, tag0, tag1, rows, row0, i);
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
  uint32_t multiplier = 65536u % span;
  multiplier = (multiplier * multiplier) % span;
  uint32_t offset = (higher % span) * multiplier;
  offset += lower % span;
  out[i] = (int64_t)(offset % span);
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

// (b, length) uint8 bit rows into `out` (contiguous); `rows` is a device
// int64 (b,) index or null for row0 + i.  -1: b or length not positive,
// more than two tags.
extern "C" int qtpu_threefry_seed_rows(uint32_t k0, uint32_t k1, int ntags,
                                       uint32_t tag0, uint32_t tag1,
                                       const int64_t* rows, uint32_t row0,
                                       int b, long long length, uint8_t* out,
                                       void* stream) {
  if (b <= 0 || length <= 0 || ntags < 0 || ntags > 2) return -1;
  const long long words = (length + 31) / 32;
  const long long chunks = (words + 31) / 32;
  // Four chunks a warp once the draw fills the card (the key chain then
  // costs a quarter of a cipher call a word), else one (more warps).
  const int per_warp = (long long)b * chunks >= kFullCard ? 4 : 1;
  const long long gx = (chunks + kWarps * per_warp - 1) / (kWarps * per_warp);
  const dim3 grid((unsigned)gx, (unsigned)(b < kRowsPerGrid ? b : kRowsPerGrid));
  seed_rows_kernel<<<grid, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      k0, k1, ntags, tag0, tag1, rows, row0, b, length, chunks, out);
  return (int)cudaGetLastError();
}

// (b,) int64 offsets in [0, span) into `out`; `rows` as above.  -1: b not
// positive, span 0, more than two tags.
extern "C" int qtpu_threefry_randint(uint32_t k0, uint32_t k1, int ntags,
                                     uint32_t tag0, uint32_t tag1,
                                     const int64_t* rows, uint32_t row0,
                                     int b, uint32_t span, int64_t* out,
                                     void* stream) {
  if (b <= 0 || span == 0 || ntags < 0 || ntags > 2) return -1;
  const int threads = 128;
  randint_kernel<<<(b + threads - 1) / threads, threads, 0,
                   (cudaStream_t)stream>>>(k0, k1, ntags, tag0, tag1, rows,
                                           row0, b, span, out);
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

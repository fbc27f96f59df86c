// The window programs' verify hash and Bob's decode tail for Hopper (sm_90a).
//
// Replaces what XLA fused inside the reference's jitted window programs:
// qtpu/window_programs.py:364-387 (_vmatrix, _verify_hash: the GF(2)
// Toeplitz hash of a (b, P) payload against ONE window-level seed t of
// P + Vh - 1 bits, hash bit j = parity(sum_i x[i] t[i + j]), an int8 MXU
// matmul there), :473-481 (the tail of _decode_core: the payload columns
// extracted from the decoded codeword, pinned positions set to rx_pin, the
// hash, ok = all(hash == expected) & converged, the error count) and the
// merges of retry_program (:553-563) and retry_small (:598-618), inside
// alice_program (:407), bob_program (:483), retry_program (:537) and
// retry_small (:565).
//
// Two entry points:
//  * qtpu_verify_hash (Alice's program): out (b, Vh) 0/1 bytes.
//  * qtpu_verify_tail (Bob's decodes): for each output row d, from the
//    decoded row i it merges (i = d for the first decode; for a retry a
//    table gives i, or -1 for a row the retry leaves as it was):
//      hat[d] = pin ? rx_pin : the payload columns of bits[i] (base-column
//      order, through the layout's sources table);
//      ok = all(hash(hat[d]) == expected[d]) & converged[i];
//      errs = sum(hat[d] ^ rx_orig[d]).
//    stats[d] = [ok, iterations[i], errs, mism[d]] for the first decode;
//    for retry_program (mode 1) [old ok | ok, max(old iters, iterations),
//    errs, old mism], and where the row was not re-decoded hat_old[d] and
//    [old ok != 0, max(old iters, iterations[d]), old errs, old mism] (its
//    iterations max is taken on every row, as the reference's); for
//    retry_small (mode 2) [ok, max(old iters, iterations[i]), errs, old
//    mism], and where no row was re-decoded hat_old[d] and stats_old[d].
//
// The hash reads each byte's lowest bit; hat is a copy of the bytes and the
// error count sums the XOR of the bytes, as the plain version does.  Inputs
// are bits (0/1 bytes), so the hash equals the plain version's float32
// product too.
//
// What bounds it on an H100.  At the production rung (P = 63,488, n =
// 65,536, b = 128) the tail reads the payload columns of bits, rx_pin, the
// pin mask and rx_orig and writes hat: 40.6 MB, 12.1 us at 3.35 TB/s.  The
// hash alone reads 8.1 MB (2.4 us); its b * ceil(P / 32) * Vh funnel
// shifts and three-input AND-XORs (32.5 M) take 1.9 us on the INT32 pipe.
// Both are bound by bytes.
//
// What the design does about it.
//  * One block a row, up to 1,024 threads, no atomics: the row's hash bits,
//    ok and error count are the block's reductions, written once.  At
//    b = 128, 128 of the 132 SMs stream a row each.
//  * Phase A (memory): a lane takes a run of 16 consecutive positions, a
//    warp 32 runs (16 words).  Where P and z are multiples of 16 (every
//    ladder's rung: z = 2,048, 64, 16) a run lies in one payload column
//    and each input's run is one 16-byte load (an input off alignment: two
//    aligned loads shifted together, as pin_llr.cu's; every row of a
//    tensor starts at the same offset from alignment), hat is selected
//    bytewise from the pin mask (bytes 0/1 times 0xFF) and stored 16 bytes
//    at a time, and the error count is a byte sum (__vsadu4).  Otherwise
//    (z = 24, 10: no ladder's) the same lanes move a byte at a time, each
//    position's payload column by a reciprocal of z.  A lane's 16 lowest
//    bits come from four multiplies, and a shuffle joins two lanes' into
//    a word, kept in shared memory.  The first row a block computes also
//    packs the window's seed into shared memory (zero words past its end)
//    in the same loop, so its loads overlap the row's.  A payload column's
//    base column comes from a shared table built from the layout.
//  * Phase B (shared memory only): warp k takes a contiguous run of the
//    row's words; lane l accumulates hash bits j = l and l + 32: the seed
//    bits that meet word w at shift j are the funnel shift of seed words
//    w + j / 32 and w + j / 32 + 1, so the lane keeps a window of three seed
//    words and reads one new word a step (a broadcast).  acc ^= x & seed is
//    one LOP3.  Parity is linear, so the lanes' XOR accumulators become
//    bits by one popc each, a ballot packs them into the warp's two hash
//    words, and warp 0 XORs the warps' words.  Vh is any value 1..64.
//
// Each entry point launches on the caller's stream, does not synchronise
// and returns cudaGetLastError() after its launch (0 on success), or -1 for
// arguments it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;         // threads a block (a row)
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxVh = 64;
constexpr uint32_t kMaxP = 1u << 17;
constexpr int kWordsPerWarp = 8;          // a row's words a warp, at least
constexpr size_t kMaxSmem = 232448 - 1024;  // dynamic bytes (static below)

enum Mode { kFirst = 0, kRetry = 1, kRetrySmall = 2 };

struct Tail {             // qtpu_verify_tail's inputs and outputs
  const uint8_t* bits;        // (b, nb z) decoded codewords, decoded rows
  const int32_t* sources;     // (2, nb): each base column's part, column
  int nb, z;
  unsigned long long zinv;    // ceil(2^32 / z)
  const uint8_t* rx_pin;      // (b, P) decoded rows
  const uint8_t* pin;         // (b, P) 0/1 bytes, decoded rows
  const uint8_t* rx_orig;     // (rows, P) output rows
  const uint8_t* expected;    // (rows, Vh) output rows
  const uint8_t* converged;   // (b,) bool bytes, decoded rows
  const int32_t* iterations;  // (b,) decoded rows
  const int32_t* mism;        // (rows,) the first decode's
  const int32_t* source_row;  // (rows,) decoded row or -1: the retries'
  const uint8_t* hat_old;     // (rows, P) the retries'
  const int32_t* stats_old;   // (rows, 4) the retries'
  int mode;
  uint8_t* hat;               // (rows, P)
  int32_t* stats;             // (rows, 4)
};

// Output row d's merged stats, from its hash check and error count.
__device__ void write_stats(const Tail& t, long long d, int i, bool ok,
                            int errs) {
  int32_t* s = t.stats + 4 * d;
  const int iters = t.iterations[i];
  if (t.mode == kFirst) {
    s[0] = ok;
    s[1] = iters;
    s[2] = errs;
    s[3] = t.mism[d];
    return;
  }
  const int32_t* old = t.stats_old + 4 * d;
  s[0] = t.mode == kRetry ? (int)((old[0] != 0) | ok) : (int)ok;
  s[1] = max(old[1], iters);
  s[2] = errs;
  s[3] = old[3];
}

// A retry's output row d that was not re-decoded: its old hat and stats
// (retry_program also takes the iterations maximum and normalises ok).
__device__ void keep_row(const Tail& t, long long d, uint32_t P) {
  const uint8_t* src = t.hat_old + d * P;
  uint8_t* dst = t.hat + d * P;
  uint32_t k0 = 0;
  if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0) {
    const uint32_t n16 = P / 16;
    for (uint32_t k = threadIdx.x; k < n16; k += blockDim.x)
      reinterpret_cast<uint4*>(dst)[k] =
          __ldg(reinterpret_cast<const uint4*>(src) + k);
    k0 = 16 * n16;
  }
  for (uint32_t k = k0 + threadIdx.x; k < P; k += blockDim.x)
    dst[k] = __ldg(src + k);
  if (threadIdx.x == 0) {
    const int32_t* old = t.stats_old + 4 * d;
    int32_t* s = t.stats + 4 * d;
    if (t.mode == kRetry) {
      s[0] = old[0] != 0;
      s[1] = max(old[1], t.iterations[d]);
    } else {
      s[0] = old[0];
      s[1] = old[1];
    }
    s[2] = old[2];
    s[3] = old[3];
  }
}

// The 16 bytes at p, at any alignment: one 16-byte load where p is
// aligned, else the two aligned 16-byte chunks that hold them, shifted
// together (each holds a byte of [p, p + 16), so neither reaches outside
// the aligned chunks of the buffer).  A tensor's runs all start at its own
// offset from alignment, so the branch is uniform.
__device__ __forceinline__ void load16(uint32_t (&w)[4], const uint8_t* p) {
  const int off = (int)((uintptr_t)p & 15);
  const uint4* q = reinterpret_cast<const uint4*>(p - off);
  const uint4 a = __ldg(q);
  if (off == 0) {
    w[0] = a.x;
    w[1] = a.y;
    w[2] = a.z;
    w[3] = a.w;
    return;
  }
  const uint4 c = __ldg(q + 1);
  const uint32_t v[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
  const int d = off >> 2, sh = 8 * (off & 3);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t lo = v[i], hi = v[i + 1];          // words d + i, d + i + 1
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      if (d == k) {
        lo = v[i + k];
        hi = v[i + k + 1];
      }
    }
    w[i] = __funnelshift_r(lo, hi, sh);
  }
}

// Bit m of the result: byte m's lowest bit (bytes as four words).
__device__ __forceinline__ uint32_t low_bits16(const uint32_t (&w)[4]) {
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    r |= (((w[k] & 0x01010101u) * 0x10204080u) >> 28) << (4 * k);
  return r;
}

__device__ __forceinline__ void zero16(uint32_t (&w)[4]) {
  w[0] = w[1] = w[2] = w[3] = 0;
}

// Byte m of a payload position p's decoded bit, through the column table.
__device__ __forceinline__ uint32_t decoded_byte(const Tail& t,
                                                 const int32_t* cols,
                                                 long long row, uint32_t p) {
  uint32_t q = (uint32_t)(((unsigned long long)p * t.zinv) >> 32);
  if ((unsigned long long)q * t.z > p) --q;
  return __ldg(t.bits + row + (long long)cols[q] * t.z + (p - q * t.z));
}

// Run r (positions 16 r .. 16 r + 15, zeros past P) of output row d: its
// hat bytes h and rx_orig bytes o (kTail; decoded row i), or its x bytes
// h.  kVec: P and z multiples of 16.
template <bool kTail, bool kVec>
__device__ __forceinline__ void load_run(uint32_t (&h)[4], uint32_t (&o)[4],
                                         uint32_t r, long long d, int i,
                                         const uint8_t* x, uint32_t P,
                                         const Tail& t, const int32_t* cols,
                                         long long n) {
  const uint32_t p0 = 16 * r;
  zero16(o);
  if (p0 >= P) {
    zero16(h);
    return;
  }
  if (kVec) {
    if (!kTail) {
      load16(h, x + d * P + p0);
      return;
    }
    const long long a = (long long)i * P + p0;
    uint32_t q = (uint32_t)(((unsigned long long)p0 * t.zinv) >> 32);
    if ((unsigned long long)q * t.z > p0) --q;
    uint32_t bt[4], rp[4], pm[4];
    load16(bt, t.bits + i * n + (long long)cols[q] * t.z + (p0 - q * t.z));
    load16(rp, t.rx_pin + a);
    load16(pm, t.pin + a);
    load16(o, t.rx_orig + d * P + p0);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t m = pm[k] * 0xFFu;         // pin bytes are 0/1
      h[k] = (rp[k] & m) | (bt[k] & ~m);
    }
    return;
  }
  zero16(h);
#pragma unroll
  for (int m = 0; m < 16; ++m) {
    const uint32_t p = p0 + m;
    if (p >= P) break;
    uint32_t v;
    if (kTail) {
      const long long a = (long long)i * P + p;
      v = __ldg(t.pin + a) ? __ldg(t.rx_pin + a)
                           : decoded_byte(t, cols, i * n, p);
      o[m >> 2] |= (uint32_t)__ldg(t.rx_orig + d * P + p) << (8 * (m & 3));
    } else {
      v = __ldg(x + d * P + p);
    }
    h[m >> 2] |= v << (8 * (m & 3));
  }
}

// Run r of the seed (L bytes), zeros past its end.
__device__ __forceinline__ void load_seed_run(uint32_t (&h)[4], uint32_t r,
                                              const uint8_t* seed,
                                              uint32_t L) {
  const uint32_t p0 = 16 * r;
  if (p0 + 16 <= L) {
    load16(h, seed + p0);
    return;
  }
  zero16(h);
  for (uint32_t p = p0; p < L; ++p)
    h[(p - p0) >> 2] |= (uint32_t)__ldg(seed + p) << (8 * ((p - p0) & 3));
}

// Rows blockIdx.x (+ gridDim.x ...).  kTail: qtpu_verify_tail (t), else
// qtpu_verify_hash (x, out).  kVec: P (and z) multiples of 16 and hat
// 16-byte aligned.  kUnroll: groups of 32 runs a warp loads before it uses
// them.  Dynamic shared memory: the row's W words, the seed's SW + 3 words
// and (kTail) nb payload-column entries.
template <bool kTail, bool kVec, int kUnroll>
__global__ void __launch_bounds__(kMaxThreads)
verify_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ seed,
              int rows, uint32_t P, int vh, uint8_t* __restrict__ out,
              Tail t) {
  extern __shared__ uint32_t smem[];
  __shared__ uint32_t warp_hash[kMaxWarps][2];
  __shared__ int warp_errs[kMaxWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const uint32_t W = (P + 31) / 32;             // a row's words
  const uint32_t L = P + (uint32_t)vh - 1;      // the seed's bits
  const uint32_t SW = (L + 31) / 32;            // the seed's words
  const uint32_t GR = (W + 15) / 16;            // a row's groups of 32 runs
  const uint32_t GS = (SW + 15) / 16;           // the seed's
  uint32_t* xw = smem;
  uint32_t* sw = smem + W;
  int32_t* cols = reinterpret_cast<int32_t*>(sw + SW + 3);
  const long long n = kTail ? (long long)t.nb * t.z : 0;
  if (kTail) {
    // Payload column q is base column cols[q].
    for (int j = threadIdx.x; j < t.nb; j += blockDim.x)
      if (t.sources[j] == 0) cols[t.sources[t.nb + j]] = j;
  }
  if (threadIdx.x < 3) sw[SW + threadIdx.x] = 0;
  __syncthreads();
  bool packed = false;                          // the seed is in sw
  for (long long d = blockIdx.x; d < rows; d += gridDim.x) {
    int i = (int)d;                             // the decoded row
    if (kTail && t.mode != kFirst) i = t.source_row[d];
    if (kTail && i < 0) {                       // uniform in the block
      keep_row(t, d, P);
      continue;
    }
    // Phase A: the row's words (hat stored), and the seed's once.
    const uint32_t items = GR + (packed ? 0 : GS);
    int errs = 0;
    for (uint32_t it0 = warp; it0 < items; it0 += nw * kUnroll) {
      uint32_t h[kUnroll][4], o[kUnroll][4];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t it = it0 + u * nw;
        if (it < GR) {
          load_run<kTail, kVec>(h[u], o[u], 32 * it + lane, d, i, x, P, t,
                                cols, n);
        } else if (it < items) {
          load_seed_run(h[u], 32 * (it - GR) + lane, seed, L);
        } else {
          zero16(h[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const uint32_t it = it0 + u * nw;
        if (it >= items) break;                 // uniform in the warp
        const uint32_t lo = low_bits16(h[u]);
        const uint32_t word =
            lo | (__shfl_down_sync(0xffffffffu, lo, 1) << 16);
        const bool row = it < GR;
        const uint32_t w = 16 * (row ? it : it - GR) + (lane >> 1);
        if (!(lane & 1) && w < (row ? W : SW)) (row ? xw : sw)[w] = word;
        if (kTail && row) {
          const uint32_t p0 = 16 * (32 * it + lane);
          if (p0 < P) {
            uint8_t* hp = t.hat + d * P + p0;
            if (kVec) {
              *reinterpret_cast<uint4*>(hp) =
                  make_uint4(h[u][0], h[u][1], h[u][2], h[u][3]);
            } else {
              for (uint32_t m = 0; m < 16 && p0 + m < P; ++m)
                hp[m] = (uint8_t)(h[u][m >> 2] >> (8 * (m & 3)));
            }
#pragma unroll
            for (int k = 0; k < 4; ++k)
              errs += (int)__vsadu4(h[u][k] ^ o[u][k], 0u);
          }
        }
      }
    }
    packed = true;
    __syncthreads();
    // Phase B: lane l's hash bits l and l + 32 over the warp's words.
    uint32_t acc0 = 0, acc1 = 0;
    const uint32_t per = (W + nw - 1) / nw;
    const uint32_t w0 = warp * per;
    const uint32_t w1 = min(W, w0 + per);
    if (w0 < w1) {
      uint32_t a = sw[w0], b = sw[w0 + 1], c = sw[w0 + 2];
#pragma unroll 4
      for (uint32_t w = w0; w < w1; ++w) {
        const uint32_t xv = xw[w];
        acc0 ^= xv & __funnelshift_r(a, b, lane);
        acc1 ^= xv & __funnelshift_r(b, c, lane);
        a = b;
        b = c;
        c = sw[w + 3];          // w + 3 <= W + 2 <= SW + 2
      }
    }
    const uint32_t h0 = __ballot_sync(0xffffffffu, __popc(acc0) & 1);
    const uint32_t h1 = __ballot_sync(0xffffffffu, __popc(acc1) & 1);
    if (kTail) errs = __reduce_add_sync(0xffffffffu, errs);
    if (lane == 0) {
      warp_hash[warp][0] = h0;
      warp_hash[warp][1] = h1;
      warp_errs[warp] = errs;
    }
    __syncthreads();
    if (warp == 0) {
      const bool live = lane < nw;
      const uint32_t H0 =
          __reduce_xor_sync(0xffffffffu, live ? warp_hash[lane][0] : 0u);
      const uint32_t H1 =
          __reduce_xor_sync(0xffffffffu, live ? warp_hash[lane][1] : 0u);
      const uint32_t b0 = (H0 >> lane) & 1, b1 = (H1 >> lane) & 1;
      if (!kTail) {
        uint8_t* o = out + d * vh;
        if (lane < vh) o[lane] = (uint8_t)b0;
        if (lane + 32 < vh) o[lane + 32] = (uint8_t)b1;
      } else {
        const int total =
            __reduce_add_sync(0xffffffffu, live ? warp_errs[lane] : 0);
        const uint8_t* e = t.expected + d * vh;
        const bool match = (lane >= vh || e[lane] == b0)
                           && (lane + 32 >= vh || e[lane + 32] == b1);
        const bool ok = __all_sync(0xffffffffu, match)
                        && t.converged[i] != 0;
        if (lane == 0) write_stats(t, d, i, ok, total);
      }
    }
    __syncthreads();            // xw and the warps' words are reused
  }
}

template <bool kTail, bool kVec>
int launch(const uint8_t* x, const uint8_t* seed, int rows, uint32_t P,
           int vh, uint8_t* out, const Tail& t, cudaStream_t stream) {
  // Two groups a warp in flight for the hash's one input, one for the
  // tail's four (the byte bodies: one, within 64 registers).
  constexpr int kUnroll = kTail || !kVec ? 1 : 2;
  const uint32_t W = (P + 31) / 32, SW = (P + vh - 1 + 31) / 32;
  int warps = (int)((W + kWordsPerWarp - 1) / kWordsPerWarp);
  warps = warps < 1 ? 1 : warps > kMaxWarps ? kMaxWarps : warps;
  const size_t smem = 4 * ((size_t)W + SW + 3 + (kTail ? t.nb : 0));
  if (smem > kMaxSmem) return -1;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        verify_kernel<kTail, kVec, kUnroll>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  verify_kernel<kTail, kVec, kUnroll><<<rows, 32 * warps, smem, stream>>>(
      x, seed, rows, P, vh, out, t);
  return (int)cudaGetLastError();
}

bool shape_ok(int rows, uint32_t P, int vh) {
  return rows > 0 && P > 0 && P <= kMaxP && vh >= 1 && vh <= kMaxVh;
}

}  // namespace

// Alice's verify hash: x uint8 (b, P) contiguous bits, seed uint8
// (P + vh - 1) bits; writes out (b, vh) 0/1 bytes.  -1: b <= 0, P outside
// 1..2^17, vh outside 1..64.
extern "C" int qtpu_verify_hash(const uint8_t* x, const uint8_t* seed, int b,
                                uint32_t P, int vh, uint8_t* out,
                                void* stream) {
  if (!shape_ok(b, P, vh)) return -1;
  const Tail none = {};
  return P % 16 == 0
             ? launch<false, true>(x, seed, b, P, vh, out, none,
                                   (cudaStream_t)stream)
             : launch<false, false>(x, seed, b, P, vh, out, none,
                                    (cudaStream_t)stream);
}

// Bob's decode tail (see the top of the file): bits (b, nb z) uint8;
// sources int32 (2, nb) (0 for a payload column); rx_pin, pin (b, P);
// rx_orig (rows, P); seed (P + vh - 1); expected (rows, vh); converged (b,)
// bool; iterations (b,) int32; mode 0 (first decode, rows = b, mism (b,)
// int32), 1 (retry_program) or 2 (retry_small), the retries with
// source_row (rows,) int32 (a decoded row, each at most once, or -1),
// hat_old (rows, P) and stats_old (rows, 4) int32.  Writes hat (rows, P)
// and stats (rows, 4).  -1: rows <= 0, P outside 1..2^17 or not a whole
// number of the nb z-columns, vh outside 1..64, a mode's inputs missing,
// or more shared memory than a block has.
extern "C" int qtpu_verify_tail(
    const uint8_t* bits, const int32_t* sources, int nb, int z,
    const uint8_t* rx_pin, const uint8_t* pin, const uint8_t* rx_orig,
    const uint8_t* seed, const uint8_t* expected, int vh,
    const uint8_t* converged, const int32_t* iterations, const int32_t* mism,
    const int32_t* source_row, const uint8_t* hat_old,
    const int32_t* stats_old, int mode, int rows, uint32_t P, uint8_t* hat,
    int32_t* stats, void* stream) {
  if (!shape_ok(rows, P, vh) || nb <= 0 || z <= 0 || P % (uint32_t)z != 0
      || P / (uint32_t)z > (uint32_t)nb)
    return -1;
  if (mode == kFirst ? mism == nullptr
      : (mode != kRetry && mode != kRetrySmall) || source_row == nullptr
        || hat_old == nullptr || stats_old == nullptr)
    return -1;
  const unsigned long long zinv =
      ((1ULL << 32) + (unsigned long long)z - 1) / (unsigned long long)z;
  const Tail t = {bits, sources, nb, z, zinv, rx_pin, pin, rx_orig, expected,
                  converged, iterations, mism, source_row, hat_old, stats_old,
                  mode, hat, stats};
  // Whole 16-byte runs of one column, and hat's rows 16-byte aligned.
  const bool vec = P % 16 == 0 && z % 16 == 0 && ((uintptr_t)hat & 15) == 0;
  return vec ? launch<true, true>(nullptr, seed, rows, P, vh, nullptr, t,
                                  (cudaStream_t)stream)
             : launch<true, false>(nullptr, seed, rows, P, vh, nullptr, t,
                                   (cudaStream_t)stream);
}

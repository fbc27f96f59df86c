// The window programs' verify hash and Bob's decode tail for Hopper (sm_90a).
//
// Replaces what XLA fused inside the reference's jitted window programs:
// qtpu/window_programs.py:364-387 (_vmatrix, _verify_hash: the GF(2)
// Toeplitz hash of a (b, P) payload against ONE window-level seed t of
// P + Vh - 1 bits, hash bit j = parity(sum_i x[i] t[i + j]), an int8 MXU
// matmul there), :473-481 (the tail of _decode_core: the payload columns
// extracted from the decoded codeword, pinned positions set to rx_pin, the
// hash, ok = all(hash == expected) & converged, the error count) and the
// merge of its compact retry (:598-618), inside alice_program (:407),
// bob_program (:483) and that retry (:565).
//
// Two entry points:
//  * qtpu_verify_hash (Alice's program): out (b, Vh) 0/1 bytes.
//  * qtpu_verify_tail (Bob's decodes): for each merged output row d, from
//    the decoded row i it merges (i = d for the first decode; for a retry
//    the host's row order gives d, and i is the row's place in the
//    decode):
//      hat[d] = pin ? rx_pin : the payload columns of bits[i] (base-column
//      order, through the layout's sources table);
//      ok = all(hash(hat[d]) == expected[d]) & converged[i];
//      errs = sum(hat[d] ^ rx_orig[d]).
//    stats[d] = [ok, iterations[i], errs, mism[d]] for the first decode;
//    for a retry (mode 1, the rows merge) [ok, max(old iters,
//    iterations[i]), errs, old mism], and where no row was re-decoded
//    hat_old[d] and stats_old[d].
//
// The hash reads each byte's lowest bit; hat is a copy of the bytes and the
// error count sums the XOR of the bytes, as the plain version does.  Inputs
// are bits (0/1 bytes), so the hash equals the plain version's float32
// product too.
//
// What bounds it on an H100.  At the production rung (P = 63,488, n =
// 65,536, b = 128) the tail reads the payload columns of bits, rx_pin, the
// pin mask and rx_orig and writes hat: 40.6 MB, 12.1 us at 3.35 TB/s.  The
// hash alone reads 8.1 MB (2.4 us); its funnel shifts and three-input
// AND-XORs (one shift and two LOP3s a row word and pair of hash bits, 24.4
// M) take 1.5 us on the INT32 pipe.  Both are bound by bytes.  A shard's 32
// rows (3.05 us) and a retry's few decoded rows (its kept rows copied: ~5.4
// us) are bound by bytes too, but a row on one SM takes ~11 us: there the
// latency of one row is the limit.
//
// What the design does about it.  The host plans each launch
// (window_verify.plan: the cluster size C, which is the CTAs a row, a
// CTA's slice of the row's words in whole groups of 16 words, threads, and
// for a retry the CTAs that copy its kept rows) from
// cudaOccupancyMaxActiveClusters of the instantiation, asked once
// (qtpu_verify_plan), so that every cluster is resident at once
// where the rows allow it, and launches it by cudaLaunchKernelEx.
//  * Many rows (b = 128): C = 1, a CTA of 1,024 threads a row.
//  * Few rows (a shard's 32, a retry's 8-11, b = 1): a row's groups split
//    over the C CTAs of a cluster.  Each CTA puts its partial hash words
//    (parity is linear: they XOR) and error count into rank 0's shared
//    memory (mapa + st.shared::cluster); after one cluster barrier rank 0
//    checks expected and converged and writes the row's stats.
//  * A retry's kept rows are copied by CTAs of their own after the merged
//    rows' clusters in the grid, each an equal byte range of the kept rows
//    (16-byte stores; two aligned loads shifted together where hat_old is
//    off alignment), so no decoded row waits for them.
//  * The hash overlaps the loads, and no CTA-wide phase packs the seed: a
//    warp takes a group of 32 runs of 16 positions (a lane a run; each
//    input's run one 16-byte load, two aligned loads shifted together
//    where the input is off alignment, as pin_llr.cu's) together with the
//    seed bits that group meets (its own 512 and 128 of the next, from L2),
//    packs both to words (four multiplies and a shuffle) in its own shared
//    buffers, stores hat and sums the error count (__vsadu4), then hashes
//    the group while the other warps' loads are in flight: lane l keeps
//    hash bits l and l + 32 in two XOR accumulators; the seed bits that
//    meet word w are the funnel shifts of seed words (w, w + 1) and (w + 1,
//    w + 2), and the second is the first of word w + 1, so a word costs one
//    shift and two LOP3s; words and seed come as 16-byte broadcasts.  The
//    hash's warps keep two groups' loads in flight, a ring of stages each
//    issued again as soon as it is taken (the tail's six loads a lane
//    fill the registers of one).  The one block barrier gathers the
//    warps' ballots at the end.  Where P or z is not a multiple of 16 (z
//    = 24, 10: no ladder's) the same lanes move a byte at a time, each
//    position's payload column by a reciprocal of z.
//  * The function attributes (dynamic shared memory, cluster size 16) are
//    set once a device for each instantiation.
//
// Each entry point launches on the caller's stream, does not synchronise
// and returns cudaGetLastError() after its launch (0 on success), or -1 for
// arguments it does not take (the plan's numbers included).

#include <cuda_runtime.h>
#include <stdint.h>

#include "cluster_state.cuh"

namespace {

constexpr int kMaxThreads = 1024;         // threads a CTA
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxVh = 64;
constexpr uint32_t kMaxP = 1u << 17;
constexpr int kMaxSmem = 232448 - 2048;   // dynamic bytes (static below)
constexpr int kMaxDevices = 64;
constexpr int kWarpWords = 40;            // a warp's 16 row, 20 seed words

enum Mode { kFirst = 0, kRows = 1 };

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
  const int32_t* order;       // (rows,) a retry's: merged rows, then kept
  const uint8_t* hat_old;     // (rows, P) a retry's
  const int32_t* stats_old;   // (rows, 4) a retry's
  int mode;
  uint8_t* hat;               // (rows, P)
  int32_t* stats;             // (rows, 4)
};

struct Plan {             // the host's launch plan (window_verify.plan)
  int rows;                   // output rows
  int merged;                 // rows hashed: the first order[0, merged)
  int cluster;                // C: CTAs a merged row
  int groups;                 // q: groups of 16 words a CTA's slice
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
  s[0] = ok;
  s[1] = max(old[1], iters);
  s[2] = errs;
  s[3] = old[3];
}

// A retry's output row d that was not re-decoded: its old stats.
__device__ void keep_stats(const Tail& t, long long d) {
  const int32_t* old = t.stats_old + 4 * d;
  int32_t* s = t.stats + 4 * d;
  for (int j = 0; j < 4; ++j) s[j] = old[j];
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

// Bytes [off, off + n) of kept row d: hat_old's copied into hat.
__device__ void copy_kept(const Tail& t, long long d, uint32_t P,
                          uint32_t off, uint32_t n) {
  const uint8_t* src = t.hat_old + d * P + off;
  uint8_t* dst = t.hat + d * P + off;
  const int tid = threadIdx.x, bd = blockDim.x;
  if (((P | off) & 15) == 0 && ((uintptr_t)t.hat & 15) == 0) {
    // n is a multiple of 16 here (a range ends at a multiple of 16 or at
    // the row's end); dst is aligned, src read by load16.
    const int n16 = (int)(n / 16);
    for (int k = tid; k < n16; k += 4 * bd) {
      uint32_t v[4][4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (k + u * bd < n16) load16(v[u], src + 16 * (k + u * bd));
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (k + u * bd < n16)
          reinterpret_cast<uint4*>(dst)[k + u * bd] =
              make_uint4(v[u][0], v[u][1], v[u][2], v[u][3]);
    }
    return;
  }
  for (uint32_t k = tid; k < n; k += bd) dst[k] = __ldg(src + k);
}

// Kept CTA kc of K: an equal, 16-byte rounded range of the kept rows'
// bytes (rows order[merged ..], end to end), and the stats of every kept
// row whose first byte lies in it.
__device__ void keep_rows(const Tail& t, uint32_t P, const Plan& lp,
                          long long kc, long long K) {
  const long long total = (long long)(lp.rows - lp.merged) * P;
  const long long per = ((total + K - 1) / K + 15) / 16 * 16;
  long long a = kc * per;
  const long long e = min(total, a + per);
  while (a < e) {
    const long long j = a / P;
    const uint32_t off = (uint32_t)(a - j * P);
    const uint32_t n = (uint32_t)min(e - a, (long long)(P - off));
    const long long d = t.order[lp.merged + j];
    copy_kept(t, d, P, off, n);
    if (off == 0 && threadIdx.x == 0) keep_stats(t, d);
    a += n;
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
// x bytes h (the hash; kVec: P a multiple of 16, one 16-byte load), or
// (kTail, the byte body) its hat bytes h and rx_orig bytes o, decoded row
// i.  The tail's 16-byte body loads its runs in issue().
template <bool kTail, bool kVec>
__device__ __forceinline__ void load_run(uint32_t (&h)[4], uint32_t (&o)[4],
                                         uint32_t r, long long d, int i,
                                         const uint8_t* x, uint32_t P,
                                         const Tail& t, const int32_t* cols,
                                         long long n) {
  static_assert(!(kTail && kVec), "the tail's 16-byte body loads in issue");
  const uint32_t p0 = 16 * r;
  zero16(o);
  if (p0 >= P) {
    zero16(h);
    return;
  }
  if (kVec) {
    load16(h, x + d * P + p0);
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
#pragma unroll
  for (int m = 0; m < 16; ++m)  // constant indices: h stays in registers
    if (p0 + m < L)
      h[m >> 2] |= (uint32_t)__ldg(seed + p0 + m) << (8 * (m & 3));
}

// Seed bytes [pos, pos + 4), zeros past L: one aligned 4-byte load, or
// two shifted together where the seed lies off alignment (each holds a
// byte of the four, so neither reaches outside the buffer's aligned words).
__device__ __forceinline__ uint32_t load_seed4(const uint8_t* seed,
                                               uint32_t pos, uint32_t L) {
  if (pos + 4 <= L) {
    const uint8_t* p = seed + pos;
    const int off = (int)((uintptr_t)p & 3);
    const uint32_t* q = reinterpret_cast<const uint32_t*>(p - off);
    if (off == 0) return __ldg(q);
    return __funnelshift_r(__ldg(q), __ldg(q + 1), 8 * off);
  }
  uint32_t v = 0;
#pragma unroll
  for (int m = 0; m < 4; ++m)
    if (pos + m < L) v |= (uint32_t)__ldg(seed + pos + m) << (8 * m);
  return v;
}

// A warp's group of 32 runs as 16 words: lane 2k's word k (lanes 2k and
// 2k + 1's runs joined by a shuffle).
__device__ __forceinline__ uint32_t pack_group(const uint32_t (&h)[4]) {
  const uint32_t lo = low_bits16(h);
  return lo | (__shfl_down_sync(0xffffffffu, lo, 1) << 16);
}

__device__ __forceinline__ void st_cluster_u32(uint32_t a, uint32_t v) {
  asm volatile("st.shared::cluster.u32 [%0], %1;" :: "r"(a), "r"(v)
               : "memory");
}

// The cluster barrier in two halves: no CTA addresses a peer's shared
// memory before every CTA of the cluster has arrived (started).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// Lane l's hash bits l (acc0) and l + 32 (acc1) over 16 row words xs[0..15]
// against the packed seed s[0..19] (s[k] the seed word of row word k):
// bit j of word k meets the funnel shift of seed words (k, k + 1) by j
// (j < 32) or (k + 1, k + 2) by j - 32, and the second is the first of
// word k + 1.  Both arrays 16-byte aligned; every lane reads the same
// addresses (broadcasts).
__device__ __forceinline__ void hash_group(const uint32_t* s,
                                           const uint32_t* xs, int lane,
                                           uint32_t& acc0, uint32_t& acc1) {
  const uint4* s4 = reinterpret_cast<const uint4*>(s);
  const uint4* x4 = reinterpret_cast<const uint4*>(xs);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const uint4 a = s4[2 * half], b = s4[2 * half + 1], c = s4[2 * half + 2];
    const uint32_t sv[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                             b.z, b.w, c.x, c.y, c.z, c.w};
    const uint4 xa = x4[2 * half], xb = x4[2 * half + 1];
    const uint32_t xv[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
    uint32_t f = __funnelshift_r(sv[0], sv[1], lane);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t fn = __funnelshift_r(sv[k + 1], sv[k + 2], lane);
      acc0 ^= xv[k] & f;
      acc1 ^= xv[k] & fn;
      f = fn;
    }
  }
}

// A warp's loads of one group in flight: the row's runs (the hash's x in
// a; the tail's bits, rx_pin, pin and rx_orig in a, b, c, o, or the byte
// body's finished hat bytes in a), the seed's run of the group (s) and 4
// bytes a lane of the next group's (e: the four seed words past the
// group's).  kDepth stages in flight, a ring: a stage is issued again,
// kDepth groups ahead, as soon as it is taken (the tail's five 16-byte
// loads a lane fill the registers of one).
template <bool kTail>
struct Stage {
  static constexpr int kDepth = kTail ? 1 : 2;
  uint32_t a[4], b[4], c[4], o[4], s[4], e;
};

// Issues stage st's loads for group g (none where g >= g1) of output row d
// (decoded row i).
template <bool kTail, bool kVec>
__device__ __forceinline__ void issue(Stage<kTail>& st, uint32_t g,
                                      uint32_t g1, int lane, long long d,
                                      int i, const uint8_t* x,
                                      const uint8_t* seed, uint32_t P,
                                      uint32_t L, const Tail& t,
                                      const int32_t* cols, long long n) {
  if (g >= g1) return;
  const uint32_t r = 32 * g + lane, p0 = 16 * r;
  if constexpr (kTail && kVec) {
    zero16(st.c);                               // no pins: hat = a = 0
    zero16(st.a);
    zero16(st.o);
    if (p0 < P) {
      const long long a = (long long)i * P + p0;
      uint32_t q = (uint32_t)(((unsigned long long)p0 * t.zinv) >> 32);
      if ((unsigned long long)q * t.z > p0) --q;
      load16(st.a, t.bits + i * n + (long long)cols[q] * t.z + (p0 - q * t.z));
      load16(st.b, t.rx_pin + a);
      load16(st.c, t.pin + a);
      load16(st.o, t.rx_orig + d * P + p0);
    }
  } else {
    load_run<kTail, kVec>(st.a, st.o, r, d, i, x, P, t, cols, n);
  }
  load_seed_run(st.s, r, seed, L);
  st.e = load_seed4(seed, 512 * (g + 1) + 4 * lane, L);
}

// Takes stage st's group g (nothing where g >= g1): hat bytes finished
// (the tail's 16-byte body selects them by the pin bytes, 0/1 times
// 0xFF), the row's and the seed's runs packed into the warp's buffers xs
// and ws, hat stored and the error count summed (__vsadu4), then the
// group hashed.
template <bool kTail, bool kVec>
__device__ __forceinline__ void take(Stage<kTail>& st, uint32_t g,
                                     uint32_t g1, int lane, long long d,
                                     uint32_t P, const Tail& t, uint32_t* xs,
                                     uint32_t* ws, uint32_t& acc0,
                                     uint32_t& acc1, int& errs) {
  if (g >= g1) return;                          // uniform in the warp
  if (kTail && kVec) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t m = st.c[k] * 0xFFu;       // pin bytes are 0/1
      st.a[k] = (st.b[k] & m) | (st.a[k] & ~m);
    }
  }
  const uint32_t word = pack_group(st.a);
  const uint32_t sword = pack_group(st.s);
  // The next group's first 128 seed bits: lane l's 4 at bit 4 (l % 8) of
  // word l / 8, joined over 8 lanes.
  uint32_t eword = (((st.e & 0x01010101u) * 0x10204080u) >> 28)
                   << (4 * (lane & 7));
  eword |= __shfl_xor_sync(0xffffffffu, eword, 1);
  eword |= __shfl_xor_sync(0xffffffffu, eword, 2);
  eword |= __shfl_xor_sync(0xffffffffu, eword, 4);
  if (!(lane & 1)) {
    xs[lane >> 1] = word;
    ws[lane >> 1] = sword;
  }
  if (!(lane & 7)) ws[16 + (lane >> 3)] = eword;
  if (kTail) {
    const uint32_t p0 = 16 * (32 * g + lane);
    if (p0 < P) {
      uint8_t* hp = t.hat + d * P + p0;
      if (kVec) {
        *reinterpret_cast<uint4*>(hp) =
            make_uint4(st.a[0], st.a[1], st.a[2], st.a[3]);
      } else {
#pragma unroll
        for (int m = 0; m < 16; ++m)
          if (p0 + m < P) hp[m] = (uint8_t)(st.a[m >> 2] >> (8 * (m & 3)));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        errs += (int)__vsadu4(st.a[k] ^ st.o[k], 0u);
    }
  }
  __syncwarp();
  hash_group(ws, xs, lane, acc0, acc1);
  __syncwarp();                 // the buffers are rewritten by the next
}

// Clusters of lp.cluster CTAs.  Cluster k < merged hashes merged item k's
// row, CTA rank r its groups [r q, (r + 1) q) of 16 words (C = 1: the whole
// row); the CTAs after them copy a retry's kept rows.  kTail:
// qtpu_verify_tail (t), else qtpu_verify_hash (x, out).  kVec: P (and z)
// multiples of 16 and hat 16-byte aligned.  Dynamic shared memory: a
// warp's 16 row and 20 seed words (kWarpWords) each and (kTail) nb
// payload-column entries.
template <bool kTail, bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 1)
verify_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ seed,
              uint32_t P, int vh, uint8_t* __restrict__ out, Plan lp,
              Tail t) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ uint32_t warp_hash[kMaxWarps][2];
  __shared__ int warp_errs[kMaxWarps];
  __shared__ uint32_t gathered[MAX_CLUSTER][4];  // each rank's part
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int C = lp.cluster;
  const uint32_t q = (uint32_t)lp.groups;
  const int cta = blockIdx.x, rank = cta % C, k = cta / C;
  if (kTail && k >= lp.merged) {                // uniform in the cluster
    const long long first = (long long)lp.merged * C;
    keep_rows(t, P, lp, cta - first, gridDim.x - first);
    return;
  }
  if (C > 1) cluster_arrive_relaxed();
  const uint32_t W = (P + 31) / 32;             // a row's words
  const uint32_t G = (W + 15) / 16;             // its groups of 16 words
  const uint32_t L = P + (uint32_t)vh - 1;      // the seed's bits
  uint32_t* xs = smem + kWarpWords * warp;
  uint32_t* ws = xs + 16;
  int32_t* cols = reinterpret_cast<int32_t*>(smem + kWarpWords * nw);
  const long long n = kTail ? (long long)t.nb * t.z : 0;
  if (kTail) {
    // Payload column q is base column cols[q].
    for (int j = threadIdx.x; j < t.nb; j += blockDim.x)
      if (t.sources[j] == 0) cols[t.sources[t.nb + j]] = j;
    __syncthreads();
  }
  long long d = k;                              // the output row
  const int i = k;                              // the decoded row
  if (kTail && t.mode == kRows) d = t.order[k];
  // The warp's groups g0 + warp, + nw, ... of the CTA's [g0, g1).
  const uint32_t g0 = min(G, rank * q), g1 = min(G, g0 + q);
  const uint32_t step = (uint32_t)nw;
  uint32_t g = g0 + warp;
  uint32_t acc0 = 0, acc1 = 0;
  int errs = 0;
  constexpr int kDepth = Stage<kTail>::kDepth;
  Stage<kTail> st[kDepth];
#pragma unroll
  for (int u = 0; u < kDepth; ++u)
    issue<kTail, kVec>(st[u], g + u * step, g1, lane, d, i, x, seed, P, L, t,
                       cols, n);
  for (; g < g1; g += kDepth * step) {
#pragma unroll
    for (int u = 0; u < kDepth; ++u) {
      const uint32_t gu = g + u * step;
      take<kTail, kVec>(st[u], gu, g1, lane, d, P, t, xs, ws, acc0, acc1,
                        errs);
      issue<kTail, kVec>(st[u], gu + kDepth * step, g1, lane, d, i, x, seed,
                         P, L, t, cols, n);
    }
  }
  // The warps' parities, ballots and counts; warp 0 joins them.
  const uint32_t h0 = __ballot_sync(0xffffffffu, __popc(acc0) & 1);
  const uint32_t h1 = __ballot_sync(0xffffffffu, __popc(acc1) & 1);
  if (kTail) errs = __reduce_add_sync(0xffffffffu, errs);
  if (lane == 0) {
    warp_hash[warp][0] = h0;
    warp_hash[warp][1] = h1;
    warp_errs[warp] = errs;
  }
  if (C > 1) cluster_wait();                   // rank 0 has started
  __syncthreads();
  uint32_t H0 = 0, H1 = 0;
  int E = 0;
  if (warp == 0) {
    const bool on = lane < nw;
    H0 = __reduce_xor_sync(0xffffffffu, on ? warp_hash[lane][0] : 0u);
    H1 = __reduce_xor_sync(0xffffffffu, on ? warp_hash[lane][1] : 0u);
    if (kTail)
      E = __reduce_add_sync(0xffffffffu, on ? warp_errs[lane] : 0);
    if (C > 1 && lane == 0) {
      // This slice's part into rank 0's slot `rank`.
      const uint32_t a = mapa(smem_addr(&gathered[rank][0]), 0);
      st_cluster_u32(a, H0);
      st_cluster_u32(a + 4, H1);
      st_cluster_u32(a + 8, (uint32_t)E);
    }
  }
  if (C > 1) {
    state_barrier<true>();      // every slice's part is in rank 0's slots
    if (rank != 0) return;
    if (warp == 0) {
      const bool on = lane < C;
      H0 = __reduce_xor_sync(0xffffffffu, on ? gathered[lane][0] : 0u);
      H1 = __reduce_xor_sync(0xffffffffu, on ? gathered[lane][1] : 0u);
      if (kTail)
        E = __reduce_add_sync(0xffffffffu,
                              on ? (int)gathered[lane][2] : 0);
    }
  }
  if (warp != 0) return;
  const uint32_t b0 = (H0 >> lane) & 1, b1 = (H1 >> lane) & 1;
  if (!kTail) {
    uint8_t* o = out + d * vh;
    if (lane < vh) o[lane] = (uint8_t)b0;
    if (lane + 32 < vh) o[lane + 32] = (uint8_t)b1;
  } else {
    const uint8_t* e = t.expected + d * vh;
    const bool match = (lane >= vh || e[lane] == b0)
                       && (lane + 32 >= vh || e[lane + 32] == b1);
    const bool ok = __all_sync(0xffffffffu, match) && t.converged[i] != 0;
    if (lane == 0) write_stats(t, d, i, ok, E);
  }
}

template <bool kTail, bool kVec>
void* kernel() {
  return (void*)verify_kernel<kTail, kVec>;
}

// The instantiation's attributes, once a device: the most dynamic shared
// memory and clusters of 16.
template <bool kTail, bool kVec>
int ready() {
  static bool done[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= kMaxDevices) return -1;
  if (done[dev]) return 0;
  e = cudaFuncSetAttribute(kernel<kTail, kVec>(),
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel<kTail, kVec>(),
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  if (e != cudaSuccess) return (int)e;
  done[dev] = true;
  return 0;
}

void config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int grid,
            int cluster, int threads, int smem, cudaStream_t stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)grid, 1, 1);
  cfg->blockDim = dim3((unsigned)threads, 1, 1);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// Dynamic shared memory of a CTA: kWarpWords a warp and (tail) nb column
// entries.
long long smem_need(int threads, int cols) {
  return 4LL * ((long long)kWarpWords * (threads / 32) + cols);
}

// The plan's numbers are the ones the kernel takes: C a power of two up
// to 16, whole groups covering the row (C = 1: q = G), threads a whole
// number of warps, smem as smem_need, and the kept rows' CTAs (a multiple
// of C, some exactly when a row is kept) after the merged rows' clusters.
bool plan_ok(const Plan& lp, uint32_t P, int threads, int smem, int cols,
             int kept_ctas) {
  const int C = lp.cluster;
  const long long G = ((P + 31) / 32 + 15) / 16;
  if (C < 1 || C > MAX_CLUSTER || (C & (C - 1))) return false;
  if (C == 1 ? lp.groups != G
             : lp.groups < 1 || (long long)lp.groups * C < G)
    return false;
  if (threads < 32 || threads > kMaxThreads || threads % 32) return false;
  if (smem_need(threads, cols) != smem || smem > kMaxSmem) return false;
  if (lp.merged < 0 || lp.merged > lp.rows || kept_ctas < 0
      || kept_ctas % C || (kept_ctas > 0) != (lp.rows > lp.merged))
    return false;
  const long long grid = (long long)lp.merged * C + kept_ctas;
  return grid > 0 && grid <= (1LL << 31) - 1;
}

template <bool kTail, bool kVec>
int launch(const uint8_t* x, const uint8_t* seed, uint32_t P, int vh,
           uint8_t* out, const Plan& lp, int threads, int smem,
           int kept_ctas, const Tail& t, cudaStream_t stream) {
  const int e0 = ready<kTail, kVec>();
  if (e0 != 0) return e0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(&cfg, &attr, lp.merged * lp.cluster + kept_ctas, lp.cluster,
         threads, smem, stream);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, verify_kernel<kTail, kVec>,
                                           x, seed, P, vh, out, lp, t);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool shape_ok(int rows, uint32_t P, int vh) {
  return rows > 0 && P > 0 && P <= kMaxP && vh >= 1 && vh <= kMaxVh;
}

}  // namespace

// The planner's query: cudaOccupancyMaxActiveClusters of an instantiation
// (tail: the tail's, else the hash's; vec: its 16-byte body) at `cluster`
// CTAs of `threads` threads and `smem` dynamic bytes on the current device
// (0: none can be scheduled), or minus the cudaError_t.
extern "C" int qtpu_verify_plan(int tail, int vec, int cluster, int threads,
                                int smem) {
  if (cluster < 1 || cluster > MAX_CLUSTER || threads < 32
      || threads > kMaxThreads || smem < 0 || smem > kMaxSmem)
    return -1;
  void* fn = tail ? (vec ? kernel<true, true>() : kernel<true, false>())
                  : (vec ? kernel<false, true>() : kernel<false, false>());
  const int e0 = tail ? (vec ? ready<true, true>() : ready<true, false>())
                      : (vec ? ready<false, true>() : ready<false, false>());
  if (e0 != 0) return -e0;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  config(&cfg, &attr, cluster, cluster, threads, smem, nullptr);
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(&n, fn, &cfg);
  if (e != cudaSuccess) return -(int)e;
  return n;
}

// Alice's verify hash: x uint8 (b, P) contiguous bits, seed uint8
// (P + vh - 1) bits; writes out (b, vh) 0/1 bytes, at the plan's cluster
// size (CTAs a row), groups a CTA's slice, threads and dynamic shared
// memory.  -1: b <= 0, P outside 1..2^17, vh outside 1..64, or a plan the
// kernel does not take.
extern "C" int qtpu_verify_hash(const uint8_t* x, const uint8_t* seed, int b,
                                uint32_t P, int vh, uint8_t* out, int cluster,
                                int groups, int threads, int smem,
                                void* stream) {
  if (!shape_ok(b, P, vh)) return -1;
  const Plan lp = {b, b, cluster, groups};
  if (!plan_ok(lp, P, threads, smem, 0, 0)) return -1;
  const Tail none = {};
  return P % 16 == 0
             ? launch<false, true>(x, seed, P, vh, out, lp, threads, smem, 0,
                                   none, (cudaStream_t)stream)
             : launch<false, false>(x, seed, P, vh, out, lp, threads, smem,
                                    0, none, (cudaStream_t)stream);
}

// Bob's decode tail (see the top of the file): bits (b, nb z) uint8;
// sources int32 (2, nb) (0 for a payload column); rx_pin, pin (b, P);
// rx_orig (rows, P); seed (P + vh - 1); expected (rows, vh); converged (b,)
// bool; iterations (b,) int32; mode 0 (first decode, rows = merged = b,
// mism (b,) int32) or 1 (a retry's rows merge, with order (rows,) int32:
// the merged output rows, decoded row k's at place k, then the kept rows;
// each row once), hat_old (rows, P)
// and stats_old (rows, 4) int32.  Writes hat (rows, P) and stats (rows,
// 4), at the plan's numbers (as qtpu_verify_hash's, and kept_ctas CTAs for
// the kept rows).  -1: rows <= 0, P outside 1..2^17 or not a whole number
// of the nb z-columns, vh outside 1..64, a mode's inputs missing, or a
// plan the kernel does not take.
extern "C" int qtpu_verify_tail(
    const uint8_t* bits, const int32_t* sources, int nb, int z,
    const uint8_t* rx_pin, const uint8_t* pin, const uint8_t* rx_orig,
    const uint8_t* seed, const uint8_t* expected, int vh,
    const uint8_t* converged, const int32_t* iterations, const int32_t* mism,
    const int32_t* order, const uint8_t* hat_old, const int32_t* stats_old,
    int mode, int rows, int merged, uint32_t P, uint8_t* hat, int32_t* stats,
    int cluster, int groups, int threads, int smem, int kept_ctas,
    void* stream) {
  if (!shape_ok(rows, P, vh) || nb <= 0 || z <= 0 || P % (uint32_t)z != 0
      || P / (uint32_t)z > (uint32_t)nb)
    return -1;
  if (mode == kFirst ? mism == nullptr || merged != rows
      : mode != kRows || order == nullptr
        || hat_old == nullptr || stats_old == nullptr)
    return -1;
  const Plan lp = {rows, merged, cluster, groups};
  if (!plan_ok(lp, P, threads, smem, nb, kept_ctas)) return -1;
  const unsigned long long zinv =
      ((1ULL << 32) + (unsigned long long)z - 1) / (unsigned long long)z;
  const Tail t = {bits, sources, nb, z, zinv, rx_pin, pin, rx_orig, expected,
                  converged, iterations, mism, order, hat_old, stats_old,
                  mode, hat, stats};
  // Whole 16-byte runs of one column, and hat's rows 16-byte aligned.
  const bool vec = P % 16 == 0 && z % 16 == 0 && ((uintptr_t)hat & 15) == 0;
  return vec ? launch<true, true>(nullptr, seed, P, vh, nullptr, lp, threads,
                                  smem, kept_ctas, t, (cudaStream_t)stream)
             : launch<true, false>(nullptr, seed, P, vh, nullptr, lp,
                                   threads, smem, kept_ctas, t,
                                   (cudaStream_t)stream);
}

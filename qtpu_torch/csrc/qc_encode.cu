// QC-LDPC syndrome encoding for Hopper (sm_90a), reading the codeword from
// its parts.
//
// Replaces what XLA fused inside the reference's jitted Alice program:
// qtpu/window_programs.py:269-278 (_encode: a roll and an XOR per base
// edge) over :389-400 (_build_codeword: payload, shortening fill and
// puncture pad columns concatenated, then one static column permutation),
// both inside alice_program (:407-421); and the standalone encoder
// qtpu/ldpc/encode.py:34-52 (one part, the identity permutation).  For a
// base edge (i, j, s), check (i, c) touches variable (j, (c + s) mod z):
//
//     syn[b, i*z + c] = XOR over row i's edges of x[b, j*z + (c + s) mod z]
//
// where base column j of x is the column at position pos[j] of the parts
// side by side (the reference's inv_order; the table holds pos[j] for
// each edge).  The codeword is never written to device memory.  Parallel
// edges (one (i, j) twice) XOR twice and cancel, as in the reference; they
// are not deduplicated.
//
// What bounds it on an H100: bytes.  At the production rung (n = 65536,
// z = 2048, mb = 9, 112 edges, B = 128) a launch reads the 8.13 MB payload
// and the 0.26 MB pad once and writes 2.36 MB of syndromes: 3.2 us at
// 3.35 TB/s.  The XORs are 7.3 M 32-bit operations (0.2 us at the SMs'
// instruction rate).
//
// What the design does about it: each input byte leaves device memory
// once and enters shared memory once; each output byte is written once,
// from registers.
//  * A CTA owns whole blocks (persistent: grid = min(b, SMs x CTAs an SM);
//    a CTA walks blocks blockIdx.x, + gridDim.x, ...).  One elected thread
//    stages a block by TMA bulk copies (cp.async.bulk) that complete on an
//    mbarrier: one copy a part's row (payload, fill, pad), so the block's
//    columns land side by side, each once.  With one copy a column the
//    copies alone took 6.2 us at the production rung against 3.3 us with
//    one a part (NVIDIA H100 80GB HBM3, 700 W).  The code table comes by
//    one bulk copy too.
//  * The codeword's bytes are bits: every body reads a byte's lowest bit
//    only (so does the plain version).  Where z % 32 == 0 the CTA packs
//    the staged bytes to bits in shared memory (16 bytes to 16 bits
//    by two multiplies), and the stage is refilled at once.  A thread then
//    computes a word of 32 syndrome bits of a row in a register: per edge
//    two conflict-free 32-bit shared loads (word k of the column and word
//    k + 1, or word 0 where the rotation wraps: a select, no halo, no
//    doubled column) and one funnel shift, with no branch.  A warp's 32
//    words are 1 KB of adjacent syndrome bytes: unpacked by multiplies and
//    passed between lanes by a shuffle, each 16-byte store instruction
//    writes 512 adjacent bytes.  No shared accumulator, no barrier
//    between rows.  XOR-ing the bytes themselves (two 16-byte shared loads
//    and ~50 instructions a run of 16 bytes and edge) made the SM, not
//    the copies, the limit.
//  * A ring of two stages where a CTA walks more than one block (or group
//    of columns): the next unit's copies are in flight while this one is
//    packed and computed.
//  * The general body: where a part is not 16-byte aligned, or z % 16 != 0,
//    the CTA's threads stage that part (two aligned 16-byte loads shifted
//    together, or bytes where z % 16 != 0); where z % 32 != 0 a thread
//    computes a run of 16 syndrome bytes from the staged bytes.
//  * Where a block's columns do not fit in shared memory (nb x z with its
//    bits above ~226 KB: z = 8192 at nb = 32), they are staged in groups
//    of adjacent columns; the second and later groups XOR into the
//    syndrome bytes the first group wrote (each stays with one lane).
//
// The entry point launches on the caller's stream, does not synchronise and
// returns cudaGetLastError() after its launch (0 on success), or -1 for
// arguments it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRun = 16;           // syndrome bytes a thread's run (z % 32)
constexpr int kMaxThreads = 1024;
constexpr int kStages = 2;

struct Parts {
  const uint8_t* base[3];
  long long row_bytes[3];   // a part's row: its columns x z
  int first[4];             // part p: positions first[p] .. first[p+1]-1
};

__host__ __device__ inline int round16(long long x) {
  return (int)((x + 15) & ~15LL);
}

// The table's words: row_start[mb + 1] padded to an even count, then an
// (position, shift) pair an edge, padded to whole 16 bytes.
__host__ __device__ inline int table_words(int mb, int E) {
  return (((mb + 2) & ~1) + 2 * E + 3) & ~3;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
               :: "r"(smem_addr(bar)) : "memory");
}

// The one arrival of the barrier's phase, expecting `bytes` of copies.
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
               "::bytes [%0], [%1], %2, [%3];"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes),
                  "r"(smem_addr(bar)) : "memory");
}

// Bytes r .. r + 15 of the 32 bytes lo | hi.
__device__ __forceinline__ uint4 window16(uint4 lo, uint4 hi, int r) {
  uint32_t a0, a1, a2, a3, a4;
  switch (r >> 2) {
    case 0: a0 = lo.x; a1 = lo.y; a2 = lo.z; a3 = lo.w; a4 = hi.x; break;
    case 1: a0 = lo.y; a1 = lo.z; a2 = lo.w; a3 = hi.x; a4 = hi.y; break;
    case 2: a0 = lo.z; a1 = lo.w; a2 = hi.x; a3 = hi.y; a4 = hi.z; break;
    default: a0 = lo.w; a1 = hi.x; a2 = hi.y; a3 = hi.z; a4 = hi.w; break;
  }
  const int sh = 8 * (r & 3);
  return make_uint4(__funnelshift_r(a0, a1, sh), __funnelshift_r(a1, a2, sh),
                    __funnelshift_r(a2, a3, sh), __funnelshift_r(a3, a4, sh));
}

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// A column's bytes (each 0 or 1; a byte's lowest bit is its bit) as bits,
// 16 bytes to 16 bits in order: byte 4m + j of the run to bit 4m + j.
__device__ __forceinline__ uint32_t pack16(uint4 x) {
  const auto nib = [](uint32_t w) {
    return ((w & 0x01010101u) * 0x01020408u) >> 24;
  };
  return nib(x.x) | nib(x.y) << 4 | nib(x.z) << 8 | nib(x.w) << 12;
}

// Bits 4m .. 4m + 3 of v as the bytes of a word.
__device__ __forceinline__ uint32_t unpack4(uint32_t v, int m) {
  return ((v >> (4 * m) & 15u) * 0x00204081u) & 0x01010101u;
}

// A stage holds `group` adjacent columns (positions g0 .. g0 + group - 1)
// of one block.  Unit t of a CTA is column group t % groups of its block
// t / groups; it uses stage t % stages at phase parity (t / stages) & 1.
// bulk_mask bit p: part p comes by bulk copy (16-byte aligned,
// z % 16 == 0; set for a part of no columns).  kBits: z % 32 == 0, the
// stage is packed to bits (group x z / 32 words after the stages) and a
// thread computes a word of 32 syndrome bits; else a thread computes a run
// of 16 syndrome bytes from the stage's bytes.
template <bool kBits>
__global__ void __launch_bounds__(kMaxThreads)
qc_encode_kernel(Parts parts, const int32_t* __restrict__ table, int B,
                 int mb, int z, int E, int group, int groups, int stages,
                 int bulk_mask, uint8_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ uint64_t bars[1 + kStages];      // the table's, each stage's
  const int nb = parts.first[3];
  const int stage_bytes = round16((long long)group * z);
  uint32_t* bits = reinterpret_cast<uint32_t*>(smem + (size_t)stages
                                                          * stage_bytes);
  int* tab = reinterpret_cast<int*>(
      smem + (size_t)stages * stage_bytes
      + (kBits ? round16((long long)group * z / 8) : 0));
  const int* row_start = tab;
  const int2* edges = reinterpret_cast<const int2*>(tab + ((mb + 2) & ~1));

  const int tid = threadIdx.x;
  const int units =
      (B - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x * groups;
  const bool manual = bulk_mask != 7;

  // Selects, not an indexed parameter array (which would go to the stack).
  auto part_row = [&](int p, int blk) {
    const uint8_t* base = p == 0 ? parts.base[0]
                          : p == 1 ? parts.base[1] : parts.base[2];
    const long long row = p == 0 ? parts.row_bytes[0]
                          : p == 1 ? parts.row_bytes[1] : parts.row_bytes[2];
    return base + blk * row;
  };
  // Part p's columns among positions g0 .. g0 + n - 1: [*lo, *hi).
  auto overlap = [&](int p, int g0, int n, int* lo, int* hi) {
    *lo = max(g0, parts.first[p]);
    *hi = min(g0 + n, parts.first[p + 1]);
    return *lo < *hi;
  };
  auto stage_of = [&](int t) {
    return smem + (size_t)(t % stages) * stage_bytes;
  };
  auto block_of = [&](int t) {
    return (int)blockIdx.x + t / groups * (int)gridDim.x;
  };

  // Thread 0: arm unit t's barrier and copy each bulk part's columns in.
  auto fetch = [&](int t) {
    uint8_t* stage = stage_of(t);
    uint64_t* bar = &bars[1 + t % stages];
    const int blk = block_of(t), g0 = t % groups * group;
    const int n = min(group, nb - g0);
    uint32_t bytes = 0;
    int lo, hi;
    for (int p = 0; p < 3; ++p)
      if ((bulk_mask >> p & 1) && overlap(p, g0, n, &lo, &hi))
        bytes += (uint32_t)(hi - lo) * z;
    bar_expect(bar, bytes);
    for (int p = 0; p < 3; ++p) {
      if (!(bulk_mask >> p & 1) || !overlap(p, g0, n, &lo, &hi)) continue;
      const uint8_t* src = part_row(p, blk)
                           + (long long)(lo - parts.first[p]) * z;
      bulk_copy(stage + (size_t)(lo - g0) * z, src, (uint32_t)(hi - lo) * z,
                bar);
    }
  };
  // Every thread is done with the stage of unit t (and the threads' own
  // writes to it come before the copies'): refill it with unit t + stages.
  auto release = [&](int t) {
    if (manual) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0 && t + stages < units) fetch(t + stages);
  };

  if (tid == 0) {
    for (int s = 0; s < 1 + stages; ++s) bar_init(&bars[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    const uint32_t tb = 4u * table_words(mb, E);
    bar_expect(&bars[0], tb);
    bulk_copy(tab, table, tb, &bars[0]);
    for (int t = 0; t < min(stages, units); ++t) fetch(t);
  }
  __syncthreads();

  for (int t = 0; t < units; ++t) {
    uint8_t* stage = stage_of(t);
    const int blk = block_of(t), g = t % groups, g0 = g * group;
    const int n = min(group, nb - g0);

    if (manual) {
      // The general body: the threads copy the parts no bulk copy brings.
      int lo, hi;
      for (int p = 0; p < 3; ++p) {
        if ((bulk_mask >> p & 1) || !overlap(p, g0, n, &lo, &hi)) continue;
        const uint8_t* src = part_row(p, blk)
                             + (long long)(lo - parts.first[p]) * z;
        uint8_t* dst = stage + (size_t)(lo - g0) * z;
        if (z % 16 == 0) {
          // Both loads lie in the 16-byte words that hold the run's bytes:
          // no read outside what the part's row covers.
          const int m = (int)(reinterpret_cast<uintptr_t>(src) & 15);
          const uint4* a = reinterpret_cast<const uint4*>(src - m);
          for (int k = tid; k < (hi - lo) * z / 16; k += blockDim.x) {
            const uint4 x = __ldg(a + k);
            reinterpret_cast<uint4*>(dst)[k] =
                m ? window16(x, __ldg(a + k + 1), m) : x;
          }
        } else {
          for (int k = tid; k < (hi - lo) * z; k += blockDim.x)
            dst[k] = __ldg(src + k);
        }
      }
      __syncthreads();
    }
    if (t == 0) bar_wait(&bars[0], 0);
    bar_wait(&bars[1 + t % stages], (t / stages) & 1);

    if constexpr (kBits) {
      // Pack the stage to bits; the stage is then free for the next copy.
      const uint4* s4 = reinterpret_cast<const uint4*>(stage);
      uint16_t* half = reinterpret_cast<uint16_t*>(bits);
      for (int k = tid; k < n * z / 16; k += blockDim.x)
        half[k] = (uint16_t)pack16(s4[k]);
      release(t);
      // A word of 32 syndrome bits a thread: bit c of row i is the XOR
      // over the row's edges of bit (c + s) mod z of the edge's column.  A
      // warp's 32 words are 1 KB of adjacent syndrome bytes (the rows of a
      // block lie side by side in `out`).
      const int words = z / 32, lane = tid & 31;
      for (int w0 = tid - lane; w0 < mb * words; w0 += blockDim.x) {
        const int w = w0 + lane;
        uint32_t acc = 0u;
        if (w < mb * words) {
          const int i = w / words, c0 = (w - i * words) * 32;
          const int e1 = row_start[i + 1];
#pragma unroll 4
          for (int e = row_start[i]; e < e1; ++e) {
            const int2 es = edges[e];          // (position, shift)
            const int q = es.x - g0;
            const bool mine = (unsigned)q < (unsigned)n;  // else another
            int p = c0 + es.y;                            // group's
            if (p >= z) p -= z;
            const uint32_t* col = bits + (mine ? q : 0) * words;
            const int k = p >> 5, k1 = k + 1 == words ? 0 : k + 1;
            const uint32_t v = __funnelshift_r(col[k], col[k1], p & 31);
            acc ^= mine ? v : 0u;
          }
        }
        // Lane L stores bytes 16 L .. 16 L + 15 of each 512-byte half of
        // the warp's 1 KB: half L & 1 of word w0 + L / 2 (+ 16), so each
        // store instruction writes 512 adjacent bytes.
        uint8_t* o = out + (long long)blk * mb * z + (long long)w0 * 32;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int from = 16 * h + (lane >> 1);
          const uint32_t a = __shfl_sync(0xffffffffu, acc, from)
                             >> (16 * (lane & 1));
          if (w0 + from < mb * words) {
            uint4* o4 = reinterpret_cast<uint4*>(o + 512 * h + 16 * lane);
            const uint4 v = make_uint4(unpack4(a, 0), unpack4(a, 1),
                                       unpack4(a, 2), unpack4(a, 3));
            *o4 = g ? xor4(*o4, v) : v;
          }
        }
      }
      __syncthreads();         // the bits are read before the next pack
    } else {
      // A run of 16 syndrome bytes a thread, from the stage's bytes (their
      // lowest bits, as the packed body reads them).
      const int runs = (z + kRun - 1) / kRun;
      for (int w = tid; w < mb * runs; w += blockDim.x) {
        const int i = w / runs, c0 = (w - i * runs) * kRun;
        uint32_t a[4] = {0u, 0u, 0u, 0u};
        const int e1 = row_start[i + 1];
        for (int e = row_start[i]; e < e1; ++e) {
          const int2 es = edges[e];            // (position, shift)
          const int q = es.x - g0;
          if ((unsigned)q >= (unsigned)n) continue;   // another group's
          int p = c0 + es.y;
          if (p >= z) p -= z;
          const uint8_t* col = stage + (size_t)q * z;
#pragma unroll
          for (int k = 0; k < kRun; ++k) {
            const int x = p + k;
            a[k >> 2] ^= (uint32_t)(col[x < z ? x : x % z] & 1u)
                         << (8 * (k & 3));
          }
        }
        uint8_t* o = out + ((long long)blk * mb + i) * z + c0;
#pragma unroll
        for (int k = 0; k < kRun; ++k) {
          if (k >= z - c0) break;
          const uint8_t v = (uint8_t)(a[k >> 2] >> (8 * (k & 3)));
          o[k] = g ? (uint8_t)(o[k] ^ v) : v;
        }
      }
      release(t);
    }
  }
}

// What a launch needs beyond its arguments, once per device: SMs, and the
// dynamic shared memory a CTA may take (both kernels opted in to it).
struct Device {
  int sms = 0;
  size_t smem = 0;
};

int device_limits(Device* out) {
  constexpr int kMaxDevices = 64;
  static Device known[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return -1;
  if (known[dev].sms == 0) {
    Device d;
    int optin = 0;
    e = cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
    const void* kernels[2] = {(const void*)qc_encode_kernel<true>,
                              (const void*)qc_encode_kernel<false>};
    size_t fixed = 0;            // the barriers' static shared memory
    for (const void* k : kernels) {
      cudaFuncAttributes attr;
      e = cudaFuncGetAttributes(&attr, k);
      if (e != cudaSuccess) return (int)e;
      if (attr.sharedSizeBytes > fixed) fixed = attr.sharedSizeBytes;
    }
    d.smem = (size_t)optin - fixed;
    for (const void* k : kernels) {
      e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)d.smem);
      if (e != cudaSuccess) return (int)e;
    }
    known[dev] = d;
  }
  *out = known[dev];
  return 0;
}

struct Plan {
  int grid, threads, smem, stages, group, groups, bulk_mask;
};

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

// Bit p: part p comes by bulk copy (or has no columns).
int bulk_parts(const Parts& parts, int z) {
  int mask = 0;
  for (int p = 0; p < 3; ++p)
    if (z % 16 == 0 && (parts.row_bytes[p] == 0 || aligned16(parts.base[p])))
      mask |= 1 << p;
  return mask;
}

// The launch's shape (0), or -1 / a CUDA error.  The block's columns in
// one stage if they fit beside their bits and the table, else in groups;
// two stages where a CTA walks more than one unit; threads as below.
int make_plan(const Parts& parts, int b, int mb, int z, int E, Plan* plan) {
  Device d;
  const int e = device_limits(&d);
  if (e != 0) return e;
  const int nb = parts.first[3];
  const bool packed = z % 32 == 0;
  const size_t tb = 4 * (size_t)table_words(mb, E);
  // A column's shared memory a stage, and in bits (z / 8 bytes, once).
  const size_t col = z, col_bits = packed ? z / 8 : 0;
  if (tb + kStages * col + col_bits > d.smem) return -1;
  Plan p = {};
  p.group = nb;
  if ((size_t)round16((long long)nb * z) + round16(nb * col_bits) + tb
      > d.smem)
    p.group = (int)((d.smem - tb - 32) / (kStages * col + col_bits));
  p.groups = (nb + p.group - 1) / p.group;
  const size_t stage = round16((long long)p.group * z);
  const size_t fixed = round16(p.group * col_bits) + tb;
  p.stages = kStages * stage + fixed <= d.smem ? kStages : 1;
  // Threads: the rows' words (or runs of 16 bytes), and a quarter of the
  // stage's 16-byte chunks to pack, up to kMaxThreads, spread evenly.
  const int items = packed ? mb * (z / 32) : mb * ((z + kRun - 1) / kRun);
  const int work = max(items, packed ? p.group * z / 64 : 0);
  const int per = (work + kMaxThreads - 1) / kMaxThreads;
  p.threads = ((work + per - 1) / per + 31) / 32 * 32;
  p.bulk_mask = bulk_parts(parts, z);
  const void* kernel = packed ? (const void*)qc_encode_kernel<true>
                              : (const void*)qc_encode_kernel<false>;
  int occ = 0;
  const cudaError_t ce = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &occ, kernel, p.threads, p.stages * stage + fixed);
  if (ce != cudaSuccess) return (int)ce;
  if (occ < 1) return -1;
  p.grid = b < d.sms * occ ? b : d.sms * occ;
  if (p.grid == b && p.groups == 1) p.stages = 1;   // one unit a CTA
  p.smem = (int)(p.stages * stage + fixed);
  *plan = p;
  return 0;
}

Parts make_parts(const uint8_t* part0, const uint8_t* part1,
                 const uint8_t* part2, int width0, int width1, int width2,
                 int z) {
  return {{part0, part1, part2},
          {(long long)width0 * z, (long long)width1 * z,
           (long long)width2 * z},
          {0, width0, width0 + width1, width0 + width1 + width2}};
}

bool bad_shape(int b, int mb, int nb, int z, int E, int width0, int width1,
               int width2) {
  return b <= 0 || mb <= 0 || nb <= 0 || z <= 0 || E < 0 || width0 < 0
         || width1 < 0 || width2 < 0 || width0 + width1 + width2 != nb;
}

}  // namespace

// (b, mb*z) uint8 syndromes into `out` (contiguous, 16-byte aligned).
// part0..2: the codeword's parts, uint8 (b, width_p * z) contiguous, null
// where width_p is 0, their columns side by side making positions 0 ..
// nb - 1; table (16-byte aligned): int32 row_start[mb + 1] padded to an
// even count, then (position, shift in [0, z)) for each edge by row,
// padded to whole 16 bytes (ldpc/encode.py, code_table).  -1: b, mb, nb
// or z not positive, widths not summing to nb, a table too large for the
// shared memory.
extern "C" int qtpu_qc_encode(const uint8_t* part0, const uint8_t* part1,
                              const uint8_t* part2, int width0, int width1,
                              int width2, const int32_t* table, int b, int mb,
                              int nb, int z, int E, uint8_t* out,
                              void* stream) {
  if (bad_shape(b, mb, nb, z, E, width0, width1, width2) || !aligned16(out)
      || !aligned16(table))
    return -1;
  const Parts parts = make_parts(part0, part1, part2, width0, width1, width2,
                                 z);
  Plan p;
  const int rc = make_plan(parts, b, mb, z, E, &p);
  if (rc != 0) return rc;
  if (z % 32 == 0)
    qc_encode_kernel<true><<<p.grid, p.threads, p.smem,
                             (cudaStream_t)stream>>>(
        parts, table, b, mb, z, E, p.group, p.groups, p.stages,
        p.bulk_mask, out);
  else
    qc_encode_kernel<false><<<p.grid, p.threads, p.smem,
                              (cudaStream_t)stream>>>(
        parts, table, b, mb, z, E, p.group, p.groups, p.stages,
        p.bulk_mask, out);
  return (int)cudaGetLastError();
}

// The launch qtpu_qc_encode would make for these arguments, on the current
// device: plan[0..7] = grid, threads, dynamic shared memory a CTA, stages,
// columns a stage, column groups a block, bulk_mask (bit p: part p comes
// by bulk copy), and the body (0: every part by bulk copy, 1: some, 2:
// none).  -1 as qtpu_qc_encode.
extern "C" int qtpu_qc_encode_plan(const uint8_t* part0, const uint8_t* part1,
                                   const uint8_t* part2, int width0,
                                   int width1, int width2, int b, int mb,
                                   int nb, int z, int E, int* plan) {
  if (bad_shape(b, mb, nb, z, E, width0, width1, width2)) return -1;
  const Parts parts = make_parts(part0, part1, part2, width0, width1, width2,
                                 z);
  Plan p;
  const int rc = make_plan(parts, b, mb, z, E, &p);
  if (rc != 0) return rc;
  int bulk = 0, used = 0;
  for (int k = 0; k < 3; ++k) {
    if (parts.row_bytes[k] == 0) continue;
    ++used;
    bulk += p.bulk_mask >> k & 1;
  }
  const int out[8] = {p.grid, p.threads, p.smem, p.stages, p.group,
                      p.groups, p.bulk_mask,
                      bulk == used ? 0 : (bulk ? 1 : 2)};
  for (int k = 0; k < 8; ++k) plan[k] = out[k];
  return 0;
}

// Bob's disclosure pins and channel LLRs for Hopper (sm_90a), in one pass.
//
// Replaces what XLA fused inside the reference's jitted Bob programs:
// qtpu/window_programs.py:345-362 (_pin_masks), :423-453 (_bob_core: the
// shortening and test pins scattered into the received payload, the
// mismatch count) and :455-471 (the LLR assembly of _decode_core: payload
// LLRs from the pinned bits, shortening-fill columns at +-BIG_LLR,
// punctured columns at 0, one static column permutation), inside
// bob_program (:483) and its two retry programs (:537, :565).
//
// Two entry points:
//  * qtpu_pin_llr (Bob's first decode): in gather form, with no scatter.
//    Payload position p of row r is a shortening pin iff
//    inv_s = a^-1 (p - b_s) mod P < s, with value short_alice[r, inv_s], and
//    a test pin iff Sm <= inv_t = a^-1 (p - boff_t[r]) mod P < Sm + k, with
//    value test_alice[r, inv_t - Sm]; where both hold the test value wins
//    (the port's scatter order; both are Alice's bit at p).  It writes
//    rx_pin, the pin mask (0/1 bytes of a bool tensor), the per-row
//    mismatch count (the sum of rx_pin ^ rx; int32, the row's block sums
//    it) and the (b, n) float32 LLR in base-column order.
//  * qtpu_llr (the retries): the LLR alone from a given rx_pin and pin mask.
//
// The LLR values follow the reference's float32 expressions, each rounded
// as it is (nvcc -fmad=false): payload (1 - 2 rx_pin) * (pin ? BIG_LLR :
// qmag), shortening columns (1 - 2 fill) * BIG_LLR, punctured +0.0.  For
// bits 0/1 every product is +-1 times a float32, so every value is exact.
//
// What bounds it on an H100.  At the production rung (P = 63,488, n =
// 65,536, b = 128) qtpu_pin_llr reads the 8.13 MB received payload (and the
// few disclosed bits) and writes rx_pin and the mask (8.13 MB each) and the
// 33.55 MB LLR: 17.9 us at 3.35 TB/s, bound by bytes.  The index arithmetic
// is an add and a compare a position and family.  qtpu_llr for 8 retry rows
// moves ~3 MB: launch-bound.
//
// What the design does about it.
//  * A thread owns a run of kRun = 16 consecutive positions of one base
//    column of one row; runs are numbered in base-column order, so thread
//    t of a row writes the row's LLR floats [16 t, 16 t + 16).  Where z is
//    a multiple of 16 (every ladder's z is: 2,048, 64, 16), a run's
//    received, pinned and mask bytes are one 16-byte load or store each
//    (an input that starts off alignment: two aligned loads shifted
//    together; the outputs, which the wrappers allocate, are aligned);
//    each warp hands its 512 LLR floats through a swizzled 2 KB of shared
//    memory, so that each of its four float4 stores writes 512 contiguous
//    bytes.  Otherwise (z not a multiple of 16) the same threads move a
//    byte and a float at a time.
//  * No 64-bit modulo: a thread computes its run's first two inverses
//    from 64-bit products reduced by a Barrett reciprocal of P (computed
//    on the host), then steps them by a^-1 with an add and a compare a
//    position.
//  * qtpu_pin_llr: a block of up to 1,024 threads a row, whose warps walk
//    the row's runs (4 a thread at n = 65,536).  The row's mismatch count
//    is the block's sum (warp sums through shared memory), written once:
//    no memset before the launch (a second node on the stream) and no
//    atomics.  At B = 128, 128 of the 132 SMs stream a row each.
//  * qtpu_llr: blocks of 256 threads, as many a row as its runs need, so
//    that 8 retry rows still spread over 128 blocks.
//
// Each entry point launches on the caller's stream, does not synchronise
// and returns cudaGetLastError() after its launch (0 on success), or -1 for
// arguments it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;        // threads a pin_llr block (a row)
constexpr int kLlrThreads = 256;          // threads an llr block
constexpr int kRowsPerGrid = 65535;       // gridDim.y limit
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kRun = 16;                  // positions a thread
constexpr int kStage = 4 * 32 * 16;       // bytes of a warp's LLR stage
constexpr float kBigLLR = 1e9f;           // qtpu_torch.ldpc.decode.BIG_LLR

enum Part { kPayload = 0, kFill = 1, kPad = 2 };

struct Pins {            // qtpu_pin_llr's disclosure inputs
  const uint8_t* rx;
  const uint8_t* short_alice;
  long long short_stride;
  const uint8_t* test_alice;
  long long test_stride;
  const int64_t* boff_t;
  uint32_t ainv, b_s, s, k, s_max;
  unsigned long long mu;  // floor((2^64 - 1) / P)
  int32_t* mism;
};

// x mod P for x < 2^63, with mu = floor((2^64 - 1) / P): the quotient
// estimate is floor(x / P) or one less, so one conditional subtract.
__device__ __forceinline__ uint32_t mod_p(unsigned long long x, uint32_t P,
                                          unsigned long long mu) {
  const unsigned long long q = __umul64hi(x, mu);
  const uint32_t r = (uint32_t)(x - q * P);
  return r >= P ? r - P : r;
}

__device__ __forceinline__ uint32_t step_mod(uint32_t x, uint32_t d,
                                             uint32_t P) {
  x += d;
  return x >= P ? x - P : x;
}

// The float32 LLR of bit v (0/1) at magnitude mag: (1 - 2v) * mag.
__device__ __forceinline__ float signed_mag(uint32_t v, float mag) {
  return __fmul_rn(__fsub_rn(1.0f, __fmul_rn(2.0f, (float)v)), mag);
}

// Byte m (< 16) of a 16-byte vector held as four words.
__device__ __forceinline__ uint32_t byte_of(const uint32_t (&w)[4], int m) {
  return (w[m >> 2] >> (8 * (m & 3))) & 0xFFu;
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

__device__ __forceinline__ void store16(uint8_t* p, const uint32_t (&w)[4]) {
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// Rows blockIdx.y (+ gridDim.y ...), the row's runs from blockIdx.x *
// blockDim.x on.  kPin: qtpu_pin_llr (pins from the disclosures, rx_pin/pin
// written, the row's mismatch count: one block a row, gridDim.x == 1); else
// qtpu_llr (rx_pin and pin given).  kVec: z % 16 == 0 and the outputs
// 16-byte aligned (16-byte loads and stores, staged float4 stores).
template <bool kPin, bool kVec>
__global__ void __launch_bounds__(kMaxThreads)
assemble_kernel(Pins pins, uint8_t* __restrict__ rx_pin,
                uint8_t* __restrict__ pin, const uint8_t* __restrict__ fill,
                long long fill_stride, const int32_t* __restrict__ sources,
                int b, int nb, int z, uint32_t P, float qmag,
                float* __restrict__ llr) {
  extern __shared__ __align__(16) unsigned char stage[];  // kStage a warp
  __shared__ int warp_counts[kMaxWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t R = (uint32_t)(z + kRun - 1) / kRun;   // runs a column
  const uint32_t runs = (uint32_t)nb * R;
  const long long n = (long long)nb * z;
  // The vector path hands each warp's 512 LLR floats (thread t's are the
  // row's [16 t, 16 t + 16), z % 16 == 0) through shared memory, so that
  // float4 q of the warp's 128 goes to lane q % 32 of store q / 32.  Float4
  // m of lane l sits at 4 l + (m ^ ((l >> 1) & 3)): neither side has a
  // bank conflict.
  float4* st = reinterpret_cast<float4*>(stage + kStage * warp);
  const int swz = (lane >> 1) & 3;
  for (long long r = blockIdx.y; r < b; r += gridDim.y) {
    const uint8_t* sa = pins.short_alice + r * pins.short_stride;
    const uint8_t* ta = pins.test_alice + r * pins.test_stride;
    const uint32_t boff = kPin ? mod_p((unsigned long long)pins.boff_t[r], P,
                                       pins.mu) : 0;
    int count = 0;
    // The warps walk the row's runs, 32 consecutive runs a warp at a time.
    for (uint32_t t0 = blockIdx.x * blockDim.x + 32 * warp; t0 < runs;
         t0 += gridDim.x * blockDim.x) {
      const uint32_t t = t0 + lane;
      const bool active = t < runs;
      const uint32_t j = active ? t / R : 0;
      const int k0 = (int)(t - j * R) * kRun;             // first position
      const int len = z - k0 < kRun ? z - k0 : kRun;
      const int part = sources[j];
      const int col = sources[nb + j];
      float* Lp = llr + r * n + (long long)j * z + k0;
      float4 acc;
      // LLR m of the run: staged four at a time, or stored.
      auto put = [&](int m, float v) {
        if (kVec) {
          (&acc.x)[m & 3] = v;
          if ((m & 3) == 3) st[4 * lane + ((m >> 2) ^ swz)] = acc;
        } else {
          Lp[m] = v;
        }
      };
      if (active && part == kPad) {
#pragma unroll
        for (int m = 0; m < kRun; ++m)
          if (kVec || m < len) put(m, 0.0f);
      } else if (active && part == kFill) {
        const uint8_t* f = fill + r * fill_stride + (long long)col * z + k0;
        uint32_t fw[4];
        if (kVec) load16(fw, f);
#pragma unroll
        for (int m = 0; m < kRun; ++m)
          if (kVec || m < len)
            put(m, signed_mag(kVec ? byte_of(fw, m) : __ldg(f + m), kBigLLR));
      } else if (active) {
        const long long base = r * P + (long long)col * z + k0;
        uint32_t inv_s = 0, inv_t = 0;
        uint32_t in[4], pw[4], out[4] = {0, 0, 0, 0}, mask[4] = {0, 0, 0, 0};
        if (kPin) {
          // Position p0 = col * z + k0 < P; its inverses under both offsets.
          const uint32_t p0 = (uint32_t)(col * z + k0);
          const uint32_t d_s = step_mod(p0, P - pins.b_s, P);
          const uint32_t d_t = step_mod(p0, P - boff, P);
          inv_s = mod_p((unsigned long long)pins.ainv * d_s, P, pins.mu);
          inv_t = mod_p((unsigned long long)pins.ainv * d_t, P, pins.mu);
          if (kVec) load16(in, pins.rx + base);
        } else if (kVec) {
          load16(in, rx_pin + base);
          load16(pw, pin + base);
        }
#pragma unroll
        for (int m = 0; m < kRun; ++m) {
          if (!kVec && m >= len) break;
          uint32_t v;
          bool pinned;
          if (kPin) {
            const uint32_t v0 =
                kVec ? byte_of(in, m) : __ldg(pins.rx + base + m);
            v = v0;
            pinned = false;
            if (inv_s < pins.s) {
              v = __ldg(sa + inv_s);
              pinned = true;
            }
            if (inv_t - pins.s_max < pins.k) {    // s_max <= inv_t < s_max + k
              v = __ldg(ta + (inv_t - pins.s_max));
              pinned = true;
            }
            count += (int)(v ^ v0);
            if (kVec) {
              out[m >> 2] |= v << (8 * (m & 3));
              mask[m >> 2] |= (uint32_t)pinned << (8 * (m & 3));
            } else {
              rx_pin[base + m] = (uint8_t)v;
              pin[base + m] = pinned ? 1 : 0;
            }
            inv_s = step_mod(inv_s, pins.ainv, P);
            inv_t = step_mod(inv_t, pins.ainv, P);
          } else {
            v = kVec ? byte_of(in, m) : __ldg(rx_pin + base + m);
            pinned = (kVec ? byte_of(pw, m) : __ldg(pin + base + m)) != 0;
          }
          put(m, signed_mag(v, pinned ? kBigLLR : qmag));
        }
        if (kPin && kVec) {
          store16(rx_pin + base, out);
          store16(pin + base, mask);
        }
      }
      if (kVec) {
        __syncwarp();
        float4* Lrow = reinterpret_cast<float4*>(llr + r * n) + 4 * t0;
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int q = 32 * m + lane, o = q >> 2;
          if (t0 + o < runs) Lrow[q] = st[4 * o + ((q & 3) ^ ((o >> 1) & 3))];
        }
        __syncwarp();
      }
    }
    if (kPin) {
      // The row's count: each warp's sum, then their sum in one thread.
      count = __reduce_add_sync(0xffffffffu, count);
      if (lane == 0) warp_counts[warp] = count;
      __syncthreads();
      if (threadIdx.x == 0) {
        int sum = 0;
        for (int w = 0; w < (int)(blockDim.x >> 5); ++w) sum += warp_counts[w];
        pins.mism[r] = sum;
      }
      __syncthreads();
    }
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

template <bool kPin>
int launch(bool vec, const Pins& pins, uint8_t* rx_pin, uint8_t* pin,
           const uint8_t* fill, long long fill_stride, const int32_t* sources,
           int b, int nb, int z, uint32_t P, float qmag, float* llr,
           cudaStream_t stream) {
  // A thread a run, whole warps.  qtpu_pin_llr: a block a row (the row's
  // count in one block), up to kMaxThreads; qtpu_llr: kLlrThreads a block,
  // as many blocks as the row's runs need (a few retry rows fill the card).
  const long long runs = (long long)nb * ((z + kRun - 1) / kRun);
  const int most = kPin ? kMaxThreads : kLlrThreads;
  const int threads = runs < most ? (int)(runs + 31) / 32 * 32 : most;
  const dim3 grid(kPin ? 1 : (unsigned)((runs + threads - 1) / threads),
                  (unsigned)(b < kRowsPerGrid ? b : kRowsPerGrid));
  if (vec) {
    const cudaError_t e = cudaFuncSetAttribute(
        (const void*)assemble_kernel<kPin, true>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxWarps * kStage);
    if (e != cudaSuccess) return (int)e;
    assemble_kernel<kPin, true><<<grid, threads, threads / 32 * kStage,
                                  stream>>>(pins, rx_pin, pin, fill,
                                            fill_stride, sources, b, nb, z, P,
                                            qmag, llr);
  } else {
    assemble_kernel<kPin, false><<<grid, threads, 0, stream>>>(
        pins, rx_pin, pin, fill, fill_stride, sources, b, nb, z, P, qmag, llr);
  }
  return (int)cudaGetLastError();
}

// The vector path's conditions beyond pin_llr's byte outputs' alignment
// (the wrappers allocate every output, so they hold).
bool vector_shape(int z, const float* llr) {
  return z % kRun == 0 && aligned16(llr);
}

}  // namespace

// Bob's first decode.  rx: the received payload, uint8 (b, P) contiguous;
// short_alice (b, >= s) and test_alice (b, >= k) uint8, rows
// `short_stride` / `test_stride` bytes apart; boff_t: int64 (b,) test
// offsets, non-negative (taken mod P); ainv = a^-1 mod P, b_s < P, s, k,
// s_max: the header's disclosure family; fill: uint8 (b, fill_stride)
// shortening fill, null without shortened columns; sources: int32
// src_part[nb], src_col[nb] (0 payload, 1 fill, 2 pad).  Writes rx_pin
// (b, P) uint8, pin (b, P) 0/1 bytes, mism (b,) int32, llr (b, nb*z)
// float32.  -1: b, nb, z or P not positive, P > 2^17, ainv
// or b_s outside [0, P).
extern "C" int qtpu_pin_llr(const uint8_t* rx, const uint8_t* short_alice,
                            long long short_stride, const uint8_t* test_alice,
                            long long test_stride, const int64_t* boff_t,
                            uint32_t ainv, uint32_t b_s, uint32_t s,
                            uint32_t k, uint32_t s_max, const uint8_t* fill,
                            long long fill_stride, const int32_t* sources,
                            int b, int nb, int z, uint32_t P, float qmag,
                            uint8_t* rx_pin, uint8_t* pin, int32_t* mism,
                            float* llr, void* stream) {
  if (b <= 0 || nb <= 0 || z <= 0 || P == 0 || P > (1u << 17) || ainv >= P
      || b_s >= P)
    return -1;
  const Pins pins = {rx, short_alice, short_stride, test_alice, test_stride,
                     boff_t, ainv, b_s, s, k, s_max, ~0ULL / P, mism};
  const bool vec = vector_shape(z, llr) && aligned16(rx_pin)
                   && aligned16(pin);
  return launch<true>(vec, pins, rx_pin, pin, fill, fill_stride, sources, b,
                      nb, z, P, qmag, llr, (cudaStream_t)stream);
}

// The retries: llr (b, nb*z) float32 from rx_pin (b, P) uint8 and pin
// (b, P) bool bytes, fill and sources as above.  -1: b, nb, z or P not
// positive.
extern "C" int qtpu_llr(const uint8_t* rx_pin, const uint8_t* pin,
                        const uint8_t* fill, long long fill_stride,
                        const int32_t* sources, int b, int nb, int z,
                        uint32_t P, float qmag, float* llr, void* stream) {
  if (b <= 0 || nb <= 0 || z <= 0 || P == 0) return -1;
  const Pins none = {};
  const bool vec = vector_shape(z, llr);
  return launch<false>(vec, none, const_cast<uint8_t*>(rx_pin),
                       const_cast<uint8_t*>(pin), fill, fill_stride, sources,
                       b, nb, z, P, qmag, llr, (cudaStream_t)stream);
}

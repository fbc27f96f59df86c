// Bob's disclosure pins and channel LLRs for Hopper (sm_90a), in one pass.
//
// Replaces what XLA fused inside the reference's jitted Bob programs:
// qtpu/window_programs.py:345-362 (_pin_masks), :423-453 (_bob_core: the
// shortening and test pins scattered into the received payload, the
// mismatch count) and :455-471 (the LLR assembly of _decode_core: payload
// LLRs from the pinned bits, shortening-fill columns at +-BIG_LLR,
// punctured columns at 0, one static column permutation), inside
// bob_program (:483), retry_program (:537) and retry_small (:565).
//
// Two entry points:
//  * qtpu_pin_llr (Bob's first decode): in gather form, with no scatter.
//    Payload position p of row r is a shortening pin iff
//    inv_s = a^-1 (p - b_s) mod P < s, with value short_alice[r, inv_s], and
//    a test pin iff Sm <= inv_t = a^-1 (p - boff_t[r]) mod P < Sm + k, with
//    value test_alice[r, inv_t - Sm]; where both hold the test value wins
//    (the port's scatter order; both are Alice's bit at p).  It writes
//    rx_pin, the pin mask (0/1 bytes of a bool tensor), the per-row
//    mismatch count (rx_pin != rx; int32, a warp's sum then atomicAdd,
//    exact in any order) and the (b, n) float32 LLR in base-column order.
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
// 33.55 MB LLR: 17.4 us at 3.35 TB/s, bound by bytes.  The index arithmetic
// is two 64-bit products a thread and one add-and-compare a position per
// family.  qtpu_llr for 8 retry rows moves ~3 MB: launch-bound.
//
// What the design does about it.
//  * One CTA per (base column, row): the column's source (payload column,
//    fill column or pad) is uniform in the CTA; threads stride the z
//    positions, so loads and stores are coalesced.
//  * Each thread computes its first position's inverses once (64-bit
//    products, P <= 2^17) and steps them by kThreads * a^-1 mod P with one
//    add and one compare, instead of a modulo a position.
//
// Each entry point launches on the caller's stream, does not synchronise
// and returns cudaGetLastError() after its launch (0 on success), or -1 for
// arguments it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerGrid = 65535;       // gridDim.y limit
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
  int32_t* mism;
};

__device__ __forceinline__ uint32_t mulmod(uint32_t a, uint32_t x,
                                           uint32_t P) {
  return (uint32_t)(((unsigned long long)a * x) % P);
}

__device__ __forceinline__ uint32_t step_mod(uint32_t x, uint32_t d,
                                             uint32_t P) {
  x += d;
  return x >= P ? x - P : x;
}

// The float32 LLR of bit v (0/1) at magnitude mag: (1 - 2v) * mag.
__device__ __forceinline__ float signed_mag(uint8_t v, float mag) {
  return __fmul_rn(__fsub_rn(1.0f, __fmul_rn(2.0f, (float)v)), mag);
}

// kPin: qtpu_pin_llr (pins from the disclosures, rx_pin/pin written);
// else qtpu_llr (rx_pin and pin given).
template <bool kPin>
__global__ void __launch_bounds__(kThreads)
assemble_kernel(Pins pins, uint8_t* __restrict__ rx_pin,
                uint8_t* __restrict__ pin, const uint8_t* __restrict__ fill,
                long long fill_stride, const int32_t* __restrict__ sources,
                int b, int nb, int z, uint32_t P, float qmag,
                float* __restrict__ llr) {
  const int j = blockIdx.x;
  const int part = sources[j];
  const int col = sources[nb + j];
  const int tid = threadIdx.x;
  for (int r = blockIdx.y; r < b; r += gridDim.y) {
    float* L = llr + ((long long)r * nb + j) * z;
    if (part == kPad) {
      for (int t = tid; t < z; t += kThreads) L[t] = 0.0f;
      continue;
    }
    if (part == kFill) {
      const uint8_t* f = fill + r * fill_stride + (long long)col * z;
      for (int t = tid; t < z; t += kThreads)
        L[t] = signed_mag(__ldg(f + t), kBigLLR);
      continue;
    }
    const long long base = (long long)r * P + (long long)col * z;
    if (!kPin) {
      for (int t = tid; t < z; t += kThreads)
        L[t] = signed_mag(__ldg(rx_pin + base + t),
                          __ldg(pin + base + t) ? kBigLLR : qmag);
      continue;
    }
    // Position p = col * z + t; its inverses under both offsets, stepped.
    const uint32_t p0 = (uint32_t)(col * z + tid);
    const uint32_t boff = (uint32_t)pins.boff_t[r];
    const uint32_t d = mulmod(pins.ainv, kThreads % P, P);
    uint32_t inv_s = mulmod(pins.ainv, (p0 % P + P - pins.b_s) % P, P);
    uint32_t inv_t = mulmod(pins.ainv, (p0 % P + P - boff) % P, P);
    const uint8_t* sa = pins.short_alice + r * pins.short_stride;
    const uint8_t* ta = pins.test_alice + r * pins.test_stride;
    int count = 0;
    for (int t = tid; t < z; t += kThreads) {
      const uint8_t v0 = __ldg(pins.rx + base + t);
      uint8_t v = v0;
      bool pinned = false;
      if (inv_s < pins.s) {
        v = __ldg(sa + inv_s);
        pinned = true;
      }
      if (inv_t >= pins.s_max && inv_t - pins.s_max < pins.k) {
        v = __ldg(ta + (inv_t - pins.s_max));
        pinned = true;
      }
      rx_pin[base + t] = v;
      pin[base + t] = pinned ? 1 : 0;
      count += v != v0;
      L[t] = signed_mag(v, pinned ? kBigLLR : qmag);
      inv_s = step_mod(inv_s, d, P);
      inv_t = step_mod(inv_t, d, P);
    }
    count = __reduce_add_sync(0xffffffffu, count);
    if ((tid & 31) == 0 && count) atomicAdd(pins.mism + r, count);
  }
}

dim3 grid_of(int nb, int b) {
  return dim3((unsigned)nb, (unsigned)(b < kRowsPerGrid ? b : kRowsPerGrid));
}

}  // namespace

// Bob's first decode.  rx: the received payload, uint8 (b, P) contiguous;
// short_alice (b, >= s) and test_alice (b, >= k) uint8, rows
// `short_stride` / `test_stride` bytes apart; boff_t: int64 (b,) test
// offsets in [0, P); ainv = a^-1 mod P, b_s < P, s, k, s_max: the header's
// disclosure family; fill: uint8 (b, fill_stride) shortening fill, null
// without shortened columns; sources: int32 src_part[nb], src_col[nb]
// (0 payload, 1 fill, 2 pad).  Writes rx_pin (b, P) uint8, pin (b, P) 0/1
// bytes, mism (b,) int32 (zeroed here first), llr (b, nb*z) float32.  -1:
// b, nb, z or P not positive, P > 2^17, an offset outside [0, P).
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
  cudaError_t err = cudaMemsetAsync(mism, 0, (size_t)b * sizeof(int32_t),
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  const Pins pins = {rx, short_alice, short_stride, test_alice, test_stride,
                     boff_t, ainv, b_s, s, k, s_max, mism};
  assemble_kernel<true><<<grid_of(nb, b), kThreads, 0, (cudaStream_t)stream>>>(
      pins, rx_pin, pin, fill, fill_stride, sources, b, nb, z, P, qmag, llr);
  return (int)cudaGetLastError();
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
  assemble_kernel<false><<<grid_of(nb, b), kThreads, 0, (cudaStream_t)stream>>>(
      none, const_cast<uint8_t*>(rx_pin), const_cast<uint8_t*>(pin), fill,
      fill_stride, sources, b, nb, z, P, qmag, llr);
  return (int)cudaGetLastError();
}

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
// where base column j of x is column `col[j]` of part `part[j]` (the
// table's last 2*nb words).  The codeword is never written to device
// memory.  Parallel edges (one (i, j) twice) XOR twice and cancel, as in
// the reference; they are not deduplicated.
//
// What bounds it on an H100.  At the production rung (n = 65536, z = 2048,
// mb = 9, 112 edges, B = 128) a launch reads the 8.13 MB payload and the
// 0.26 MB pad once and writes 2.36 MB of syndromes: 3.2 us at 3.35 TB/s.
// The XORs are 7.3 M 32-bit operations (0.2 us at the SMs' issue rate),
// nothing beside the bytes.  Each x column is read by deg(column) CTAs,
// mostly from L2.
//
// What the design does about it.
//  * One CTA per (base row i, block b): it stages its row's source columns
//    in shared memory, each written twice in a row (2z bytes), so the
//    rotated window starting at s is contiguous: output word w of the row
//    is the four bytes at s + 4w, two aligned 32-bit shared loads and one
//    funnel shift per edge, no modulo.
//  * Staging uses 16-byte loads where z is a multiple of 16 and the
//    column's address is 16-byte aligned, else byte loads (z = 64 test
//    codes, unaligned parts).  Rows wider than the shared memory holds are
//    staged in groups of columns.
//  * The row's z syndrome bytes accumulate in shared memory, each word
//    owned by one thread, and are written once: 32-bit stores where the
//    output row is 4-byte aligned, else byte stores.
//
// The entry point launches on the caller's stream, does not synchronise and
// returns cudaGetLastError() after its launch (0 on success), or -1 for
// arguments it does not take.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBudget = 48 * 1024;   // dynamic shared memory, no opt-in
constexpr int kMaxGroup = 32;            // columns staged at once
constexpr int kRowsPerGrid = 65535;      // gridDim.y limit

__host__ __device__ inline int round16(int x) { return (x + 15) & ~15; }

// Bytes of one staged column: the column twice, then 8 bytes of slack for
// the last word's second load.
__host__ __device__ inline int column_bytes(int z) {
  return round16(2 * z + 8);
}

struct Parts {
  const uint8_t* base[3];
  long long row_bytes[3];   // a part's row: its columns x z
};

// The four bytes col[off .. off + 3] of a staged column (4-byte aligned).
__device__ __forceinline__ uint32_t load4(const uint8_t* col, int off) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(col);
  const int k = off >> 2;
  return __funnelshift_r(w[k], w[k + 1], 8 * (off & 3));
}

__global__ void __launch_bounds__(kThreads)
qc_encode_kernel(Parts parts, const int32_t* __restrict__ table, int B,
                 int mb, int nb, int z, int E, int group,
                 uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  __shared__ const uint8_t* src[kMaxGroup];
  __shared__ int shift[kMaxGroup];
  const int* row_start = table;
  const int* edge_col = table + mb + 1;
  const int* edge_shift = edge_col + E;
  const int* src_part = edge_shift + E;
  const int* src_col = src_part + nb;

  const int i = blockIdx.x;
  const int tid = threadIdx.x;
  const int zw = (z + 3) / 4;                       // output words a row
  const int cb = column_bytes(z);
  uint32_t* acc = reinterpret_cast<uint32_t*>(smem);
  uint8_t* cols = reinterpret_cast<uint8_t*>(smem) + round16(4 * zw);
  const int e0 = row_start[i], e1 = row_start[i + 1];

  for (int b = blockIdx.y; b < B; b += gridDim.y) {
    for (int w = tid; w < zw; w += kThreads) acc[w] = 0u;
    for (int g = e0; g < e1; g += group) {
      const int ng = min(group, e1 - g);
      __syncthreads();          // the previous group's columns are read
      if (tid < ng) {
        const int j = edge_col[g + tid];
        const int p = src_part[j];
        src[tid] = parts.base[p] + b * parts.row_bytes[p]
                   + (long long)src_col[j] * z;
        shift[tid] = edge_shift[g + tid];
      }
      __syncthreads();
      if ((z & 15) == 0) {
        const int zv = z >> 4;
        for (int idx = tid; idx < ng * zv; idx += kThreads) {
          const int q = idx / zv, v = idx - q * zv;
          const uint8_t* s = src[q] + 16 * v;
          uint4 x;
          if ((reinterpret_cast<uintptr_t>(src[q]) & 15) == 0) {
            x = __ldg(reinterpret_cast<const uint4*>(s));
          } else {
            uint32_t w[4];
#pragma unroll
            for (int t = 0; t < 4; ++t)
              w[t] = (uint32_t)__ldg(s + 4 * t)
                     | (uint32_t)__ldg(s + 4 * t + 1) << 8
                     | (uint32_t)__ldg(s + 4 * t + 2) << 16
                     | (uint32_t)__ldg(s + 4 * t + 3) << 24;
            x = make_uint4(w[0], w[1], w[2], w[3]);
          }
          uint4* dst = reinterpret_cast<uint4*>(cols + q * cb);
          dst[v] = x;
          dst[v + zv] = x;
        }
      } else {
        for (int idx = tid; idx < ng * z; idx += kThreads) {
          const int q = idx / z, c = idx - q * z;
          const uint8_t x = __ldg(src[q] + c);
          uint8_t* dst = cols + q * cb;
          dst[c] = x;
          dst[c + z] = x;
        }
      }
      __syncthreads();
      for (int w = tid; w < zw; w += kThreads) {
        uint32_t a = acc[w];
        for (int q = 0; q < ng; ++q)
          a ^= load4(cols + q * cb, shift[q] + 4 * w);
        acc[w] = a;
      }
    }
    __syncthreads();            // every word is final (the byte path reads
                                // other threads' words)
    uint8_t* o = out + (long long)b * mb * z + (long long)i * z;
    if ((z & 3) == 0 && (reinterpret_cast<uintptr_t>(o) & 3) == 0) {
      uint32_t* o4 = reinterpret_cast<uint32_t*>(o);
      for (int w = tid; w < zw; w += kThreads) o4[w] = acc[w];
    } else {
      const uint8_t* ab = reinterpret_cast<const uint8_t*>(acc);
      for (int c = tid; c < z; c += kThreads) o[c] = ab[c];
    }
    __syncthreads();            // acc is reset for the next block
  }
}

}  // namespace

// (b, mb*z) uint8 syndromes into `out` (contiguous).  part0..2: the
// codeword's parts, uint8 (b, width_p * z) contiguous, null where width_p
// is 0; table: int32 row_start[mb + 1], edge_col[E] and edge_shift[E] by
// row, src_part[nb], src_col[nb].  max_deg: the widest base row.  -1: b, mb,
// nb or z not positive, a column too wide for the shared memory.
extern "C" int qtpu_qc_encode(const uint8_t* part0, const uint8_t* part1,
                              const uint8_t* part2, int width0, int width1,
                              int width2, const int32_t* table, int b, int mb,
                              int nb, int z, int E, int max_deg, uint8_t* out,
                              void* stream) {
  if (b <= 0 || mb <= 0 || nb <= 0 || z <= 0 || E < 0 || max_deg < 0)
    return -1;
  const int acc_bytes = round16(4 * ((z + 3) / 4));
  const int cb = column_bytes(z);
  int group = (kSmemBudget - acc_bytes) / cb;
  if (group < 1) return -1;
  if (group > kMaxGroup) group = kMaxGroup;
  if (max_deg > 0 && group > max_deg) group = max_deg;
  const Parts parts = {{part0, part1, part2},
                       {(long long)width0 * z, (long long)width1 * z,
                        (long long)width2 * z}};
  const dim3 grid((unsigned)mb,
                  (unsigned)(b < kRowsPerGrid ? b : kRowsPerGrid));
  const size_t smem = (size_t)acc_bytes + (size_t)group * cb;
  qc_encode_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      parts, table, b, mb, nb, z, E, group, out);
  return (int)cudaGetLastError();
}

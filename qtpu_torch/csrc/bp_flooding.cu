// Flooding normalized min-sum BP decoding of a quasi-cyclic LDPC code to the
// coset of a target syndrome, for Hopper (sm_90a).
//
// Replaces qtpu/ldpc/pallas_bp.py::kernel (the TPU kernel behind
// make_pallas_decoder(alg="minsum")).  It computes what that kernel
// computes, value for value.  Round `it` = 0, 1, ..., max_iters:
//
//   phase A, every base row i and lane r in [0, z), every edge k of the row
//   (column j_k, circulant shift s_k; c2v kept in the check view):
//     t_k    = totals[j_k][(r + s_k) mod z]             (roll by -shift)
//     parity = syndrome[i][r] XOR (t_k < 0 for all k)    (exact check of the
//                                                         current totals)
//     v2c_k  = t_k - c2v_k
//     c2v_k' = alpha * coset * sign_all * sign_k * min_{l != k} |v2c_l|
//   the block has converged when every parity is 0: it stops with
//   iterations = it and bits = (totals < 0);
//   otherwise, unless it == max_iters (the extra check-only round),
//   phase B, every base column j and lane v:
//     totals[j][v] = llr[j][v] + c2v'_e[(v - s_e) mod z]  for e in the
//                    column's edges, added in column slot order (roll by
//                    +shift)
//
// So a block whose channel hard decision satisfies the syndrome reports 0
// iterations, and one that never converges reports max_iters with the hard
// decision after exactly max_iters updates (pallas_bp.py:332, 346).
//
// Design.  One CTA per code block; rounds loop inside the CTA.  Phase A
// only reads totals and writes each (edge, lane) c2v slot from the one
// thread that owns its (row, lane) pair, phase B only reads c2v and writes
// each (column, lane) total from one thread, so neither phase races, even
// for a row with parallel edges.  __syncthreads_and after phase A is both
// the block's verdict and the barrier before phase B; a __syncthreads
// separates phase B from the next round.
//
// What bounds it on an H100.  Per block at n = 4096 (z = 256, nb = 16,
// E <= 54) the state is ~55 KB of c2v plus 16 KB of totals; it lives in
// global memory (the wrapper allocates it; this kernel initialises it), so
// each round streams ~2 x 71 KB per block through L2.  At B = 1024 the
// ~73 MB of state exceeds the 50 MB L2, so the kernel is memory-bound;
// accesses are coalesced along z, a row's values stay in registers, and a
// CTA stops as soon as its own block converges.  Staging the state in
// shared memory (it fits the 227 KB at n = 4096) is later speed work.
//
// Exactness (held to the plain PyTorch decoder bit for bit): every multiply,
// add and subtract is an explicit __fmul_rn / __fadd_rn / __fsub_rn and the
// library is built with -fmad=false; sign(0) = +1 (negative only when
// x < 0); the leave-one-out min through (min1, min2, argmin) is value-exact.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_DC 32

extern "C" __global__ void __launch_bounds__(512)
bp_flooding_kernel(const float* __restrict__ llr,      // (B, nb*z)
                   const uint8_t* __restrict__ syn,    // (B, mb*z), 0/1
                   const int* __restrict__ tables,     // see flooding_tables
                   float* __restrict__ totals,         // (B, nb*z) scratch
                   float* __restrict__ c2v,            // (B, E*z) scratch
                   uint8_t* __restrict__ bits,         // (B, nb*z)
                   uint8_t* __restrict__ converged,    // (B,)
                   int32_t* __restrict__ iterations,   // (B,)
                   int mb, int nb, int z, int E, int max_iters, float alpha) {
  extern __shared__ int s_tab[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int ntab = mb + nb + 2 + 4 * E;
  for (int i = tid; i < ntab; i += nt) s_tab[i] = tables[i];
  const int* row_start = s_tab;              // [mb + 1]
  const int* rcol = row_start + mb + 1;      // [E] column of row slot
  const int* rshift = rcol + E;              // [E] its shift
  const int* col_start = rshift + E;         // [nb + 1]
  const int* cpos = col_start + nb + 1;      // [E] row slot of column slot
  const int* cshift = cpos + E;              // [E] its shift

  const size_t b = blockIdx.x;
  const int n = nb * z;
  const float* L = llr + b * n;
  const uint8_t* S = syn + b * (size_t)(mb * z);
  float* T = totals + b * n;
  float* C = c2v + b * (size_t)E * z;        // row-slot major, then lane
  uint8_t* X = bits + b * n;

  for (int v = tid; v < n; v += nt) T[v] = L[v];
  for (int v = tid; v < E * z; v += nt) C[v] = 0.0f;
  __syncthreads();

  int it = 0;
  int ok;
  for (;;) {
    // ---- phase A: syndrome check of the totals + check update ----------
    const bool update = it < max_iters;
    int lane_ok = 1;
    for (int q = tid; q < mb * z; q += nt) {
      const int i = q / z;
      const int r = q - i * z;
      const int s0 = row_start[i], d = row_start[i + 1] - s0;
      float m[MAX_DC];  // v2c messages of the row's slots
      const int cs = S[q];
      int par = cs, sgn_all = 0, amin = -1;
      float min1 = INFINITY, min2 = INFINITY;
#pragma unroll
      for (int k = 0; k < MAX_DC; ++k) {
        if (k < d) {
          int p = r + rshift[s0 + k];
          if (p >= z) p -= z;
          const float t = T[rcol[s0 + k] * z + p];
          par ^= (t < 0.0f);
          m[k] = __fsub_rn(t, C[(s0 + k) * z + r]);
          sgn_all ^= (m[k] < 0.0f);
          const float a = fabsf(m[k]);
          if (a < min1) {
            min2 = min1;
            min1 = a;
            amin = k;
          } else if (a < min2) {
            min2 = a;
          }
        }
      }
      lane_ok &= (par == 0);
      if (update) {
#pragma unroll
        for (int k = 0; k < MAX_DC; ++k) {
          if (k < d) {
            const int sk = (m[k] < 0.0f);
            const float mag = __fmul_rn(alpha, k == amin ? min2 : min1);
            C[(s0 + k) * z + r] = (cs ^ sgn_all ^ sk) ? -mag : mag;
          }
        }
      }
    }
    ok = __syncthreads_and(lane_ok);
    if (ok || !update) break;

    // ---- phase B: totals = llr + sum of rolled c2v, column slot order ----
    for (int v = tid; v < n; v += nt) {
      const int j = v / z;
      const int r = v - j * z;
      float acc = L[v];
      for (int k = col_start[j]; k < col_start[j + 1]; ++k) {
        int p = r - cshift[k];
        if (p < 0) p += z;
        acc = __fadd_rn(acc, C[cpos[k] * z + p]);
      }
      T[v] = acc;
    }
    __syncthreads();
    ++it;
  }

  for (int v = tid; v < n; v += nt) X[v] = (T[v] < 0.0f);
  if (tid == 0) {
    converged[b] = (uint8_t)ok;
    iterations[b] = it;
  }
}

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, and returns the launch's cudaError_t (0 on success), or -1
// when a base row is wider than MAX_DC or the launch shape is invalid.
extern "C" int qtpu_bp_flooding(const float* llr, const uint8_t* syn,
                                const int* tables, float* totals, float* c2v,
                                uint8_t* bits, uint8_t* converged,
                                int32_t* iterations, int B, int mb, int nb,
                                int z, int E, int max_dc, int max_iters,
                                float alpha, int threads, void* stream) {
  if (max_dc > MAX_DC || threads > 512 || threads <= 0 || B <= 0) return -1;
  const size_t smem = (size_t)(mb + nb + 2 + 4 * E) * sizeof(int);
  bp_flooding_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      llr, syn, tables, totals, c2v, bits, converged, iterations, mb, nb, z,
      E, max_iters, alpha);
  return (int)cudaGetLastError();
}

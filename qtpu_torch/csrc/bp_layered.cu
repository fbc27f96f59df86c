// Row-layered normalized min-sum BP decoding of a quasi-cyclic LDPC code to
// the coset of a target syndrome, for Hopper (sm_90a).
//
// Replaces qtpu/ldpc/pallas_bp.py::kernel_layered (the TPU kernel of the
// production decoder).  It computes what that kernel computes, value for
// value: per base row i, for every lane r in [0, z) and every edge k of the
// row (column j_k, circulant shift s_k):
//
//     t_k   = totals[j_k][(r + s_k) mod z]          (roll by -shift)
//     v2c_k = t_k - c2v_k
//     c2v_k' = alpha * coset * sign_all * sign_k * min_{l != k} |v2c_l|
//     totals[j_k][(r + s_k) mod z] = t_k + (c2v_k' - c2v_k)   (roll by +shift)
//
// and each row's parity (syndrome bit XOR sign bits of the t_k) feeds a
// fused per-sweep convergence flag, evaluated before the row's own update.
//
// Design.  One CTA per code block; the sweeps loop inside the CTA, base rows
// run in order with __syncthreads() between them, and each thread walks its
// lanes of the row one lane at a time.  A row has no parallel edges (the
// wrapper checks it), so within a row every (lane, edge) position of the
// totals is read and written by exactly one thread: no races, no atomics.
//
// What bounds it on an H100.  A production block (n = 65536, z = 2048,
// ~110 base edges) carries 256 KB of totals and ~0.9 MB of c2v messages,
// more than the 227 KB of shared memory a CTA may hold, so both live in
// global memory (the wrapper allocates them; this kernel zeroes them) and
// each sweep streams ~4 MB per block through L2/HBM.  At B = 128 the state
// (~155 MB) exceeds the 50 MB L2, so the kernel is memory-bound; the
// per-lane row values (<= MAX_DC) stay in registers, every access is
// coalesced along z, and a CTA stops as soon as its own block converges.
//
// Exactness (held to the plain PyTorch decoder bit for bit):
//  * FMA contraction: the reference rounds alpha*min and the subtraction
//    separately; every such operation here is an explicit __fmul_rn /
//    __fsub_rn / __fadd_rn, and the library is built with -fmad=false.
//  * Operand order: v2c = t - c2v, delta = new - c2v, totals = t + delta.
//  * sign(0) = +1: a value counts as negative only when x < 0 (so -0.0 is
//    non-negative); the sign of a zero message follows the same product.
//  * Leave-one-out min through (min1, min2, argmin) is value-exact: float
//    min is exact.
//  * Iterations: 0 if the channel LLRs already satisfy the syndrome;
//    otherwise the 1-based sweep whose fused flag first holds, or max_iters.
//    Bits are totals < 0 after that sweep (or after the last one).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define MAX_DC 32

extern "C" __global__ void __launch_bounds__(512, 1)
bp_layered_kernel(const float* __restrict__ llr,      // (B, nb*z)
                  const uint8_t* __restrict__ syn,    // (B, mb*z), 0/1
                  const int* __restrict__ tables,     // row_start[mb+1],
                                                      // col[E], shift[E]
                  float* __restrict__ totals,         // (B, nb*z) scratch
                  float* __restrict__ c2v,            // (B, E*z) scratch
                  uint8_t* __restrict__ bits,         // (B, nb*z)
                  uint8_t* __restrict__ converged,    // (B,)
                  int32_t* __restrict__ iterations,   // (B,)
                  int mb, int nb, int z, int E, int max_iters, float alpha) {
  extern __shared__ int s_tab[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int ntab = mb + 1 + 2 * E;
  for (int i = tid; i < ntab; i += nt) s_tab[i] = tables[i];
  const int* row_start = s_tab;
  const int* scol = s_tab + mb + 1;
  const int* sshift = scol + E;

  const size_t b = blockIdx.x;
  const int n = nb * z;
  const float* L = llr + b * n;
  const uint8_t* S = syn + b * (size_t)(mb * z);
  float* T = totals + b * n;
  float* C = c2v + b * (size_t)E * z;
  uint8_t* X = bits + b * n;

  for (int v = tid; v < n; v += nt) T[v] = L[v];
  for (int v = tid; v < E * z; v += nt) C[v] = 0.0f;
  __syncthreads();

  // Exact syndrome check of the channel hard decision.
  int ok = 1;
  for (int i = 0; i < mb; ++i) {
    const int s0 = row_start[i], d = row_start[i + 1] - s0;
    for (int r = tid; r < z; r += nt) {
      int par = S[i * z + r];
      for (int k = 0; k < d; ++k) {
        int p = r + sshift[s0 + k];
        if (p >= z) p -= z;
        par ^= (T[scol[s0 + k] * z + p] < 0.0f);
      }
      ok &= (par == 0);
    }
  }
  ok = __syncthreads_and(ok);

  int it = 0;
  while (!ok && it < max_iters) {
    int sweep_ok = 1;
    for (int i = 0; i < mb; ++i) {
      const int s0 = row_start[i], d = row_start[i + 1] - s0;
      for (int r = tid; r < z; r += nt) {
        float t[MAX_DC], c[MAX_DC];
        const int cs = S[i * z + r];
        int par = cs, sgn_all = 0, amin = -1;
        float min1 = INFINITY, min2 = INFINITY;
#pragma unroll
        for (int k = 0; k < MAX_DC; ++k) {
          if (k < d) {
            int p = r + sshift[s0 + k];
            if (p >= z) p -= z;
            t[k] = T[scol[s0 + k] * z + p];
            c[k] = C[(s0 + k) * z + r];
            par ^= (t[k] < 0.0f);
            const float m = __fsub_rn(t[k], c[k]);
            sgn_all ^= (m < 0.0f);
            const float a = fabsf(m);
            if (a < min1) {
              min2 = min1;
              min1 = a;
              amin = k;
            } else if (a < min2) {
              min2 = a;
            }
          }
        }
        sweep_ok &= (par == 0);
#pragma unroll
        for (int k = 0; k < MAX_DC; ++k) {
          if (k < d) {
            const int sk = (__fsub_rn(t[k], c[k]) < 0.0f);
            const float mag = __fmul_rn(alpha, k == amin ? min2 : min1);
            const float nw = (cs ^ sgn_all ^ sk) ? -mag : mag;
            const float delta = __fsub_rn(nw, c[k]);
            int p = r + sshift[s0 + k];
            if (p >= z) p -= z;
            C[(s0 + k) * z + r] = nw;
            T[scol[s0 + k] * z + p] = __fadd_rn(t[k], delta);
          }
        }
      }
      __syncthreads();
    }
    ++it;
    ok = __syncthreads_and(sweep_ok);
  }

  for (int v = tid; v < n; v += nt) X[v] = (T[v] < 0.0f);
  if (tid == 0) {
    converged[b] = (uint8_t)ok;
    iterations[b] = it;
  }
}

// Plain C entry point (bound with ctypes).  Launches on `stream`, does not
// synchronise, and returns the launch's cudaError_t (0 on success), or -1
// when a base row is wider than MAX_DC.
extern "C" int qtpu_bp_layered(const float* llr, const uint8_t* syn,
                               const int* tables, float* totals, float* c2v,
                               uint8_t* bits, uint8_t* converged,
                               int32_t* iterations, int B, int mb, int nb,
                               int z, int E, int max_dc, int max_iters,
                               float alpha, int threads, void* stream) {
  if (max_dc > MAX_DC || threads > 512 || B <= 0) return -1;
  const size_t smem = (size_t)(mb + 1 + 2 * E) * sizeof(int);
  bp_layered_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
      llr, syn, tables, totals, c2v, bits, converged, iterations, mb, nb, z,
      E, max_iters, alpha);
  return (int)cudaGetLastError();
}

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
// Design: the whole decoder state of a code block stays on chip.
//  * One thread-block cluster of C CTAs per code block (grid B*C, cluster
//    dims (C, 1, 1)).  CTA c owns lanes [c*z/C, (c+1)*z/C) of every base
//    row's check-node state and circulant positions [c*z/C, (c+1)*z/C) of
//    every column's totals, both in its shared memory.  A lane's gather
//    p = (r + s_k) mod z reaches the owner of p through distributed shared
//    memory (mapa + ld/st.shared::cluster); a warp's 32 consecutive lanes
//    touch at most two owners, each at consecutive addresses.  When the
//    whole state fits one CTA (C = 1: the n <= 4096 codes) the same code
//    runs on the CTA's own shared memory with CTA barriers.
//  * Compact check-node state: per (row, lane) min1, min2 (f32), the argmin
//    slot (u8) and one u32 of per-edge output sign bits, 13 bytes instead
//    of 4*d.  Each c2v is rebuilt on the fly as sign ? -m : m with
//    m = alpha * (k == argmin ? min2 : min1): the exact value, -0.0
//    included, that the per-edge form stores.  The initial state (zeros)
//    rebuilds to +0.0, the per-edge form's zeroed messages.
//  * A cluster barrier (barrier.cluster.arrive.release / wait.acquire)
//    separates base rows.  A row has no parallel edges (the wrapper checks
//    it), so each (column, position) of the totals has exactly one reader
//    and writer per row: no atomics on the state.
//  * Convergence: each warp ANDs its lanes' parities and clears a flag in
//    rank 0's shared memory (red.and over DSMEM) before the last barrier of
//    the check; every CTA then reads that flag, so the whole cluster leaves
//    the sweep loop together.  Three flag slots rotate so a slot is reset
//    only after every CTA has read it.  A final cluster barrier keeps each
//    CTA's shared memory alive until no peer can address it.
//  * Device memory is touched only to read llr, the syndrome and the code
//    table once and to write bits, converged and iterations once: no
//    global scratch.
//  * The DSMEM accesses, barriers, flag and launch helpers are in
//    cluster_state.cuh, shared with bp_flooding.cu.
//
// What bounds it on an H100.  At n = 65536 (z = 2048, nb = 32, mb 4-16) a
// block's state is 256 KB of totals plus 14 * mb * z bytes of check state
// and syndrome (~0.5 MB at mb = 9), so at most ~58 blocks fit the card's
// shared memory at once.  A sweep is mb rows; each row is a round trip of
// remote loads, the row's arithmetic, remote stores whose completion the
// barrier's release waits for, and the cluster barrier itself.  Latency,
// not HBM bytes nor arithmetic, bounds it: a row costs a few microseconds
// whatever its width, a block spread over more SMs sweeps faster, and at
// large B the number of resident clusters decides.  Hence two families:
// wide CTAs (<= 512 threads, one per SM) for C <= 4 and narrow ones
// (<= 256 threads, registers capped for 3 per SM) for C >= 8; the wrapper
// picks C per batch (ldpc/cuda_bp.py::layered_plan) and chip_smoke.py
// phase 3 times every C.  Registers and spills of each instantiation are
// what -Xptxas -v prints (chip_smoke.py phase 2).
//
// Exactness (held to the plain PyTorch decoder bit for bit):
//  * FMA contraction: the reference rounds alpha*min and the subtraction
//    separately; every such operation here is an explicit __fmul_rn /
//    __fsub_rn / __fadd_rn, and the library is built with -fmad=false.
//  * Operand order: v2c = t - c2v, delta = new - c2v, totals = t + delta.
//  * sign(0) = +1: a value counts as negative only when x < 0 (so -0.0 is
//    non-negative); the sign of a zero message follows the same product.
//  * Leave-one-out min through (min1, min2, argmin) with the strict `<` tie
//    rule is value-exact: float min is exact.
//  * Iterations: 0 if the channel LLRs already satisfy the syndrome;
//    otherwise the 1-based sweep whose fused flag first holds, or max_iters.
//    Bits are totals < 0 after that sweep (or after the last one).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_state.cuh"

#define MAX_DC 32
// Two families of instantiations.  Wide: up to 512 threads, one CTA per SM
// (C <= 4: a CTA's share of a production block's state takes most of the
// SM's shared memory).  Narrow: up to 256 threads with registers capped so
// that 3 CTAs share an SM (C >= 8: more clusters resident at large B).
#define WIDE_THREADS 512
#define NARROW_THREADS 256
#define NARROW_FROM_CLUSTER 8

// Shared-memory layout of one CTA (zc = z / C lanes): the code table, three
// flag words (+1 pad), totals (nb, zc), min1, min2, sign words (mb, zc),
// then argmin and syndrome bytes (mb, zc).
struct Layout {
  size_t flag, tot, min1, min2, sgn, amin, syn, total;
};

__host__ __device__ inline Layout layout(int mb, int nb, int zc, int E) {
  Layout L;
  const size_t ntab = (size_t)(mb + 1 + 2 * E);
  L.flag = ((ntab + 3) / 4) * 16;
  L.tot = L.flag + 16;
  L.min1 = L.tot + 4 * (size_t)nb * zc;
  L.min2 = L.min1 + 4 * (size_t)mb * zc;
  L.sgn = L.min2 + 4 * (size_t)mb * zc;
  L.amin = L.sgn + 4 * (size_t)mb * zc;
  L.syn = L.amin + (size_t)mb * zc;
  L.total = L.syn + (size_t)mb * zc;
  return L;
}

template <int DMAX, bool CL, int NT, int MINB>
__global__ void __launch_bounds__(NT, MINB)
bp_layered_kernel(const float* __restrict__ llr,      // (B, nb*z)
                  const uint8_t* __restrict__ syn,    // (B, mb*z), 0/1
                  const int* __restrict__ tables,     // row_start[mb+1],
                                                      // col[E], shift[E]
                  uint8_t* __restrict__ bits,         // (B, nb*z)
                  uint8_t* __restrict__ converged,    // (B,)
                  int32_t* __restrict__ iterations,   // (B,)
                  int mb, int nb, int z, int E, int max_iters, float alpha,
                  int zc_log2) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = (int)cluster_size();
  const uint32_t rank = cluster_rank();
  const int zc = z / C;
  const int c0 = (int)rank * zc;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const Layout L = layout(mb, nb, zc, E);
  int* s_tab = (int*)smem;
  uint32_t* s_flag = (uint32_t*)(smem + L.flag);
  float* s_tot = (float*)(smem + L.tot);
  float* s_min1 = (float*)(smem + L.min1);
  float* s_min2 = (float*)(smem + L.min2);
  uint32_t* s_sgn = (uint32_t*)(smem + L.sgn);
  uint8_t* s_amin = smem + L.amin;
  uint8_t* s_syn = smem + L.syn;
  const int* row_start = s_tab;
  const int* scol = s_tab + mb + 1;
  const int* sshift = scol + E;
  const uint32_t tot = smem_addr(s_tot);
  const uint32_t flag = smem_addr(s_flag);

  const size_t b = cluster_id();
  const int n = nb * z;
  const float* Lb = llr + b * n;
  const uint8_t* Sb = syn + b * (size_t)(mb * z);
  uint8_t* X = bits + b * n;

  const int ntab = mb + 1 + 2 * E;
  for (int i = tid; i < ntab; i += nt) s_tab[i] = tables[i];
  if (tid < 3) s_flag[tid] = 1u;
  for (int v = tid; v < nb * zc; v += nt) {
    const int j = v / zc, q = v - j * zc;
    s_tot[v] = Lb[j * z + c0 + q];
  }
  for (int v = tid; v < mb * zc; v += nt) {
    const int i = v / zc, q = v - i * zc;
    s_min1[v] = 0.0f;
    s_min2[v] = 0.0f;
    s_sgn[v] = 0u;
    s_amin[v] = 0;
    s_syn[v] = Sb[i * z + c0 + q];
  }
  // Every CTA of the cluster has started and loaded its share.
  state_barrier<CL>();

  // Exact syndrome check of the channel hard decision (flag slot 0).
  int ok_t = 1;
  for (int i = 0; i < mb; ++i) {
    const int s0 = row_start[i], d = row_start[i + 1] - s0;
    for (int q = tid; q < zc; q += nt) {
      const int r = c0 + q;
      int par = s_syn[i * zc + q];
      for (int k = 0; k < d; ++k) {
        const float t = ld_state<CL>(total_addr<CL>(
            tot, r, sshift[s0 + k], scol[s0 + k], z, zc, zc_log2));
        par ^= (t < 0.0f);
      }
      ok_t &= (par == 0);
    }
  }
  const uint32_t flag0 = at_rank<CL>(flag, 0);
  flag_and<CL>(flag0, ok_t);
  state_barrier<CL>();
  int ok = ld_flag<CL>(flag0) != 0u;

  int it = 0;
  while (!ok && it < max_iters) {
    // This sweep's flag slot; the next sweep's slot was last read before
    // the previous sweep's first barrier, so rank 0 may reset it now.
    const uint32_t slot = at_rank<CL>(flag + 4u * ((it + 1) % 3), 0);
    if (rank == 0 && tid == 0) s_flag[(it + 2) % 3] = 1u;
    ok_t = 1;
    for (int i = 0; i < mb; ++i) {
      const int s0 = row_start[i], d = row_start[i + 1] - s0;
      for (int q = tid; q < zc; q += nt) {
        const int r = c0 + q;
        const int idx = i * zc + q;
        const int cs = s_syn[idx];
        const uint32_t sg_old = s_sgn[idx];
        const int am_old = s_amin[idx];
        const float m1_old = __fmul_rn(alpha, s_min1[idx]);
        const float m2_old = __fmul_rn(alpha, s_min2[idx]);
        uint32_t addr[DMAX];
        float t[DMAX];
#pragma unroll
        for (int k = 0; k < DMAX; ++k) {
          if (k < d) {
            addr[k] = total_addr<CL>(tot, r, sshift[s0 + k], scol[s0 + k],
                                     z, zc, zc_log2);
            t[k] = ld_state<CL>(addr[k]);
          }
        }
        int par = cs, sgn_all = 0, amin = 255;
        uint32_t vneg = 0u;
        float min1 = INFINITY, min2 = INFINITY;
#pragma unroll
        for (int k = 0; k < DMAX; ++k) {
          if (k < d) {
            const float mo = (k == am_old) ? m2_old : m1_old;
            const float c = ((sg_old >> k) & 1u) ? -mo : mo;
            par ^= (t[k] < 0.0f);
            const float m = __fsub_rn(t[k], c);
            const int neg = (m < 0.0f);
            sgn_all ^= neg;
            vneg |= (uint32_t)neg << k;
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
        ok_t &= (par == 0);
        const uint32_t sg_new = ((cs ^ sgn_all) ? 0xffffffffu : 0u) ^ vneg;
        const float m1_new = __fmul_rn(alpha, min1);
        const float m2_new = __fmul_rn(alpha, min2);
#pragma unroll
        for (int k = 0; k < DMAX; ++k) {
          if (k < d) {
            const float mo = (k == am_old) ? m2_old : m1_old;
            const float c = ((sg_old >> k) & 1u) ? -mo : mo;
            const float mn = (k == amin) ? m2_new : m1_new;
            const float nw = ((sg_new >> k) & 1u) ? -mn : mn;
            st_state<CL>(addr[k], __fadd_rn(t[k], __fsub_rn(nw, c)));
          }
        }
        s_min1[idx] = min1;
        s_min2[idx] = min2;
        s_sgn[idx] = sg_new;
        s_amin[idx] = (uint8_t)amin;
      }
      if (i == mb - 1) flag_and<CL>(slot, ok_t);
      state_barrier<CL>();
    }
    ++it;
    ok = ld_flag<CL>(slot) != 0u;
  }

  for (int v = tid; v < nb * zc; v += nt) {
    const int j = v / zc, q = v - j * zc;
    X[j * z + c0 + q] = (s_tot[v] < 0.0f);
  }
  if (rank == 0 && tid == 0) {
    converged[b] = (uint8_t)ok;
    iterations[b] = it;
  }
  // No CTA leaves while a peer may still read its flag or totals.
  if constexpr (CL) state_barrier<CL>();
}

static int max_threads(int cluster) {
  return cluster >= NARROW_FROM_CLUSTER ? NARROW_THREADS : WIDE_THREADS;
}

// The instantiation for rows of at most `max_dc` edges at `cluster` CTAs
// per block: one CTA (local shared memory) or a cluster (DSMEM); wide or
// narrow.  The narrow one at 32 edges keeps 2 CTAs per SM: at 3 its
// registers would spill.
static KernelFn kernel_for(int max_dc, int cluster) {
  if (cluster == 1) {
    if (max_dc <= 8) return bp_layered_kernel<8, false, WIDE_THREADS, 1>;
    if (max_dc <= 16) return bp_layered_kernel<16, false, WIDE_THREADS, 1>;
    return bp_layered_kernel<MAX_DC, false, WIDE_THREADS, 1>;
  }
  if (cluster < NARROW_FROM_CLUSTER) {
    if (max_dc <= 8) return bp_layered_kernel<8, true, WIDE_THREADS, 1>;
    if (max_dc <= 16) return bp_layered_kernel<16, true, WIDE_THREADS, 1>;
    return bp_layered_kernel<MAX_DC, true, WIDE_THREADS, 1>;
  }
  if (max_dc <= 8) return bp_layered_kernel<8, true, NARROW_THREADS, 3>;
  if (max_dc <= 16) return bp_layered_kernel<16, true, NARROW_THREADS, 3>;
  return bp_layered_kernel<MAX_DC, true, NARROW_THREADS, 2>;
}

static bool valid_shape(int max_dc, int z, int cluster, int threads) {
  return max_dc <= MAX_DC && cluster >= 1 && cluster <= MAX_CLUSTER &&
         z % cluster == 0 && (cluster == 1 || log2_exact(z / cluster) >= 0) &&
         threads >= 32 && threads <= max_threads(cluster) &&
         threads % 32 == 0;
}

// Bytes of dynamic shared memory one CTA needs for a code of mb base rows,
// nb base columns, circulant size z and E base edges split over `cluster`
// CTAs, or -1 when z does not split.
extern "C" long long qtpu_bp_layered_smem(int mb, int nb, int z, int E,
                                          int cluster) {
  if (cluster < 1 || z % cluster) return -1;
  return (long long)layout(mb, nb, z / cluster, E).total;
}

// The most dynamic shared memory a CTA may opt in to on `device`.
extern "C" int qtpu_bp_layered_smem_optin(int device) {
  return smem_optin(device);
}

// cudaOccupancyMaxActiveClusters for the kernel of `max_dc` at this
// configuration on the current device: how many clusters can be resident at
// once (0: none can be scheduled), or minus the cudaError_t.
extern "C" int qtpu_bp_layered_max_clusters(int max_dc, int z, int cluster,
                                            int threads, int smem) {
  if (!valid_shape(max_dc, z, cluster, threads)) return -1;
  return max_active_clusters(kernel_for(max_dc, cluster), cluster, threads,
                             smem);
}

// Plain C entry point (bound with ctypes).  Launches B clusters of
// `cluster` CTAs on `stream`, does not synchronise, and returns the
// launch's cudaError_t (0 on success), or -1 for a shape the kernel does
// not take (a row wider than MAX_DC, a cluster that does not split z into
// power-of-two parts, a thread count that is not a multiple of 32 up to
// the family's limit (512 threads below 8 CTAs per cluster, else 256), or
// less shared memory than the layout needs).
extern "C" int qtpu_bp_layered(const float* llr, const uint8_t* syn,
                               const int* tables, uint8_t* bits,
                               uint8_t* converged, int32_t* iterations, int B,
                               int mb, int nb, int z, int E, int max_dc,
                               int max_iters, float alpha, int cluster,
                               int threads, int smem, void* stream) {
  if (B <= 0 || !valid_shape(max_dc, z, cluster, threads) ||
      (long long)smem < qtpu_bp_layered_smem(mb, nb, z, E, cluster))
    return -1;
  return launch_blocks(kernel_for(max_dc, cluster), llr, syn, tables, bits,
                       converged, iterations, B, mb, nb, z, E, max_iters,
                       alpha, cluster, threads, smem, stream);
}

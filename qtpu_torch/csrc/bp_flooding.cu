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
// Design: the whole decoder state of a code block stays on chip.
//  * One CTA per block when its state fits one CTA's shared memory (every
//    code up to n = 16384 at mb <= 8); otherwise a thread-block cluster of
//    C CTAs over distributed shared memory (grid B*C, cluster dims (C,1,1)):
//    CTA c owns lanes [c*z/C, (c+1)*z/C) of every base row's check state and
//    the same circulant positions of every column's totals.  The wrapper
//    picks C (ldpc/cuda_bp.py::flooding_plan).
//  * Compact check state: per (row, lane) one 16-byte record {alpha*min1,
//    alpha*min2, sign bits of the row's c2v, argmin | syndrome << 8}
//    instead of 4*d bytes of c2v.  c2v_k = sign_k ? -m : m with
//    m = (k == argmin ? alpha*min2 : alpha*min1): the exact value, -0.0
//    included, of the per-edge form; the zero record rebuilds to +0.0, the
//    per-edge form's initial messages.
//  * Phase A reads totals (remote ones over DSMEM) and its own record, and
//    writes only its own record.  Phase B rebuilds each c2v' from the record
//    of (row i, lane (v - s) mod z) at the edge's slot k within the row --
//    one 16-byte load per column edge -- and writes only its own totals.  So
//    no remote store and no atomic touches the state, even for a row with
//    parallel edges; two state barriers per round, one after each phase.
//  * The verdict reaches every CTA before phase B: one CTA takes it from
//    __syncthreads_and; a cluster from a DSMEM red.and into rank 0's flag
//    word (three rotating slots) read after the barrier, so the cluster
//    leaves the round loop together; a final cluster barrier keeps each
//    CTA's shared memory alive while a peer may address it.
//  * Device memory is touched only to read the code table, the syndrome
//    and the llr (once to start the totals, then once per round in phase B,
//    from L2) and to write bits, converged and iterations once: no global
//    scratch.
//  * The DSMEM accesses, barriers, flag and launch helpers are in
//    cluster_state.cuh, shared with bp_layered.cu.
//
// What bounds it on an H100 (chip_smoke.py phase 4).  At n = 4096
// (z = 256, nb = 16, mb = 8) a block's state is 16 KB of totals and 32 KB
// of records, ~49 KB with the table; registers (64 a thread) let two CTAs
// of 512 threads share an SM, or one of 1024 (the wrapper's choice by
// batch).  A round costs ~5 us of one SM per block, whether the block has
// the SM to itself or shares it: the SM's throughput, not latency, bounds
// it -- phase A's instructions per row edge (gather, rebuild of the old
// c2v, sign and min tracking) and phase B's 16-byte record load per column
// edge, in about equal parts.  Reading the llr from shared memory instead
// of L2 (fewer CTAs per SM) was no faster, so phase B reads it from device
// memory.  At n = 65536 a cluster of 8 takes ~25 us per round: the
// DSMEM loads of both phases and two cluster barriers.  Registers and
// spills of each instantiation are what -Xptxas -v prints (chip_smoke.py
// phase 2).
//
// Exactness (held to the plain PyTorch decoder bit for bit): every multiply,
// add and subtract is an explicit __fmul_rn / __fadd_rn / __fsub_rn and the
// library is built with -fmad=false; sign(0) = +1 (negative only when
// x < 0); the leave-one-out min through (min1, min2, argmin) with the strict
// `<` tie rule is value-exact; totals are summed in column slot order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "cluster_state.cuh"

#define MAX_DC 32
#define MAX_THREADS 1024

// Shared-memory layout of one CTA (zc = z / C lanes): the code table as
// int2 (byte offset of the column's totals, shift) per row slot and int2
// (byte offset of the row's records, shift << 5 | slot) per column slot,
// row_start and col_start, three flag words (+1 pad), the records (mb, zc)
// and the totals (nb, zc).
struct Layout {
  size_t rtab, ctab, rstart, cstart, flag, rec, tot, total;
};

__host__ __device__ inline Layout layout(int mb, int nb, int zc, int E) {
  Layout L;
  L.rtab = 0;
  L.ctab = 8 * (size_t)E;
  L.rstart = 16 * (size_t)E;
  L.cstart = L.rstart + 4 * (size_t)(mb + 1);
  L.flag = (L.cstart + 4 * (size_t)(nb + 1) + 15) / 16 * 16;
  L.rec = L.flag + 16;
  L.tot = L.rec + 16 * (size_t)mb * zc;
  L.total = L.tot + 4 * (size_t)nb * zc;
  return L;
}

template <int DMAX, bool CL>
__global__ void __launch_bounds__(MAX_THREADS, 1)
bp_flooding_kernel(const float* __restrict__ llr,      // (B, nb*z)
                   const uint8_t* __restrict__ syn,    // (B, mb*z), 0/1
                   const int* __restrict__ tables,     // see flooding_tables
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
  int2* s_rtab = (int2*)(smem + L.rtab);
  int2* s_ctab = (int2*)(smem + L.ctab);
  int* s_rstart = (int*)(smem + L.rstart);
  int* s_cstart = (int*)(smem + L.cstart);
  uint32_t* s_flag = (uint32_t*)(smem + L.flag);
  uint4* s_rec = (uint4*)(smem + L.rec);
  float* s_tot = (float*)(smem + L.tot);
  const uint32_t rec = smem_addr(s_rec);
  const uint32_t tot = smem_addr(s_tot);
  const uint32_t flag = smem_addr(s_flag);

  const size_t b = cluster_id();
  const int n = nb * z;
  const float* Lb = llr + b * n;
  const uint8_t* Sb = syn + b * (size_t)(mb * z);
  uint8_t* X = bits + b * n;

  const int* g_rstart = tables;
  const int* g_rcol = g_rstart + mb + 1;
  const int* g_rshift = g_rcol + E;
  const int* g_cstart = g_rshift + E;
  const int* g_crow = g_cstart + nb + 1;
  const int* g_cslot = g_crow + E;
  const int* g_cshift = g_cslot + E;
  for (int e = tid; e < E; e += nt) {
    s_rtab[e] = make_int2(4 * g_rcol[e] * zc, g_rshift[e]);
    s_ctab[e] = make_int2(16 * g_crow[e] * zc,
                          (g_cshift[e] << 5) | g_cslot[e]);
  }
  for (int i = tid; i <= mb; i += nt) s_rstart[i] = g_rstart[i];
  for (int j = tid; j <= nb; j += nt) s_cstart[j] = g_cstart[j];
  if (tid < 3) s_flag[tid] = 1u;
  for (int v = tid; v < nb * zc; v += nt) {
    const int j = v / zc, q = v - j * zc;
    s_tot[v] = Lb[j * z + c0 + q];
  }
  for (int v = tid; v < mb * zc; v += nt) {
    const int i = v / zc, q = v - i * zc;
    s_rec[v] = make_uint4(0u, 0u, 0u, (uint32_t)Sb[i * z + c0 + q] << 8);
  }
  // Every CTA of the cluster has started and loaded its share.
  state_barrier<CL>();

  // Both phases walk (row or column, lane) pairs q = tid, tid + nt, ...
  // over rows of zc lanes; a warp stays within one row when 32 | zc.
  const int i0 = tid / zc, q0 = tid - i0 * zc;
  const int di = nt / zc, dq = nt - di * zc;

  int it = 0;
  int ok;
  for (;;) {
    // ---- phase A: syndrome check of the totals + check update ----------
    const bool update = it < max_iters;
    // The next round's flag slot was last read two rounds ago, before
    // this CTA's previous barriers: rank 0 may reset it now.
    if constexpr (CL)
      if (rank == 0 && tid == 0) s_flag[(it + 1) % 3] = 1u;
    int lane_ok = 1;
    for (int i = i0, q = q0; i < mb;) {
      const int r = c0 + q;
      const int idx = i * zc + q;
      const uint4 old = s_rec[idx];
      const float m1_old = __uint_as_float(old.x);
      const float m2_old = __uint_as_float(old.y);
      const int am_old = (int)(old.w & 255u);
      const int cs = (int)(old.w >> 8);
      const int s0 = s_rstart[i], d = s_rstart[i + 1] - s0;
      int par = cs, amin = 255;
      uint32_t vneg = 0u;
      float min1 = INFINITY, min2 = INFINITY;
#pragma unroll
      for (int k = 0; k < DMAX; ++k) {
        if (k < d) {
          const int2 e = s_rtab[s0 + k];
          int p = r + e.y;
          if (p >= z) p -= z;
          const float t =
              ld_state<CL>(lane_addr<CL>(tot + e.x, 4u, p, zc, zc_log2));
          par ^= (t < 0.0f);
          const float mo = (k == am_old) ? m2_old : m1_old;
          const float c = ((old.z >> k) & 1u) ? -mo : mo;
          const float m = __fsub_rn(t, c);
          vneg |= (uint32_t)(m < 0.0f) << k;
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
      const int sgn_all = __popc(vneg) & 1;
      lane_ok &= (par == 0);
      if (update)
        s_rec[idx] = make_uint4(
            __float_as_uint(__fmul_rn(alpha, min1)),
            __float_as_uint(__fmul_rn(alpha, min2)),
            ((cs ^ sgn_all) ? 0xffffffffu : 0u) ^ vneg,
            (uint32_t)amin | ((uint32_t)cs << 8));
      q += dq;
      i += di;
      if (q >= zc) {
        q -= zc;
        ++i;
      }
    }
    if constexpr (CL) {
      const uint32_t slot = at_rank<CL>(flag + 4u * (uint32_t)(it % 3), 0);
      flag_and<CL>(slot, lane_ok);
      state_barrier<CL>();
      ok = ld_flag<CL>(slot) != 0u;
    } else {
      ok = __syncthreads_and(lane_ok);
    }
    if (ok || !update) break;

    // ---- phase B: totals = llr + sum of rolled c2v', column slot order ---
    for (int j = i0, q = q0; j < nb;) {
      const int v = c0 + q;
      float acc = Lb[j * z + v];
      const int e_end = s_cstart[j + 1];
      for (int e = s_cstart[j]; e < e_end; ++e) {
        const int2 ce = s_ctab[e];
        const int k = ce.y & 31;
        int p = v - (ce.y >> 5);
        if (p < 0) p += z;
        const uint4 rc =
            ld_state4<CL>(lane_addr<CL>(rec + ce.x, 16u, p, zc, zc_log2));
        const float mag = (k == (int)(rc.w & 255u)) ? __uint_as_float(rc.y)
                                                     : __uint_as_float(rc.x);
        acc = __fadd_rn(acc, ((rc.z >> k) & 1u) ? -mag : mag);
      }
      s_tot[j * zc + q] = acc;
      q += dq;
      j += di;
      if (q >= zc) {
        q -= zc;
        ++j;
      }
    }
    state_barrier<CL>();
    ++it;
  }

  for (int v = tid; v < nb * zc; v += nt) {
    const int j = v / zc, q = v - j * zc;
    X[j * z + c0 + q] = (s_tot[v] < 0.0f);
  }
  if (rank == 0 && tid == 0) {
    converged[b] = (uint8_t)ok;
    iterations[b] = it;
  }
  // No CTA leaves while a peer may still read its flag.
  if constexpr (CL) state_barrier<CL>();
}

// The instantiation for rows of at most `max_dc` edges: one CTA (local
// shared memory) or a cluster (DSMEM).
static KernelFn kernel_for(int max_dc, int cluster) {
  if (cluster == 1) {
    if (max_dc <= 8) return bp_flooding_kernel<8, false>;
    if (max_dc <= 16) return bp_flooding_kernel<16, false>;
    return bp_flooding_kernel<MAX_DC, false>;
  }
  if (max_dc <= 8) return bp_flooding_kernel<8, true>;
  if (max_dc <= 16) return bp_flooding_kernel<16, true>;
  return bp_flooding_kernel<MAX_DC, true>;
}

static bool valid_shape(int max_dc, int z, int cluster, int threads) {
  return max_dc <= MAX_DC && cluster >= 1 && cluster <= MAX_CLUSTER &&
         z % cluster == 0 && (cluster == 1 || log2_exact(z / cluster) >= 0) &&
         threads >= 32 && threads <= MAX_THREADS && threads % 32 == 0;
}

// Bytes of dynamic shared memory one CTA needs for a code of mb base rows,
// nb base columns, circulant size z and E base edges split over `cluster`
// CTAs, or -1 when z does not split.
extern "C" long long qtpu_bp_flooding_smem(int mb, int nb, int z, int E,
                                           int cluster) {
  if (cluster < 1 || z % cluster) return -1;
  return (long long)layout(mb, nb, z / cluster, E).total;
}

// The most dynamic shared memory a CTA may opt in to on `device`.
extern "C" int qtpu_bp_flooding_smem_optin(int device) {
  return smem_optin(device);
}

// cudaOccupancyMaxActiveClusters for the kernel of `max_dc` at this
// configuration on the current device: how many blocks (clusters) can be
// resident at once (0: none can be scheduled), or minus the cudaError_t.
extern "C" int qtpu_bp_flooding_max_clusters(int max_dc, int z, int cluster,
                                             int threads, int smem) {
  if (!valid_shape(max_dc, z, cluster, threads)) return -1;
  return max_active_clusters(kernel_for(max_dc, cluster), cluster, threads,
                             smem);
}

// Plain C entry point (bound with ctypes).  Launches B blocks of `cluster`
// CTAs on `stream`, does not synchronise, and returns the launch's
// cudaError_t (0 on success), or -1 for a shape the kernel does not take (a
// row wider than MAX_DC, a cluster that does not split z into power-of-two
// parts, a thread count that is not a multiple of 32 up to MAX_THREADS, or
// less shared memory than the layout needs).
extern "C" int qtpu_bp_flooding(const float* llr, const uint8_t* syn,
                                const int* tables, uint8_t* bits,
                                uint8_t* converged, int32_t* iterations,
                                int B, int mb, int nb, int z, int E,
                                int max_dc, int max_iters, float alpha,
                                int cluster, int threads, int smem,
                                void* stream) {
  if (B <= 0 || !valid_shape(max_dc, z, cluster, threads) ||
      (long long)smem < qtpu_bp_flooding_smem(mb, nb, z, E, cluster))
    return -1;
  return launch_blocks(kernel_for(max_dc, cluster), llr, syn, tables, bits,
                       converged, iterations, B, mb, nb, z, E, max_iters,
                       alpha, cluster, threads, smem, stream);
}

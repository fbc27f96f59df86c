// Decoder state in the shared memory of one CTA or of a thread-block
// cluster (distributed shared memory, DSMEM), for Hopper (sm_90a): the
// helpers both BP kernels (bp_layered.cu, bp_flooding.cu) share.
//
// A block's state is split by circulant position: CTA c of a cluster of C
// owns positions [c*zc, (c+1)*zc), zc = z / C, of every base row's check
// state and of every base column's totals.  A lane reaches the owner of
// position p through mapa + ld/st.shared::cluster; with C = 1 the same code
// runs on the CTA's own shared memory (ld/st.shared, CTA barriers).
//
// Convergence flag: each warp ANDs its lanes' verdicts and clears a flag
// word in rank 0's shared memory (red.and over DSMEM) before a state
// barrier; every CTA then reads that word, so the whole cluster takes the
// same branch.  Three flag slots rotate so a slot is reset only after every
// CTA has read it.  A final cluster barrier keeps each CTA's shared memory
// alive until no peer can address it.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The most CTAs per cluster: 8 is the portable limit, 16 needs the
// non-portable attribute (set_attributes sets it).
#define MAX_CLUSTER 16

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The shared::cluster address of local shared address `a` in CTA `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t a, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

// Shared-memory accesses of the decoder state.  CL: the state is spread
// over a cluster and addresses are shared::cluster ones (from mapa); else
// one CTA holds it all and addresses are the CTA's own.  All are volatile
// asm, so they keep their order relative to each other and the barriers.
template <bool CL>
__device__ __forceinline__ uint32_t at_rank(uint32_t a, uint32_t rank) {
  if constexpr (CL) return mapa(a, rank);
  return a;
}

template <bool CL>
__device__ __forceinline__ float ld_state(uint32_t a) {
  float v;
  if constexpr (CL)
    asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a));
  else
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(a));
  return v;
}

// 16 bytes at a 16-byte aligned address.
template <bool CL>
__device__ __forceinline__ uint4 ld_state4(uint32_t a) {
  uint4 v;
  if constexpr (CL)
    asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  else
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a));
  return v;
}

template <bool CL>
__device__ __forceinline__ uint32_t ld_flag(uint32_t a) {
  uint32_t v;
  if constexpr (CL)
    asm volatile("ld.shared::cluster.u32 %0, [%1];" : "=r"(v) : "r"(a));
  else
    asm volatile("ld.shared.u32 %0, [%1];" : "=r"(v) : "r"(a));
  return v;
}

template <bool CL>
__device__ __forceinline__ void st_state(uint32_t a, float v) {
  if constexpr (CL)
    asm volatile("st.shared::cluster.f32 [%0], %1;" :: "r"(a), "f"(v));
  else
    asm volatile("st.shared.f32 [%0], %1;" :: "r"(a), "f"(v));
}

// Every thread of the cluster (CL) or of the CTA: writes to the state
// before it are visible to every read after it.
template <bool CL>
__device__ __forceinline__ void state_barrier() {
  if constexpr (CL)
    asm volatile("barrier.cluster.arrive.release;\n\t"
                 "barrier.cluster.wait.acquire;" ::: "memory");
  else
    asm volatile("bar.sync 0;" ::: "memory");
}

// Clears rank 0's flag word `flag` (an address from at_rank<CL>(., 0))
// when any lane of the calling warp saw a failed parity.  All 32 lanes
// must call it.
template <bool CL>
__device__ __forceinline__ void flag_and(uint32_t flag, int ok) {
  if (!__all_sync(0xffffffffu, ok) && (threadIdx.x & 31) == 0) {
    if constexpr (CL)
      asm volatile("red.shared::cluster.and.b32 [%0], %1;"
                   :: "r"(flag), "r"(0u) : "memory");
    else
      asm volatile("red.shared.and.b32 [%0], %1;"
                   :: "r"(flag), "r"(0u) : "memory");
  }
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

// The address, in its owner's CTA, of lane p in [0, z) of an array of
// zc-lane rows of `bytes`-byte elements whose row starts at local address
// `row`: lane p belongs to CTA p / zc (zc = 2^zc_log2 in a cluster).
template <bool CL>
__device__ __forceinline__ uint32_t lane_addr(uint32_t row, uint32_t bytes,
                                              int p, int zc, int zc_log2) {
  uint32_t owner = 0;
  if constexpr (CL) {
    owner = (uint32_t)(p >> zc_log2);
    p &= zc - 1;
  }
  return at_rank<CL>(row + bytes * (uint32_t)p, owner);
}

// Where lane r's edge with shift s and column j reads its total: the
// address of totals[j][(r + s) mod z] in the owner's CTA.
template <bool CL>
__device__ __forceinline__ uint32_t total_addr(uint32_t tot, int r, int s,
                                               int j, int z, int zc,
                                               int zc_log2) {
  int p = r + s;
  if (p >= z) p -= z;
  uint32_t owner = 0;
  if constexpr (CL) {
    owner = (uint32_t)(p >> zc_log2);
    p &= zc - 1;
  }
  return at_rank<CL>(tot + 4u * (uint32_t)(j * zc + p), owner);
}

// ---- host side ------------------------------------------------------------

// Both kernels take the same arguments: llr, syndrome, code table, bits,
// converged, iterations, then mb, nb, z, E, max_iters, alpha, zc_log2.
typedef void (*KernelFn)(const float*, const uint8_t*, const int*, uint8_t*,
                         uint8_t*, int32_t*, int, int, int, int, int, float,
                         int);

static int log2_exact(int x) {
  int k = 0;
  while ((1 << k) < x) ++k;
  return (1 << k) == x ? k : -1;
}

// The kernel's attributes for a launch of `cluster` CTAs per block with
// `smem` bytes of dynamic shared memory each.
static cudaError_t set_attributes(KernelFn fn, int cluster, int smem) {
  cudaError_t e = cudaFuncSetAttribute(
      (const void*)fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && cluster > 8)
    e = cudaFuncSetAttribute(
        (const void*)fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

static void launch_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                          int B, int cluster, int threads, int smem,
                          void* stream) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)(B * cluster), 1, 1);
  cfg->blockDim = dim3((unsigned)threads, 1, 1);
  cfg->dynamicSmemBytes = (size_t)smem;
  cfg->stream = (cudaStream_t)stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The most dynamic shared memory a CTA may opt in to on `device`, or -1.
static int smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return -1;
  return v;
}

// cudaOccupancyMaxActiveClusters of `fn` at this configuration on the
// current device (0: none can be scheduled), or minus the cudaError_t.
static int max_active_clusters(KernelFn fn, int cluster, int threads,
                               int smem) {
  cudaError_t e = set_attributes(fn, cluster, smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, 1, cluster, threads, smem, nullptr);
  int n = 0;
  e = cudaOccupancyMaxActiveClusters(&n, (const void*)fn, &cfg);
  if (e != cudaSuccess) return -(int)e;
  return n;
}

// Launches B blocks of `cluster` CTAs each on `stream`; the launch's
// cudaError_t (0 on success).
static int launch_blocks(KernelFn fn, const float* llr, const uint8_t* syn,
                         const int* tables, uint8_t* bits,
                         uint8_t* converged, int32_t* iterations, int B,
                         int mb, int nb, int z, int E, int max_iters,
                         float alpha, int cluster, int threads, int smem,
                         void* stream) {
  cudaError_t e = set_attributes(fn, cluster, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  launch_config(&cfg, &attr, B, cluster, threads, smem, stream);
  const int zc_log2 = cluster == 1 ? -1 : log2_exact(z / cluster);
  e = cudaLaunchKernelEx(&cfg, fn, llr, syn, tables, bits, converged,
                         iterations, mb, nb, z, E, max_iters, alpha, zc_log2);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// One class's thread-block cluster (Hopper's distributed shared memory): the
// share of a class that one block of its cluster owns, the cluster barrier,
// remote shared-memory access, and the host side of a cluster launch.  Used
// by train_step.cu and merge_event.cu (one cluster of K blocks a class) and,
// with K = 1, by merge_multi.cu's one-block multi_merge_choose.
//
// A class's S slots are cut into K contiguous ranges of cs = ceil(S / K)
// slots (block r owns [r cs, (r + 1) cs) clipped to S, so the last ranges may
// be short or empty), and its D features likewise.  A block writes only the
// cache entries, SV features and reduction partials it owns; whatever one
// block writes and another reads later is separated by part_sync (the
// cluster barrier, arrive.release / wait.acquire), and the state in device
// memory is read through ld_state (ld.global.cg, past the SM's L1), never
// through the read-only path.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

struct Part {
  int rank, k;     // this block's rank in the class's cluster, and the cluster size
  int cs;          // slots per range: block r owns slots [r cs, (r + 1) cs)
  int lo, hi;      // this block's slots [lo, hi)
  int f_lo, f_hi;  // this block's features [f_lo, f_hi)
};

__device__ __forceinline__ Part make_part(int k, int s, int d) {
  Part pt;
  pt.k = k;
  pt.rank = k > 1 ? (int)cg::this_cluster().block_rank() : 0;
  pt.cs = (s + k - 1) / k;
  const int fs = (d + k - 1) / k;
  pt.lo = min(pt.rank * pt.cs, s);
  pt.hi = min(pt.lo + pt.cs, s);
  pt.f_lo = min(pt.rank * fs, d);
  pt.f_hi = min(pt.f_lo + fs, d);
  return pt;
}

// The cluster barrier (every thread of every block of the class); a block
// barrier when the cluster is one block.
__device__ __forceinline__ void part_sync(const Part& pt) {
  if (pt.k > 1) cg::this_cluster().sync();
  else __syncthreads();
}

// ``p``, an address in this block's shared memory, in block ``r``'s.
template <typename T>
__device__ __forceinline__ T* at_rank(const Part& pt, T* p, int r) {
  return pt.k > 1 ? cg::this_cluster().map_shared_rank(p, (unsigned)r) : p;
}

// Entry ``q`` (a slot) of a per-range array of ``cs`` entries a row, row
// ``row``, wherever the cluster keeps it.
template <typename T>
__device__ __forceinline__ T slot_entry(const Part& pt, T* base, int row, int q) {
  const int o = q / pt.cs;
  const size_t x = (size_t)row * pt.cs + (q - o * pt.cs);
  return o == pt.rank ? base[x] : at_rank(pt, base, o)[x];
}

// The class state in device memory (cache, bank), read past L1: another
// block of the cluster may have written it since this SM last read it.
__device__ __forceinline__ float ld_state(const float* p) { return __ldcg(p); }
__device__ __forceinline__ __nv_bfloat16 ld_state(const __nv_bfloat16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

// A launch configuration of C clusters of K blocks.  ``attr`` must outlive
// the launch call.
inline cudaLaunchConfig_t cluster_config(int c, int k, int threads, size_t smem, void* stream,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(c * k), 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel attributes a cluster launch needs: dynamic shared memory above
// 48 KB, and clusters above the portable size of 8.
template <typename F>
cudaError_t cluster_prepare(F* kernel, size_t smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
}

// How many clusters of K blocks of ``kernel`` the card keeps resident at
// once with this block size and shared memory; 0 where the card refuses a
// cluster of K (cudaErrorInvalidClusterSize); -error on any other failure,
// such as shared memory above the card's limit.
template <typename F>
int max_active_clusters(F* kernel, int c, int k, int threads, size_t smem) {
  cudaError_t e = cluster_prepare(kernel, smem);
  if (e == cudaSuccess) {
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(c, k, threads, smem, nullptr, &attr);
    int n = 0;
    e = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
    if (e == cudaSuccess) return n;
  }
  cudaGetLastError();   // the query's error is reported here, not by the next launch
  return e == cudaErrorInvalidClusterSize ? 0 : -(int)e;
}

}  // namespace

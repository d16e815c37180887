// Block-wide and cluster-wide argmin with first-occurrence ties
// (jnp.argmin's and torch.argmin's rule), shared by every kernel that picks a
// slot on the card: merge_lookup.cu (merge_pick, block_argmin),
// multi_merge_choice.cuh and merge_event_body.cuh (cluster_argmin).  The
// first-occurrence argmin is the least (value, slot) pair, which does not
// depend on the order in which partial results are combined, so a
// cluster's reduction gives the one-block result bit for bit.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "cluster.cuh"

namespace {

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

// Every thread passes its running best (v, i) and gets the block's result.
// red_v/red_i hold one entry per warp (32 each).
__device__ void block_argmin(float v, int i, float* red_v, int* red_i, float* out_v,
                             int* out_i) {
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) { red_v[warp] = v; red_i[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    const int n_warps = blockDim.x / 32;
    v = lane < n_warps ? red_v[lane] : INFINITY;
    i = lane < n_warps ? red_i[lane] : INT_MAX;
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (better(ov, oi, v, i)) { v = ov; i = oi; }
    }
    if (lane == 0) { red_v[0] = v; red_i[0] = i; }
  }
  __syncthreads();
  *out_v = red_v[0];
  *out_i = red_i[0];
  __syncthreads();   // red_v/red_i may be reused right away
}

// The least (v, i) over the 32 lanes, in every lane (xor butterfly).
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) { v = ov; i = oi; }
  }
}

// Shared memory of a block's reductions, double-buffered: a reduction writes
// the buffer the previous one did not, so a warp (a block) may start the
// next reduction while another is still reading this one's partials; it
// cannot start the one after before every warp (block) has passed the next
// one's barrier, after its reads.  The warp partials and the cluster
// partials keep separate parities (bits 0 and 1 of ``ph``), since only the
// cluster reductions pass a cluster barrier.
struct Reduce {
  float wv[2][32];   // one partial a warp
  int wi[2][32];
  float cv[2];       // the block's partial, read by the cluster
  int ci[2];
};

// Argmin over every thread of the block (cluster = false) or of the class's
// whole cluster: each thread passes its running best (v, i) and every
// thread of every block gets the result.  ``ph`` is the buffer parity,
// flipped on every call; every block of a cluster makes the same sequence of
// calls.  One block barrier, and one cluster barrier when the cluster has
// more than one block.  ``ph`` starts at 0 and belongs to the caller.
__device__ void cluster_argmin(const Part& pt, bool cluster, Reduce& rd, int& ph, float v, int i,
                               float* out_v, int* out_i) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  const int wb = ph & 1, cb = (ph >> 1) & 1;
  warp_argmin(v, i);
  if (lane == 0) {
    rd.wv[wb][warp] = v;
    rd.wi[wb][warp] = i;
  }
  __syncthreads();
  v = lane < n_warps ? rd.wv[wb][lane] : INFINITY;
  i = lane < n_warps ? rd.wi[wb][lane] : INT_MAX;
  warp_argmin(v, i);
  ph ^= 1;
  if (cluster && pt.k > 1) {
    if (threadIdx.x == 0) {
      rd.cv[cb] = v;
      rd.ci[cb] = i;
    }
    part_sync(pt);
    v = lane < pt.k ? *at_rank(pt, &rd.cv[cb], lane) : INFINITY;
    i = lane < pt.k ? *at_rank(pt, &rd.ci[cb], lane) : INT_MAX;
    warp_argmin(v, i);
    ph ^= 2;
  }
  *out_v = v;
  *out_i = i;
}

}  // namespace

// Block-wide argmin with first-occurrence ties (jnp.argmin's and torch.argmin's
// rule), shared by every kernel that picks a slot on the card: merge_lookup.cu
// (merge_pick), multi_merge_choice.cuh and merge_event_body.cuh.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

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

}  // namespace

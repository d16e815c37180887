// The matmul-form RBF kernel value from its three fp32 sums, shared by
// rbf_kernel.cu and train_step.cu so that both compute the same expression:
//   k = exp(-gamma * max(|x|^2 + |y|^2 - 2 x.y, 0)),
// where the clamp keeps a NaN distance NaN (as torch.clamp and jnp.maximum
// do; fmaxf would return 0 and so k = 1 for a row holding a NaN or an Inf).
// Each operation rounds on its own (__fadd_rn and friends are never contracted
// into a multiply-add, whatever the file's -fmad setting), as the plain
// PyTorch version's separate ops do.  The sums themselves are accumulated by
// the callers with explicit fmaf, lanes striding over the features and a
// butterfly (warp_sum) at the end, so the two kernels' margin rows agree bit
// for bit.
#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float rbf_from_sums(float xn, float yn, float xy, float gamma) {
  const float d = __fsub_rn(__fadd_rn(xn, yn), __fmul_rn(2.0f, xy));
  const float d2 = d < 0.0f ? 0.0f : d;
  return expf(__fmul_rn(-gamma, d2));
}

// Sum over the 32 lanes of a warp by xor butterfly; every lane gets the sum.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

}  // namespace

// The serve cell's contraction and label: per request row i and class c,
//   scores[c, i] = sum_j K[i, c * s + j] * alpha[c, j]
// and the row's label, the argmax over classes (the first maximum wins, a NaN
// counts as the maximum: jnp.argmax's rule) or, for a binary model (C = 1),
// the sign of its one score (0 for a zero score, NaN for NaN: jnp.sign's).
//
// Replaces the per-class contraction that the reference runs outside Pallas
// after its kernel block (src/repro/kernels/ops.py::class_scores, an einsum,
// and the argmax or sign of core/predict.py::predict_labels).  On the card a
// cuBLAS batched product may pick its algorithm, and with it the order of
// summation, by the row count; so a row's scores would depend on the bucket
// it was served in.  Here each (row, class) sum has one fixed order, whatever
// n: one warp a class, lane l summing slots l, l + 32, l + 64, ... (a product
// rounded, then a sum rounded: no fused multiply-add), then the xor butterfly
// of warp_sum.  kernels/ref.py class_scores_labels computes the same
// operations in the same order, so the two agree bit for bit.
//
// One block a row, one warp a class (C > 32 loops the warps over classes).
// What bounds it on the H100 is reading K: at 256 rows x 10 classes x 508
// slots it is 5.2 MB (1.6 us at 3.35 TB/s) against 2.6 MFLOP; each warp
// reads its class's slots contiguously, lane-strided.
#include <cuda_runtime.h>

#include "rbf_epilogue.cuh"

namespace {

constexpr int MAX_WARPS = 32;

template <bool BINARY>
__global__ void class_scores_kernel(const float* __restrict__ k, const float* __restrict__ alpha,
                                    float* __restrict__ scores, void* __restrict__ labels, int n,
                                    int c, int s) {
  extern __shared__ float row_scores[];   // (c,) this row's scores
  const int i = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int padded = (s + 31) / 32 * 32;
  const float* kr = k + (size_t)i * c * s;
  for (int q = warp; q < c; q += warps) {
    const float* kq = kr + (size_t)q * s;
    const float* aq = alpha + (size_t)q * s;
    float acc = 0.0f;
    for (int j = lane; j < padded; j += 32)
      acc = __fadd_rn(acc, j < s ? __fmul_rn(kq[j], aq[j]) : 0.0f);
    acc = warp_sum(acc);
    if (lane == 0) {
      scores[(size_t)q * n + i] = acc;
      row_scores[q] = acc;
    }
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  if (BINARY) {
    const float v = row_scores[0];
    static_cast<float*>(labels)[i] = v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : v);
    return;
  }
  float best = row_scores[0];
  int arg = 0;
  for (int q = 1; q < c; ++q) {
    const float v = row_scores[q];
    if (v > best || (v != v && best == best)) {
      best = v;
      arg = q;
    }
  }
  static_cast<int*>(labels)[i] = arg;
}

}  // namespace

// k: (n, c * s) fp32; alpha: (c, s) fp32; scores: (c, n) fp32; labels: (n,)
// int32 class ids, or fp32 signs when binary (c must then be 1).  All
// row-major and contiguous.  Returns the launch's error.
extern "C" int class_scores_launch(const void* k, const void* alpha, void* scores, void* labels,
                                   int n, int c, int s, int binary, void* stream) {
  if (n <= 0) return 0;
  if (c <= 0 || s <= 0 || (binary && c != 1)) return (int)cudaErrorInvalidValue;
  const int warps = c < MAX_WARPS ? c : MAX_WARPS;
  const size_t smem = (size_t)c * sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* kp = static_cast<const float*>(k);
  const float* ap = static_cast<const float*>(alpha);
  float* sp = static_cast<float*>(scores);
  if (binary) {
    class_scores_kernel<true><<<n, 32 * warps, smem, st>>>(kp, ap, sp, labels, n, c, s);
  } else {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          class_scores_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    class_scores_kernel<false><<<n, 32 * warps, smem, st>>>(kp, ap, sp, labels, n, c, s);
  }
  return (int)cudaGetLastError();
}

// Batched golden section search for the merge objective (the paper's GSS baseline).
//
// Replaces the TPU kernel src/repro/kernels/gss.py::gss_pallas (body
// _gss_kernel): for each problem (m, kappa), maximize
//   s(h) = m * kappa^((1-h)^2) + (1-m) * kappa^(h^2)
// over [0, 1] with a fixed number of bracket steps (10 at eps 1e-2, 48 at
// eps 1e-10) and return the midpoint of the final bracket.
//
// What bounds it on the H100: each problem is a chain of n_iters dependent
// steps, two expf each, on 12 bytes of input; at the training path's 501
// problems that is a few microseconds of latency in one launch, far from
// both the memory and the arithmetic roofline.  One thread runs one problem
// with its bracket in registers; there is no cross-thread work and no
// shared memory.  The tail is masked (the TPU wrapper padded kappa with 1.0
// instead).
//
// The strict s(c) > s(d) comparison decides each bracket step, so the
// arithmetic must round as the plain version's does: the file is compiled
// without fast math and with -fmad=false, and uses expf/logf, not __expf.
#include <cuda_runtime.h>

namespace {

constexpr float INVPHI = 0.6180339887498949f;  // (sqrt(5) - 1) / 2
constexpr float KAPPA_MIN = 1e-30f;
constexpr int THREADS = 256;

__device__ __forceinline__ float objective(float h, float m, float lk) {
  const float u = 1.0f - h;
  return m * expf(u * u * lk) + (1.0f - m) * expf(h * h * lk);
}

__global__ void gss_kernel(const float* __restrict__ m_in, const float* __restrict__ kappa_in,
                           float* __restrict__ h_out, int n, int n_iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float m = m_in[i];
  const float lk = logf(fminf(fmaxf(kappa_in[i], KAPPA_MIN), 1.0f));
  float a = 0.0f, b = 1.0f;
  for (int it = 0; it < n_iters; ++it) {
    const float span = b - a;
    const float c = b - span * INVPHI;
    const float d = a + span * INVPHI;
    const bool go_left = objective(c, m, lk) > objective(d, m, lk);
    a = go_left ? a : c;
    b = go_left ? d : b;
  }
  h_out[i] = 0.5f * (a + b);
}

}  // namespace

// m, kappa, h: (n,) fp32 contiguous.  Returns cudaGetLastError().
extern "C" int gss_launch(const void* m, const void* kappa, void* h, int n, int n_iters,
                          void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  gss_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<const float*>(kappa), static_cast<float*>(h), n,
      n_iters);
  return (int)cudaGetLastError();
}

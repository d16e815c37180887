// Merge-candidate scoring against a precomputed G x G table (Lookup-WD / Lookup-h).
//
// Replaces the TPU kernel src/repro/kernels/merge_lookup.py::merge_scores_pallas
// (body _merge_score_kernel).  For one fixed partner with coefficient a_min
// (one per row of candidates: a row is a class on the class axis) and every
// candidate j:
//   m_j   = clip(a_min / (a_min + alpha_j), 0, 1)   (denominator 0 -> 1)
//   kap_j = clip(kappa_j, 0, 1)
//   interp_j = bilinear interpolation of table at (m_j, kap_j)
//   wd_j  = (a_min + alpha_j)^2 * interp_j, or 3.4e38 where valid_j == 0
// Given the WD_norm table, wd is the Lookup-WD score; given the h table,
// interp is the Lookup-h merge coefficient.
//
// What bounds it on the H100: s = 501 candidates read ~5 KB and gather four
// table cells each; the 400 x 400 fp32 table (640 KB) does not fit in one
// SM's 227 KB of shared memory, and a candidate touches only 4 of its 160,000
// cells, so the kernel does not stage it at all: one thread per candidate
// gathers its four corners through the read-only path (__ldg), and the L2
// keeps the table resident across the many launches of a training run.  At
// this size the launch latency is the bound, not bytes or operations.  The
// TPU kernel's hat-basis matmul (a workaround for weak vector gathers) is not
// carried over.
//
// The arithmetic follows repro.core.lookup.bilinear_lookup term by term
// (i0/j0 clipped to G-2, top/bot rows, then the mix); the file is compiled
// with -fmad=false so no multiply-add is contracted and the card rounds as
// the plain PyTorch version does.
#include <cuda_runtime.h>

namespace {

constexpr float WD_INVALID = 3.4e38f;
constexpr int THREADS = 256;

__global__ void merge_scores_kernel(const float* __restrict__ alpha,
                                    const float* __restrict__ kappa,
                                    const unsigned char* __restrict__ valid,
                                    const float* __restrict__ a_min_ptr,
                                    const float* __restrict__ table, int g0, int g1, int n,
                                    int row_len, float* __restrict__ wd_out,
                                    float* __restrict__ interp_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  const float a_min = __ldg(a_min_ptr + j / row_len);
  const float denom = a_min + alpha[j];
  const float m = fminf(fmaxf(a_min / (denom == 0.0f ? 1.0f : denom), 0.0f), 1.0f);
  const float kap = fminf(fmaxf(kappa[j], 0.0f), 1.0f);

  const float u = m * (float)(g0 - 1);
  const float v = kap * (float)(g1 - 1);
  const int i0 = min(max((int)floorf(u), 0), g0 - 2);
  const int j0 = min(max((int)floorf(v), 0), g1 - 2);
  const float du = u - (float)i0;
  const float dv = v - (float)j0;
  const float* r0 = table + (size_t)i0 * g1 + j0;
  const float* r1 = r0 + g1;
  const float t00 = __ldg(r0), t01 = __ldg(r0 + 1);
  const float t10 = __ldg(r1), t11 = __ldg(r1 + 1);
  const float top = t00 * (1.0f - dv) + t01 * dv;
  const float bot = t10 * (1.0f - dv) + t11 * dv;
  const float interp = top * (1.0f - du) + bot * du;

  wd_out[j] = valid[j] ? denom * denom * interp : WD_INVALID;
  interp_out[j] = interp;
}

}  // namespace

// alpha, kappa: (rows, row_len) fp32, n = rows * row_len; valid: the same in
// bytes (0/1); a_min: (rows,) fp32 on the device (read there, so the caller
// never syncs); table: (g0, g1) fp32.  Returns cudaGetLastError().
extern "C" int merge_scores_launch(const void* alpha, const void* kappa, const void* valid,
                                   const void* a_min, const void* table, int g0, int g1, int n,
                                   int row_len, void* wd_out, void* interp_out, void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  merge_scores_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alpha), static_cast<const float*>(kappa),
      static_cast<const unsigned char*>(valid), static_cast<const float*>(a_min),
      static_cast<const float*>(table), g0, g1, n, row_len, static_cast<float*>(wd_out),
      static_cast<float*>(interp_out));
  return (int)cudaGetLastError();
}

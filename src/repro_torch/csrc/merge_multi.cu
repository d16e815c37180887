// Multi-merge candidate scoring: both Lookup tables for R fixed-partner rows at once.
//
// Replaces the TPU kernel src/repro/kernels/merge_multi.py::multi_merge_scores_pallas
// (body _multi_merge_kernel).  Row r is one fixed partner with coefficient
// a_min[r] and its own candidate-alpha row; for every candidate j:
//   m   = clip(a_min / (a_min + alpha_j), 0, 1)   (denominator 0 -> 1)
//   kap = clip(kappa_rj, 0, 1)
//   wd  = (a_min + alpha_j)^2 * bilinear(WD_norm table, m, kap), 3.4e38 where invalid
//   h   = bilinear(h table, m, kap)
// Rows share alpha in groups of rows_per_alpha: the binary multi-merge has P
// rows on one alpha, the class axis folds (C, P) pairs onto C * P rows with
// class c's alpha under rows c*P .. c*P + P - 1, so one launch scores every
// class's candidates.
//
// What bounds it on the H100: at the multi-merge path's 40 rows x 508
// candidates the inputs are ~250 KB and every candidate gathers 8 cells of
// two 640 KB tables, which the L2 keeps across launches; one launch of
// ~20,000 threads is latency, not bytes or operations.  As in merge_lookup,
// one thread per (row, candidate) gathers its four corners per table through
// the read-only path (__ldg); the corner coordinates are computed once and
// serve both tables.  The TPU kernel's hat-basis matmul and its padding of
// the row axis to 8 are TPU idioms and are not carried over.
//
// The arithmetic follows repro.core.lookup.bilinear_lookup term by term
// (lookup.cuh, shared with the fused train step), and the file is compiled
// with -fmad=false, so wd and h equal the plain PyTorch version's bit for bit.
#include <cuda_runtime.h>

#include "lookup.cuh"

namespace {

constexpr float WD_INVALID = 3.4e38f;
constexpr int THREADS = 256;

__global__ void multi_merge_scores_kernel(const float* __restrict__ alpha, int rows_per_alpha,
                                          const float* __restrict__ kappa,
                                          const unsigned char* __restrict__ valid,
                                          const float* __restrict__ a_min,
                                          const float* __restrict__ h_table,
                                          const float* __restrict__ wd_table, int g0, int g1,
                                          int rows, int s, float* __restrict__ wd_out,
                                          float* __restrict__ h_out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)rows * s) return;
  const int r = (int)(i / s);
  const int j = (int)(i - (long long)r * s);
  const float a = __ldg(a_min + r);
  const float al = __ldg(alpha + (size_t)(r / rows_per_alpha) * s + j);
  const float denom = a + al;
  const float m = fminf(fmaxf(a / (denom == 0.0f ? 1.0f : denom), 0.0f), 1.0f);
  const float kap = fminf(fmaxf(__ldg(kappa + i), 0.0f), 1.0f);

  int off;
  float du, dv;
  lookup_coords(m, kap, g0, g1, &off, &du, &dv);
  const float interp_wd = corner_mix(wd_table, off, g1, du, dv);
  const float interp_h = corner_mix(h_table, off, g1, du, dv);

  wd_out[i] = valid[i] ? denom * denom * interp_wd : WD_INVALID;
  h_out[i] = interp_h;
}

}  // namespace

// alpha: (rows / rows_per_alpha, s) fp32; kappa: (rows, s) fp32; valid:
// (rows, s) bytes (0/1); a_min: (rows,) fp32; h_table, wd_table: (g0, g1)
// fp32; wd_out, h_out: (rows, s) fp32.  Returns cudaGetLastError().
extern "C" int multi_merge_scores_launch(const void* alpha, int rows_per_alpha,
                                         const void* kappa, const void* valid, const void* a_min,
                                         const void* h_table, const void* wd_table, int g0,
                                         int g1, int rows, int s, void* wd_out, void* h_out,
                                         void* stream) {
  const long long n = (long long)rows * s;
  const int blocks = (int)((n + THREADS - 1) / THREADS);
  multi_merge_scores_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alpha), rows_per_alpha, static_cast<const float*>(kappa),
      static_cast<const unsigned char*>(valid), static_cast<const float*>(a_min),
      static_cast<const float*>(h_table), static_cast<const float*>(wd_table), g0, g1, rows, s,
      static_cast<float*>(wd_out), static_cast<float*>(h_out));
  return (int)cudaGetLastError();
}

// Merge-candidate scoring against a precomputed G x G table (Lookup-WD / Lookup-h).
//
// Replaces the TPU kernel src/repro/kernels/merge_lookup.py::merge_scores_pallas
// (body _merge_score_kernel).  For one fixed partner with coefficient a_min
// (one per row of candidates: a row is a class on the class axis) and every
// candidate j:
//   m_j   = clip(a_min / (a_min + alpha_j), 0, 1)   (denominator 0 -> 1)
//   kap_j = clip(kappa_j, 0, 1)
//   interp_j = bilinear interpolation of table at (m_j, kap_j)
//   wd_j  = (a_min + alpha_j)^2 * interp_j, or 3.4e38 where the candidate is invalid
// Two entries:
//   * merge_scores_kernel writes (wd, interp) for every candidate, given a
//     validity mask: the Lookup-WD scores with the WD_norm table, the
//     Lookup-h coefficients with the h table;
//   * merge_pick_kernel runs the whole choice of one Lookup-WD event per row
//     (core.budget._merge_once step 3): it builds the mask itself (active,
//     same sign as the fixed partner, not its slot), scores every candidate,
//     takes the first-occurrence argmin in the block and reads the h table at
//     the winner alone, so the event's choice is one launch instead of the
//     mask, the scoring, the argmin, three gathers and a second scoring
//     launch for h.
//
// What bounds it on the H100: s = 501 candidates read ~5 KB and gather four
// table cells each; the 400 x 400 fp32 table (640 KB) does not fit in one
// SM's 227 KB of shared memory, and a candidate touches only 4 of its 160,000
// cells, so the kernels do not stage it: a thread gathers its four corners
// through the read-only path (__ldg), and the L2 keeps the table resident
// across the many launches of a training run.  At this size neither bytes
// nor operations bound it (a few nanoseconds): the launch does, and on a
// training step the host's work around it, so merge_pick moves the
// reduction on chip to save launches.  The TPU kernel's hat-basis matmul (a
// workaround for weak vector gathers) is not carried over.
//
// The arithmetic follows repro.core.lookup.bilinear_lookup term by term
// (lookup.cuh); the file is compiled with -fmad=false so no multiply-add is
// contracted and the card rounds as the plain PyTorch version does.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "block_argmin.cuh"
#include "lookup.cuh"

namespace {

constexpr int THREADS = 256;

// The table at candidate (a_min, alpha_j, kappa_j) and the score's (a_min + alpha_j).
__device__ __forceinline__ float interp_at(const float* __restrict__ table, int g0, int g1,
                                           float a_min, float alpha, float kappa) {
  int off;
  float du, dv;
  lookup_coords(merge_m(a_min, alpha), clip01(kappa), g0, g1, &off, &du, &dv);
  return corner_mix(table, off, g1, du, dv);
}

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
  const float interp = interp_at(table, g0, g1, a_min, alpha[j], kappa[j]);
  wd_out[j] = valid[j] ? denom * denom * interp : WD_INVALID;
  interp_out[j] = interp;
}

// One block per row r: candidate q is valid when q < count[r], alpha[q] has
// the sign of a_min[r] (alpha * a_min > 0) and q != i_min[r].  Writes the
// first-occurrence argmin j (slot 0 when no candidate is valid, as
// torch.argmin does over +inf), its score (>= NO_PARTNER when none is valid)
// and the h table at (a_min, alpha[j], kappa[j]).
__global__ void __launch_bounds__(THREADS) merge_pick_kernel(
    const float* __restrict__ alpha, const float* __restrict__ kappa,
    const int* __restrict__ count, const long long* __restrict__ i_min,
    const float* __restrict__ a_min_ptr, const float* __restrict__ wd_table,
    const float* __restrict__ h_table, int g0, int g1, int s, long long* __restrict__ j_out,
    float* __restrict__ wd_out, float* __restrict__ h_out) {
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  const int r = blockIdx.x;
  const float* al = alpha + (size_t)r * s;
  const float* kap = kappa + (size_t)r * s;
  const float a_min = a_min_ptr[r];
  const int cnt = count[r];
  const long long im = i_min[r];
  float bv = INFINITY;
  int bi = INT_MAX;
  for (int q = threadIdx.x; q < s; q += blockDim.x) {
    const float aq = al[q];
    const float denom = a_min + aq;
    const bool valid = q < cnt && aq * a_min > 0.0f && q != im;
    const float w = valid ? denom * denom * interp_at(wd_table, g0, g1, a_min, aq, kap[q])
                          : WD_INVALID;
    if (better(w, q, bv, bi)) { bv = w; bi = q; }
  }
  float wd_min;
  int j;
  block_argmin(bv, bi, red_v, red_i, &wd_min, &j);
  if (threadIdx.x == 0) {
    j_out[r] = j;
    wd_out[r] = wd_min;
    h_out[r] = interp_at(h_table, g0, g1, a_min, al[j], kap[j]);
  }
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

// alpha, kappa: (rows, s) fp32; count: (rows,) int32; i_min: (rows,) int64;
// a_min: (rows,) fp32; wd_table, h_table: (g0, g1) fp32.  Writes j_out
// (rows,) int64 and wd_out, h_out (rows,) fp32.  Returns cudaGetLastError().
extern "C" int merge_pick_launch(const void* alpha, const void* kappa, const void* count,
                                 const void* i_min, const void* a_min, const void* wd_table,
                                 const void* h_table, int g0, int g1, int rows, int s,
                                 void* j_out, void* wd_out, void* h_out, void* stream) {
  merge_pick_kernel<<<rows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alpha), static_cast<const float*>(kappa),
      static_cast<const int*>(count), static_cast<const long long*>(i_min),
      static_cast<const float*>(a_min), static_cast<const float*>(wd_table),
      static_cast<const float*>(h_table), g0, g1, s, static_cast<long long*>(j_out),
      static_cast<float*>(wd_out), static_cast<float*>(h_out));
  return (int)cudaGetLastError();
}

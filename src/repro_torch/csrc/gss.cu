// Batched golden section search for the merge objective (the paper's GSS
// baseline), and the whole choice of a GSS merge event.
//
// Replaces the TPU kernel src/repro/kernels/gss.py::gss_pallas (body
// _gss_kernel): for each problem (m, kappa), maximize
//   s(h) = m * kappa^((1-h)^2) + (1-m) * kappa^(h^2)
// over [0, 1] with a fixed number of bracket steps (10 at eps 1e-2, 48 at
// eps 1e-10) and return the midpoint of the final bracket.  Two entries:
//   * gss_kernel solves one problem a thread (the multi-merge scoring's
//     search, one problem a (pair, candidate));
//   * gss_pick_kernel runs the whole choice of one GSS merge event per row
//     (core.budget._merge_once step 3 under gss and gss-precise, plain
//     version kernels.ref.gss_pick): it builds the mask (active, same sign as
//     the fixed partner, not its slot), computes each valid candidate's
//     (m, kappa), its h* by the same search, its merged coefficient alpha_z
//     and its weight degradation (core.merge_math.merge_alpha_z and
//     weight_degradation, op for op, kappa^e as expf(e * logf(kappa))), takes
//     the first-occurrence block argmin and returns h* at the winner: the
//     event's choice in one launch instead of the mask, the coordinates, the
//     search, the clamp, four exp/log pairs, where, argmin and the gathers
//     (~30 launches on the host-bound binary step).
//
// What bounds it on the H100: each problem is a chain of n_iters dependent
// steps, two expf each, on 12 bytes of input; at the training path's 501
// problems that is a few microseconds of latency in one launch, far from
// both the memory and the arithmetic roofline.  One thread runs one problem
// with its bracket in registers; gss_pick runs one candidate a thread (512
// threads a row) and adds one block argmin.  The tail
// is masked (the TPU wrapper padded kappa with 1.0 instead).
//
// The strict s(c) > s(d) comparison decides each bracket step and the WD
// decides the partner, so the arithmetic must round as the plain version's
// does: the file is compiled without fast math and with -fmad=false, and
// uses expf/logf, not __expf.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "block_argmin.cuh"
#include "lookup.cuh"

namespace {

constexpr float INVPHI = 0.6180339887498949f;  // (sqrt(5) - 1) / 2
constexpr float KAPPA_MIN = 1e-30f;
constexpr int THREADS = 256;
constexpr int PICK_THREADS = 512;   // one candidate a thread up to s = 512 (the search's latency)

__device__ __forceinline__ float objective(float h, float m, float lk) {
  const float u = 1.0f - h;
  return m * expf(u * u * lk) + (1.0f - m) * expf(h * h * lk);
}

// log(kappa) clamped away from 0 (kernels.ref._safe_log).
__device__ __forceinline__ float safe_logf(float kappa) {
  return logf(fminf(fmaxf(kappa, KAPPA_MIN), 1.0f));
}

// The midpoint of the final bracket after n_iters steps (kernels.ref.gss).
__device__ __forceinline__ float search(float m, float lk, int n_iters) {
  float a = 0.0f, b = 1.0f;
  for (int it = 0; it < n_iters; ++it) {
    const float span = b - a;
    const float c = b - span * INVPHI;
    const float d = a + span * INVPHI;
    const bool go_left = objective(c, m, lk) > objective(d, m, lk);
    a = go_left ? a : c;
    b = go_left ? d : b;
  }
  return 0.5f * (a + b);
}

__global__ void gss_kernel(const float* __restrict__ m_in, const float* __restrict__ kappa_in,
                           float* __restrict__ h_out, int n, int n_iters) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  h_out[i] = search(m_in[i], safe_logf(kappa_in[i]), n_iters);
}

// h* of the merge problem of a_min with candidate (alpha, kappa).
__device__ __forceinline__ float candidate_h(float a_min, float alpha, float kappa,
                                             int n_iters) {
  return search(merge_m(a_min, alpha), safe_logf(clip01(kappa)), n_iters);
}

// One block per row r: candidate q is valid when q < count[r], alpha[q] has
// the sign of a_min[r] (alpha * a_min > 0) and q != i_min[r].  Writes the
// first-occurrence argmin j of the WD (slot 0 when no candidate is valid,
// as torch.argmin does over +inf), its WD (>= NO_PARTNER when none is
// valid) and h* at j.
__global__ void __launch_bounds__(PICK_THREADS) gss_pick_kernel(
    const float* __restrict__ alpha, const float* __restrict__ kappa,
    const int* __restrict__ count, const long long* __restrict__ i_min,
    const float* __restrict__ a_min_ptr, int s, int n_iters, long long* __restrict__ j_out,
    float* __restrict__ wd_out, float* __restrict__ h_out) {
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ float h_win;
  const int r = blockIdx.x;
  const float* al = alpha + (size_t)r * s;
  const float* kap = kappa + (size_t)r * s;
  const float a_min = a_min_ptr[r];
  const int cnt = count[r];
  const long long im = i_min[r];
  float bv = INFINITY, bh = 0.0f;
  int bi = INT_MAX;
  for (int q = threadIdx.x; q < s; q += blockDim.x) {
    const float aq = al[q];
    float w = WD_INVALID, h = 0.0f;
    if (q < cnt && aq * a_min > 0.0f && q != im) {
      const float k = clip01(kap[q]);
      const float lk = safe_logf(k);
      h = search(merge_m(a_min, aq), lk, n_iters);
      const float u = 1.0f - h;
      const float a_z = a_min * expf((u * u) * lk) + aq * expf((h * h) * lk);
      w = a_min * a_min + aq * aq + 2.0f * a_min * aq * k - a_z * a_z;
    }
    if (better(w, q, bv, bi)) { bv = w; bi = q; bh = h; }
  }
  float wd_min;
  int j;
  block_argmin(bv, bi, red_v, red_i, &wd_min, &j);
  // the winner's h from the thread that searched it; with no valid
  // candidate, h* at slot 0 as the plain version gathers it
  if (bi == j && bv < WD_INVALID) h_win = bh;
  if (threadIdx.x == 0 && wd_min >= WD_INVALID) h_win = candidate_h(a_min, al[j], kap[j], n_iters);
  __syncthreads();
  if (threadIdx.x == 0) {
    j_out[r] = j;
    wd_out[r] = wd_min;
    h_out[r] = h_win;
  }
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

// alpha, kappa: (rows, s) fp32; count: (rows,) int32; i_min: (rows,) int64;
// a_min: (rows,) fp32.  Writes j_out (rows,) int64 and wd_out, h_out (rows,)
// fp32.  Returns cudaGetLastError().
extern "C" int gss_pick_launch(const void* alpha, const void* kappa, const void* count,
                               const void* i_min, const void* a_min, int rows, int s,
                               int n_iters, void* j_out, void* wd_out, void* h_out,
                               void* stream) {
  gss_pick_kernel<<<rows, PICK_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alpha), static_cast<const float*>(kappa),
      static_cast<const int*>(count), static_cast<const long long*>(i_min),
      static_cast<const float*>(a_min), s, n_iters, static_cast<long long*>(j_out),
      static_cast<float*>(wd_out), static_cast<float*>(h_out));
  return (int)cudaGetLastError();
}

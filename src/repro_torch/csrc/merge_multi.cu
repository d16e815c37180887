// Multi-merge candidate scoring: both Lookup tables for R fixed-partner rows at
// once, and the whole score-and-choose step of a multi-merge event.
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
// multi_merge_choose_kernel is the score-and-choose entry: one block of 256
// threads per class builds the validity mask itself, scores its P x s pairs
// into shared memory (P * s * 4 bytes: 8 KB at the class axis's P = 4,
// s = 508), runs the greedy disjoint pair choice with first-occurrence block
// argmins and the bookkeeping on one thread (multi_merge_choice.cuh, the code
// of the fused train step's multi-merge rounds, here a cluster of one
// block), and reads the h table at
// each pair's winner only.  On a training step the host, not the card, is
// the bound: this replaces about 94 small launches of a masked multi-merge
// round (the mask, the scoring, and ~20 one-element ops per pair of the
// greedy loop) with one.
//
// The arithmetic follows repro.core.lookup.bilinear_lookup term by term
// (lookup.cuh, shared with the fused train step), and the file is compiled
// with -fmad=false, so wd and h equal the plain PyTorch version's bit for bit.
#include <cuda_runtime.h>

#include "lookup.cuh"
#include "multi_merge_choice.cuh"

namespace {

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

  int off;
  float du, dv;
  lookup_coords(merge_m(a, al), clip01(__ldg(kappa + i)), g0, g1, &off, &du, &dv);
  const float interp_wd = corner_mix(wd_table, off, g1, du, dv);
  const float interp_h = corner_mix(h_table, off, g1, du, dv);

  wd_out[i] = valid[i] ? denom * denom * interp_wd : WD_INVALID;
  h_out[i] = interp_h;
}

// One block per class c: alpha (C, s), kappa (C, p, s) the fixed partners'
// cache rows, a_idx/a_min (C, p) the fixed partners (the p smallest active
// |alpha|, cheapest first), count (C,).  Writes the greedy choice (b_idx,
// merged, executed) and h at each pair's winner, (C, p) each.  Dynamic
// shared memory: the pair lists (PairChoice, sized by p), then the (p, s)
// scores.
__global__ void __launch_bounds__(THREADS) multi_merge_choose_kernel(
    const float* __restrict__ alpha, const float* __restrict__ kappa,
    const long long* __restrict__ a_idx, const float* __restrict__ a_min,
    const int* __restrict__ count, int budget, const float* __restrict__ h_table,
    const float* __restrict__ wd_table, int g0, int g1, int p, int s,
    long long* __restrict__ b_out, bool* __restrict__ merged_out,
    bool* __restrict__ exec_out, float* __restrict__ h_out) {
  extern __shared__ float4 smem_mc[];
  __shared__ PairChoice ch;
  __shared__ Reduce rd;
  const Part pt = make_part(1, s, 1);   // the whole class in one block
  int ph = 0;
  const int c = blockIdx.x;
  const float* al = alpha + (size_t)c * s;
  const float* kap = kappa + (size_t)c * p * s;
  char* base = reinterpret_cast<char*>(smem_mc);
  float* wd = reinterpret_cast<float*>(base + pair_choice_bytes(p));
  if (threadIdx.x == 0) carve_pairs(ch, base, p);
  __syncthreads();
  for (int k = threadIdx.x; k < p; k += blockDim.x) {
    ch.a[k] = (int)a_idx[(size_t)c * p + k];
    ch.a_min[k] = a_min[(size_t)c * p + k];
  }
  __syncthreads();
  const int cnt = count[c];
  score_pairs(pt, kap, al, cnt, p, ch, wd_table, g0, g1, wd);
  greedy_choice(pt, wd, p, cnt - budget, ch, rd, ph);
  for (int k = threadIdx.x; k < p; k += blockDim.x) {
    const int bk = ch.b[k];
    int off;
    float du, dv;
    lookup_coords(merge_m(ch.a_min[k], al[bk]), clip01(kap[(size_t)k * s + bk]), g0, g1, &off,
                  &du, &dv);
    const size_t o = (size_t)c * p + k;
    b_out[o] = bk;
    merged_out[o] = ch.merged[k];
    exec_out[o] = ch.executed[k];
    h_out[o] = corner_mix(h_table, off, g1, du, dv);
  }
}

// Dynamic shared memory of multi_merge_choose_kernel, in bytes.
size_t choose_smem(int p, int s) { return pair_choice_bytes(p) + (size_t)p * s * sizeof(float); }

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

// alpha: (c, s) fp32; kappa: (c, p, s) fp32; a_idx: (c, p) int64; a_min:
// (c, p) fp32; count: (c,) int32; h_table, wd_table: (g0, g1) fp32.  Writes
// b_out (c, p) int64, merged_out and exec_out (c, p) bool, h_out (c, p)
// fp32.  Returns cudaGetLastError(), or the error of raising the kernel's
// shared-memory limit (multi_merge_choose_smem_bytes above 48 KB; more than
// the card offers fails there).
extern "C" int multi_merge_choose_launch(const void* alpha, const void* kappa,
                                         const void* a_idx, const void* a_min,
                                         const void* count, int budget, const void* h_table,
                                         const void* wd_table, int g0, int g1, int c, int p,
                                         int s, void* b_out, void* merged_out, void* exec_out,
                                         void* h_out, void* stream) {
  if (p < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = choose_smem(p, s);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        multi_merge_choose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  multi_merge_choose_kernel<<<c, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(alpha), static_cast<const float*>(kappa),
      static_cast<const long long*>(a_idx), static_cast<const float*>(a_min),
      static_cast<const int*>(count), budget, static_cast<const float*>(h_table),
      static_cast<const float*>(wd_table), g0, g1, p, s, static_cast<long long*>(b_out),
      static_cast<bool*>(merged_out), static_cast<bool*>(exec_out),
      static_cast<float*>(h_out));
  return (int)cudaGetLastError();
}

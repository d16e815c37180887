// BDCA's dual coordinate ascent: `rounds` Gauss-Seidel sweeps of exact 1-D
// maximization of the box-constrained SVM dual over each class's working set,
// its Gram matrix read from the kernel cache.  Per class c, with b the signed
// coefficients (stale slots, j >= count, zeroed) and k its (s, s) cache:
//
//   f = b @ k                      ascending j, a product rounded, then added
//   for each sweep, for i < count:
//     y = sign(b_i);  live = b_i != 0
//     a = clip((|b_i| + 1) - y f_i, 0, C)
//     if live: b_i' = y a;  f <- f + (b_i' - b_i) k[i]   (product, then add)
//
// and alpha receives b (stale slots zero), in place.
//
// Replaces src/repro/core/bdca.py::ascent_rounds, which the reference runs
// outside Pallas (a lax.fori_loop over slots inside a lax.scan over sweeps,
// compiled by XLA).  Coordinate i reads the margin f_i that coordinate i - 1
// has just moved, so the loop cannot be vectorised; eagerly it would be ~5
// launches a coordinate.  Here one launch runs every sweep of every class.
// kernels/ref.py bdca_ascent does the same operations in the same order (and
// -fmad=false keeps every product rounded on its own), so the two agree bit
// for bit.  b @ k reads row j of the cache where the reference's k @ b reads
// column j: the cache is exactly symmetric (invariant I2), and rows are
// coalesced.  A coordinate that is not live changes nothing and is skipped.
//
// One block a class (grid = C).  Thread t owns the columns t, t + T, ... of
// f in registers (NQ of them, 1 up to 1,024 slots).  Each coordinate: every
// thread reads b_i (a shared array a sweep) and f_i (a two-slot broadcast
// that the owner of the column wrote before the last barrier), computes the
// same a, updates its columns of f from row i of the cache, loads its
// columns of row i + 1, and the owner of column i + 1 publishes f_{i+1};
// then one __syncthreads.  count is read on the card, so a step needs no
// host read and can be captured in a CUDA graph.
//
// What bounds it on the H100 is the chain of count x rounds dependent
// coordinates, not bandwidth: (rounds + 1) count^2 x 4 bytes is ~3 MB (~0.9
// us at 3.35 TB/s) at count = 500, rounds = 2, against ~245 ns a coordinate
// (PERF.md).  Rows further ahead (in registers or a cp.async ring), fewer
// warps with more columns each, and one warp a class with shuffles instead
// of the barrier all measured no faster.
#include <cuda_runtime.h>

namespace {

template <int NQ>
__device__ __forceinline__ void load_row(float (&kr)[NQ], const float* __restrict__ row, int t,
                                         int T, int n) {
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int col = t + q * T;
    kr[q] = col < n ? row[col] : 0.0f;
  }
}

template <int NQ>
__global__ void bdca_ascent_kernel(float* __restrict__ alpha, const float* __restrict__ kmat,
                                   const int* __restrict__ count, int s, float cap,
                                   int rounds) {
  extern __shared__ float smem[];
  __shared__ float f_slot[2];
  const int T = blockDim.x, t = threadIdx.x;
  float* al = alpha + (size_t)blockIdx.x * s;
  const float* k = kmat + (size_t)blockIdx.x * s * s;
  int n = count[blockIdx.x];
  n = n < 0 ? 0 : (n > s ? s : n);
  float* src = smem;        // b as the sweep found it
  float* dst = smem + s;    // b as the sweep leaves it

  for (int j = t; j < s; j += T) src[j] = j < n ? al[j] : 0.0f;
  __syncthreads();

  float f[NQ], kr[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) f[q] = 0.0f;
#pragma unroll 4
  for (int j = 0; j < n; ++j) {
    const float bj = src[j];
    const float* row = k + (size_t)j * s;
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const int col = t + q * T;
      if (col < n) f[q] = __fadd_rn(f[q], __fmul_rn(bj, row[col]));
    }
  }
  if (n > 0) {
    load_row(kr, k, t, T, n);    // row 0
    if (t == 0) f_slot[0] = f[0];
  }
  __syncthreads();

  int g = 0;   // coordinates run: f_slot[g & 1] holds f at the current one
  for (int r = 0; r < rounds; ++r) {
    for (int i = 0; i < n; ++i) {
      const float bi = src[i];
      const float fi = f_slot[g & 1];
      float bn = bi;
      if (bi != 0.0f) {
        const float y = (float)((0.0f < bi) - (bi < 0.0f));
        const float x = __fsub_rn(__fadd_rn(fabsf(bi), 1.0f), __fmul_rn(y, fi));
        const float a = x < 0.0f ? 0.0f : (x > cap ? cap : x);   // NaN stays NaN
        bn = __fmul_rn(y, a);
        const float d = __fsub_rn(bn, bi);
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          if (t + q * T < n) f[q] = __fadd_rn(f[q], __fmul_rn(d, kr[q]));
      }
      if (t == 0) dst[i] = bn;
      const int nxt = i + 1 < n ? i + 1 : 0;
      if (i + 1 < n || r + 1 < rounds) load_row(kr, k + (size_t)nxt * s, t, T, n);
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        if (t + q * T == nxt) f_slot[(g + 1) & 1] = f[q];
      __syncthreads();
      ++g;
    }
    float* tmp = src;
    src = dst;
    dst = tmp;
  }

  for (int j = t; j < s; j += T) al[j] = j < n ? src[j] : 0.0f;
}

template <int NQ>
int launch(float* alpha, const float* kmat, const int* count, int c, int s, float cap,
           int rounds, cudaStream_t st) {
  const int per = (s + NQ - 1) / NQ;
  const int threads = (per + 31) / 32 * 32;
  const size_t smem = 2 * (size_t)s * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bdca_ascent_kernel<NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bdca_ascent_kernel<NQ><<<c, threads, smem, st>>>(alpha, kmat, count, s, cap, rounds);
  return (int)cudaGetLastError();
}

}  // namespace

// alpha: (c, s) fp32, updated in place; kmat: (c, s, s) fp32; count: (c,)
// int32.  All row-major and contiguous; s <= 16,384 (1,024 threads of 16
// columns).  Returns the launch's error.
extern "C" int bdca_ascent_launch(void* alpha, const void* kmat, const void* count, int c, int s,
                                  float cap, int rounds, void* stream) {
  if (c <= 0) return 0;
  if (s <= 0 || s > 16 * 1024 || rounds < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(alpha);
  const float* k = static_cast<const float*>(kmat);
  const int* n = static_cast<const int*>(count);
  if (s <= 1024) return launch<1>(a, k, n, c, s, cap, rounds, st);
  if (s <= 2048) return launch<2>(a, k, n, c, s, cap, rounds, st);
  if (s <= 4096) return launch<4>(a, k, n, c, s, cap, rounds, st);
  if (s <= 8192) return launch<8>(a, k, n, c, s, cap, rounds, st);
  return launch<16>(a, k, n, c, s, cap, rounds, st);
}

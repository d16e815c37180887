// Gaussian (RBF) kernel matrix  K[i, j] = exp(-gamma * max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0)).
//
// Replaces the TPU kernel src/repro/kernels/rbf_kernel.py::rbf_matrix_pallas
// (body _rbf_block_kernel): the same matmul-form squared distance, accumulated
// in fp32 over the feature axis, clamped at 0, exp applied once per output.
// Inputs are fp32 or bf16 (each operand independently); the output is fp32.
// No tensor cores (TF32 would round the products): fp32 FMAs, as the
// reference's sums are fp32, and the margin near-ties of the training paths
// make the last bit matter.
//
// Two kernels, each summing in a fixed order that does not depend on the
// launch shape, so that every output keeps its bits whatever the grid:
//   * rbf_thin, few rows against a bank (n <= THIN_ROWS = 16, the cutover
//     measured on an H100 at n = 8, 16 and 32: the training path's margin
//     and kappa rows, 1 x 501 x 123 binary, 8 x 5,080 x 780 on the class
//     axis).  What bounds it on the H100 is the bank: 15.9 MB at
//     C = 10, S = 508, D = 780 (4.7 us at 3.35 TB/s) against 63 MFLOP
//     (0.9 us).  So the block stages the n x-rows once in shared memory and
//     each warp owns two bank rows, read once, and computes all n outputs of
//     both: a lane keeps one |y|^2 partial a bank row and one |x|^2 and one
//     x.y partial an output row, striding over the features with four loads
//     of each bank row in flight, then the butterfly warp_sum.  The bank is
//     read once, not n times.  The row count is a template argument (n
//     padded to a power of two with zero rows): with a row count known only
//     at run time the unrolled loops keep a predicate on every product.
//     At n = 1 (one warp a bank row, the rows read through the read-only
//     path, no barrier) the launch itself (~2 us) is the bound.  Each
//     output's three sums are the per-lane fmaf chains and the butterfly of
//     one warp over the features, the order train_step.cu's margin rows
//     share.
//   * rbf_tiled, many rows (decision values, the cache's initial block; the
//     serve cell, class_scores.cu, sums each output in its order): 6,512 x
//     501 x 123 is 803 MFLOP (12 us at 67 TFLOP/s) on 4 MB, so operations
//     bound it.  A block computes a 64 x 64 tile
//     with 256 threads (32 x 64 with 128 threads for 32 rows or fewer, for
//     more blocks) and a 4 x 4 register micro-tile a thread; the operands
//     are staged through shared memory BK features at a time, k-major,
//     double-buffered with cp.async (fp32) or a register copy that widens
//     bf16.  x.y is summed by one thread an output over k = 0, 1, ..., d - 1
//     in order; |x_i|^2 and |y_j|^2 once a row and a column (one thread
//     each, the same sequential order) instead of once an output.
//
// Ragged n, m and d are masked here; nothing is padded by the caller (a
// staged zero adds nothing to a sum).  Sums use explicit fmaf and are
// finished by rbf_from_sums (rbf_epilogue.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rbf_epilogue.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int THIN_ROWS = 16;  // n <= THIN_ROWS takes rbf_thin (the sums' order is thin's)
constexpr int THIN_MAX = 32;   // the most rows rbf_thin takes when asked for (path = 1)
constexpr int THIN_WARPS = 8;  // warps a block of rbf_thin
constexpr int LOADS = 4;       // features a lane loads ahead, per bank row
constexpr size_t SMEM_LIMIT = 232448;   // shared memory a block may use on Hopper (227 KB)

// NR rows, the n of the call padded to a power of two with zero rows (a row
// count known only at run time would put a predicate on every product of the
// unrolled loops; a zero row adds only its own sums), JPW bank rows a warp.  With STAGE the
// block first stages the rows in shared memory (fp32); otherwise (NR = n =
// 1, where the launch is the bound and a barrier only adds to it) they come
// through the read-only path.
template <int NR, int JPW, bool STAGE, typename TX, typename TY>
__global__ void __launch_bounds__(THIN_WARPS * 32) rbf_thin(
    const TX* __restrict__ x, const TY* __restrict__ y, float* __restrict__ out, int n, int m,
    int d, float gamma) {
  extern __shared__ float xs[];   // (NR, d) when STAGE
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (STAGE) {
    constexpr int PER = 8;        // loads a thread issues before its stores
    const int nd = n * d;
    for (int e0 = threadIdx.x; e0 < NR * d; e0 += blockDim.x * PER) {
      float t[PER];
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int e = e0 + q * blockDim.x;
        t[q] = e < nd ? to_f32(x[e]) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int e = e0 + q * blockDim.x;
        if (e < NR * d) xs[e] = t[q];
      }
    }
    __syncthreads();
  }
  const int j0 = (blockIdx.x * THIN_WARPS + warp) * JPW;
  if (j0 >= m) return;   // the whole warp leaves together, after the block's barrier
  const TY* yr[JPW];
#pragma unroll
  for (int u = 0; u < JPW; ++u) yr[u] = y + (size_t)(j0 + u < m ? j0 + u : j0) * d;
  float yn[JPW], xn[NR], xy[JPW][NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) xn[r] = 0.0f;
#pragma unroll
  for (int u = 0; u < JPW; ++u) {
    yn[u] = 0.0f;
#pragma unroll
    for (int r = 0; r < NR; ++r) xy[u][r] = 0.0f;
  }
  for (int k0 = lane; k0 < d; k0 += LOADS * 32) {
    float v[JPW][LOADS];
#pragma unroll
    for (int u = 0; u < JPW; ++u)
#pragma unroll
      for (int t = 0; t < LOADS; ++t) {
        const int k = k0 + t * 32;
        v[u][t] = k < d ? to_f32(yr[u][k]) : 0.0f;
      }
#pragma unroll
    for (int t = 0; t < LOADS; ++t) {
      const int k = k0 + t * 32;
      if (k < d) {
#pragma unroll
        for (int u = 0; u < JPW; ++u) yn[u] = fmaf(v[u][t], v[u][t], yn[u]);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          const float a = STAGE ? xs[r * d + k] : to_f32(x[(size_t)r * d + k]);
          xn[r] = fmaf(a, a, xn[r]);
#pragma unroll
          for (int u = 0; u < JPW; ++u) xy[u][r] = fmaf(a, v[u][t], xy[u][r]);
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < JPW; ++u) yn[u] = warp_sum(yn[u]);
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    const float xn_r = warp_sum(xn[r]);
#pragma unroll
    for (int u = 0; u < JPW; ++u) {
      const float dot = warp_sum(xy[u][r]);
      if (lane == 0 && r < n && j0 + u < m)
        out[(size_t)r * m + j0 + u] = rbf_from_sums(xn_r, yn[u], dot, gamma);
    }
  }
}

// rbf_tiled's shape: BM x BN outputs a block, TM x TN a thread, BK features a
// stage.
constexpr int BK = 16;
constexpr int PAD = 4;   // keeps the k-major rows 16-byte aligned

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src),
               "r"(in ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One operand's ROWS x BK slice at features [k0, k0 + BK), k-major into
// dst[kk][row]; rows past ``rows`` and features past d are zeros.  load()
// starts the copy and store() ends it: fp32 goes by cp.async (zero-filled out
// of range; store() has nothing to do), bf16 through registers, widened in
// store(), so that both overlap the copy of the next slice with the
// products of this one.
template <typename T, int ROWS, int THREADS>
struct Stage {
  static constexpr int N = ROWS * BK / THREADS;
  float held[N];
  __device__ __forceinline__ void load(const T* __restrict__ src, float (*dst)[ROWS + PAD],
                                       int row0, int rows, int k0, int d) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * THREADS;
      const int r = e / BK, kk = e % BK, gr = row0 + r, k = k0 + kk;
      const bool in = gr < rows && k < d;
      if constexpr (sizeof(T) == 4) {
        cp_async4(&dst[kk][r], in ? src + (size_t)gr * d + k : src, in);
      } else {
        held[i] = in ? to_f32(src[(size_t)gr * d + k]) : 0.0f;
      }
    }
  }
  __device__ __forceinline__ void store(float (*dst)[ROWS + PAD]) {
    if constexpr (sizeof(T) != 4) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const int e = threadIdx.x + i * THREADS;
        dst[e % BK][e / BK] = held[i];
      }
    }
  }
};

template <int BM, int BN, int TM, int TN, typename TX, typename TY>
__global__ void __launch_bounds__((BM / TM) * (BN / TN)) rbf_tiled(
    const TX* __restrict__ x, const TY* __restrict__ y, float* __restrict__ out, int n, int m,
    int d, float gamma) {
  constexpr int THREADS = (BM / TM) * (BN / TN);
  constexpr int NORMS = (BM + BN + THREADS - 1) / THREADS;   // norms a thread sums
  static_assert(TM % 4 == 0 && TN % 4 == 0 && (BM * BK) % THREADS == 0
                    && (BN * BK) % THREADS == 0, "tile shape");
  __shared__ __align__(16) float as[2][BK][BM + PAD];
  __shared__ __align__(16) float bs[2][BK][BN + PAD];
  __shared__ float norm[BM + BN];   // |x_i|^2 of the tile's rows, then |y_j|^2 of its columns
  const int tid = threadIdx.x, ty = tid / (BN / TN), tx = tid % (BN / TN);
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int c = 0; c < TN; ++c) acc[r][c] = 0.0f;
  float nrm[NORMS];   // entry q = tid + u THREADS of norm: a row below BM, else a column
#pragma unroll
  for (int u = 0; u < NORMS; ++u) nrm[u] = 0.0f;
  const int n_tiles = (d + BK - 1) / BK;
  Stage<TX, BM, THREADS> sx;
  Stage<TY, BN, THREADS> sy;
  if (n_tiles > 0) {
    sx.load(x, as[0], row0, n, 0, d);
    sy.load(y, bs[0], col0, m, 0, d);
    sx.store(as[0]);
    sy.store(bs[0]);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int cur = kt & 1;
    const bool next = kt + 1 < n_tiles;
    if (next) {
      sx.load(x, as[cur ^ 1], row0, n, (kt + 1) * BK, d);
      sy.load(y, bs[cur ^ 1], col0, m, (kt + 1) * BK, d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int q = 0; q < TM; q += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&as[cur][kk][ty * TM + q]);
        a[q] = v.x; a[q + 1] = v.y; a[q + 2] = v.z; a[q + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < TN; q += 4) {
        const float4 v = *reinterpret_cast<const float4*>(&bs[cur][kk][tx * TN + q]);
        b[q] = v.x; b[q + 1] = v.y; b[q + 2] = v.z; b[q + 3] = v.w;
      }
#pragma unroll
      for (int r = 0; r < TM; ++r)
#pragma unroll
        for (int c = 0; c < TN; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
#pragma unroll
    for (int u = 0; u < NORMS; ++u) {
      const int q = tid + u * THREADS;
      if (q >= BM + BN) break;
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float v = q < BM ? as[cur][kk][q] : bs[cur][kk][q - BM];
        nrm[u] = fmaf(v, v, nrm[u]);
      }
    }
    if (next) {   // the bf16 copy of the next slice, read before this slice's products
      sx.store(as[cur ^ 1]);
      sy.store(bs[cur ^ 1]);
    }
    __syncthreads();   // this buffer is the next stage's target; the next one is written
  }
#pragma unroll
  for (int u = 0; u < NORMS; ++u)
    if (tid + u * THREADS < BM + BN) norm[tid + u * THREADS] = nrm[u];
  __syncthreads();
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const int i = row0 + ty * TM + r;
    if (i >= n) continue;
#pragma unroll
    for (int c = 0; c < TN; ++c) {
      const int j = col0 + tx * TN + c;
      if (j < m)
        out[(size_t)i * m + j] = rbf_from_sums(norm[ty * TM + r], norm[BM + tx * TN + c],
                                               acc[r][c], gamma);
    }
  }
}

template <int BM, int BN, int TM, int TN, typename TX, typename TY>
cudaError_t launch_tiled(const TX* x, const TY* y, float* out, int n, int m, int d, float gamma,
                         cudaStream_t stream) {
  dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
  rbf_tiled<BM, BN, TM, TN, TX, TY><<<grid, (BM / TM) * (BN / TN), 0, stream>>>(x, y, out, n, m,
                                                                              d, gamma);
  return cudaGetLastError();
}

template <int NR, typename TX, typename TY>
cudaError_t launch_thin(const TX* x, const TY* y, float* out, int n, int m, int d, float gamma,
                        cudaStream_t stream) {
  constexpr int JPW = NR == 1 ? 1 : 2;   // two bank rows share each staged x value
  constexpr bool STAGE = NR > 1;
  auto kernel = rbf_thin<NR, JPW, STAGE, TX, TY>;
  const size_t smem = STAGE ? (size_t)NR * d * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int per_block = THIN_WARPS * JPW;
  kernel<<<(m + per_block - 1) / per_block, THIN_WARPS * 32, smem, stream>>>(x, y, out, n, m,
                                                                              d, gamma);
  return cudaGetLastError();
}

// path: 0 = the rule (rbf_thin for n <= THIN_ROWS whose rows fit shared
// memory, else rbf_tiled); 1 = rbf_thin (n <= THIN_MAX); 2 = rbf_tiled.
template <typename TX, typename TY>
cudaError_t launch(const void* x, const void* y, float* out, int n, int m, int d, float gamma,
                   int path, cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TY* yp = static_cast<const TY*>(y);
  int nr = 1;   // the power of two rbf_thin pads n to
  while (nr < n && nr < THIN_MAX) nr *= 2;
  // rbf_thin stages the rows in shared memory: past d = 3,632 at n = 16 they
  // do not fit, and the rule takes rbf_tiled
  const bool thin = n <= THIN_MAX && (n == 1 || (size_t)nr * d * sizeof(float) <= SMEM_LIMIT);
  if (path == 1 && !thin) return cudaErrorInvalidValue;
  if (path == 1 || (path == 0 && n <= THIN_ROWS && thin)) {
    switch (nr) {
      case 1: return launch_thin<1>(xp, yp, out, n, m, d, gamma, stream);
      case 2: return launch_thin<2>(xp, yp, out, n, m, d, gamma, stream);
      case 4: return launch_thin<4>(xp, yp, out, n, m, d, gamma, stream);
      case 8: return launch_thin<8>(xp, yp, out, n, m, d, gamma, stream);
      case 16: return launch_thin<16>(xp, yp, out, n, m, d, gamma, stream);
      default: return launch_thin<32>(xp, yp, out, n, m, d, gamma, stream);
    }
  }
  if (n <= 32) return launch_tiled<32, 64, 4, 4>(xp, yp, out, n, m, d, gamma, stream);
  return launch_tiled<64, 64, 4, 4>(xp, yp, out, n, m, d, gamma, stream);
}

}  // namespace

// x: (n, d), y: (m, d), row-major and contiguous; x_bf16 / y_bf16 say whether
// each operand is bf16 (else fp32).  out: (n, m) fp32.  path: 0 the rule,
// 1 rbf_thin, 2 rbf_tiled (the last two for measurement).  Returns the
// launch's error, or cudaGetLastError() after it.
extern "C" int rbf_matrix_launch(const void* x, int x_bf16, const void* y, int y_bf16,
                                 void* out, int n, int m, int d, float gamma, int path,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  cudaError_t e;
  if (x_bf16 && y_bf16) e = launch<__nv_bfloat16, __nv_bfloat16>(x, y, o, n, m, d, gamma, path, s);
  else if (x_bf16) e = launch<__nv_bfloat16, float>(x, y, o, n, m, d, gamma, path, s);
  else if (y_bf16) e = launch<float, __nv_bfloat16>(x, y, o, n, m, d, gamma, path, s);
  else e = launch<float, float>(x, y, o, n, m, d, gamma, path, s);
  return (int)e;
}

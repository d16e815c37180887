// Gaussian (RBF) kernel matrix  K[i, j] = exp(-gamma * max(|x_i|^2 + |y_j|^2 - 2 x_i.y_j, 0)).
//
// Replaces the TPU kernel src/repro/kernels/rbf_kernel.py::rbf_matrix_pallas
// (body _rbf_block_kernel): the same matmul-form squared distance, accumulated
// in fp32 over the feature axis, clamped at 0, exp applied once per output.
// Inputs are fp32 or bf16 (each operand independently); the output is fp32.
//
// What bounds it on the H100: on the training path the call is one row
// against the bank (n = 1, m = slots = 501, d = 123), a ~250 KB read that the
// card could finish in well under a microsecond; the launch itself (a few
// microseconds) is the real bound, so the design keeps the thin case to one
// short pass: one warp per output, lanes striding over d, a shuffle
// reduction, and enough warps (n * m) to cover m across the SMs instead of one
// block that loops.  Decision values (n = thousands of rows) go through a
// shared-memory tiled kernel: each 16 x 16 block stages 16-row slices of x
// and y in shared memory, 32 features at a time, so each input element is
// read from device memory once per tile row/column instead of once per
// output.  No tensor cores: fp32 accumulation of three sums (|x|^2, |y|^2,
// x.y) per output, exactly the quantities the reference forms.
//
// Ragged n, m and d are masked here; nothing is padded by the caller.  The
// sums are accumulated with explicit fmaf and finished by rbf_from_sums
// (rbf_epilogue.cuh), the expression train_step.cu's margin rows share.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rbf_epilogue.cuh"

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

constexpr int TILE = 16;       // output tile is TILE x TILE, one output per thread
constexpr int TK = 32;         // features staged in shared memory per pass
constexpr int THIN_ROWS = 8;   // n <= THIN_ROWS takes the warp-per-output kernel
constexpr int WARPS_PER_BLOCK = 8;

template <typename TX, typename TY>
__global__ void rbf_tiled(const TX* __restrict__ x, const TY* __restrict__ y,
                          float* __restrict__ out, int n, int m, int d, float gamma) {
  __shared__ float xs[TILE][TK + 1];
  __shared__ float ys[TILE][TK + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row0 = blockIdx.y * TILE, col0 = blockIdx.x * TILE;
  float xn = 0.0f, yn = 0.0f, xy = 0.0f;
  for (int k0 = 0; k0 < d; k0 += TK) {
    // 256 threads stage a TILE x TK slice of each operand; neighbouring
    // threads read neighbouring features (coalesced rows).
    for (int e = ty * TILE + tx; e < TILE * TK; e += TILE * TILE) {
      const int r = e / TK, c = e % TK, k = k0 + c;
      const int gi = row0 + r, gj = col0 + r;
      xs[r][c] = (gi < n && k < d) ? to_f32(x[(size_t)gi * d + k]) : 0.0f;
      ys[r][c] = (gj < m && k < d) ? to_f32(y[(size_t)gj * d + k]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int c = 0; c < TK; ++c) {
      const float a = xs[ty][c], b = ys[tx][c];
      xn = fmaf(a, a, xn);
      yn = fmaf(b, b, yn);
      xy = fmaf(a, b, xy);
    }
    __syncthreads();
  }
  const int i = row0 + ty, j = col0 + tx;
  if (i < n && j < m) out[(size_t)i * m + j] = rbf_from_sums(xn, yn, xy, gamma);
}

template <typename TX, typename TY>
__global__ void rbf_thin(const TX* __restrict__ x, const TY* __restrict__ y,
                         float* __restrict__ out, int n, int m, int d, float gamma) {
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= (long long)n * m) return;  // the whole warp leaves together
  const int i = (int)(warp / m), j = (int)(warp % m);
  const TX* xr = x + (size_t)i * d;
  const TY* yr = y + (size_t)j * d;
  float xn = 0.0f, yn = 0.0f, xy = 0.0f;
  for (int k = lane; k < d; k += 32) {
    const float a = to_f32(xr[k]), b = to_f32(yr[k]);
    xn = fmaf(a, a, xn);
    yn = fmaf(b, b, yn);
    xy = fmaf(a, b, xy);
  }
  xn = warp_sum(xn);
  yn = warp_sum(yn);
  xy = warp_sum(xy);
  if (lane == 0) out[(size_t)i * m + j] = rbf_from_sums(xn, yn, xy, gamma);
}

template <typename TX, typename TY>
void launch(const void* x, const void* y, float* out, int n, int m, int d, float gamma,
            cudaStream_t stream) {
  const TX* xp = static_cast<const TX*>(x);
  const TY* yp = static_cast<const TY*>(y);
  if (n <= THIN_ROWS) {
    const long long warps = (long long)n * m;
    const int threads = WARPS_PER_BLOCK * 32;
    const int blocks = (int)((warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK);
    rbf_thin<TX, TY><<<blocks, threads, 0, stream>>>(xp, yp, out, n, m, d, gamma);
  } else {
    dim3 block(TILE, TILE);
    dim3 grid((m + TILE - 1) / TILE, (n + TILE - 1) / TILE);
    rbf_tiled<TX, TY><<<grid, block, 0, stream>>>(xp, yp, out, n, m, d, gamma);
  }
}

}  // namespace

// x: (n, d), y: (m, d), row-major and contiguous; x_bf16 / y_bf16 say whether
// each operand is bf16 (else fp32).  out: (n, m) fp32.  Returns cudaGetLastError().
extern "C" int rbf_matrix_launch(const void* x, int x_bf16, const void* y, int y_bf16,
                                 void* out, int n, int m, int d, float gamma, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (x_bf16 && y_bf16) launch<__nv_bfloat16, __nv_bfloat16>(x, y, o, n, m, d, gamma, s);
  else if (x_bf16) launch<__nv_bfloat16, float>(x, y, o, n, m, d, gamma, s);
  else if (y_bf16) launch<float, __nv_bfloat16>(x, y, o, n, m, d, gamma, s);
  else launch<float, float>(x, y, o, n, m, d, gamma, s);
  return (int)cudaGetLastError();
}

// The serve cell in one launch.  For request rows x (n, d) and the bank
// (C * s, d), class c's slots in rows [c s, (c + 1) s):
//   K[i, c s + j] = exp(-gamma * max(|x_i|^2 + |y_{c s + j}|^2 - 2 x_i . y_{c s + j}, 0)),
//   scores[c, i]  = sum_j K[i, c s + j] * alpha[c, j],
// and the row's label: the argmax over classes (the first maximum wins, a NaN
// counts as the maximum: jnp.argmax's rule) or, for a binary model (C = 1),
// the sign of its one score (0 for a zero score, NaN for NaN: jnp.sign's).
// K is never written to device memory.
//
// Replaces, on the serve path, the TPU kernel block
// (src/repro/kernels/rbf_kernel.py::rbf_matrix_pallas) and the per-class
// contraction the reference runs after it (src/repro/kernels/ops.py::
// class_scores, an einsum, and the argmax or sign of core/predict.py::
// predict_labels).
//
// Every sum has one order whatever n and whatever the tile shape, so a row's
// scores and label are the same bits in a microbatch of any size, and the
// same bits as rbf_tiled's K (rbf_kernel.cu) contracted by
// kernels/ref.py class_scores_labels:
//   * x.y, |x_i|^2 and |y_j|^2: one thread an output (a row, a column),
//     fmaf over k = 0, 1, ..., d - 1 in order, as rbf_tiled sums them;
//     rbf_from_sums finishes each value;
//   * the contraction: lane l of a warp adds the products of slots l, l + 32,
//     l + 64, ... in order (a product rounded, then a sum: no fused
//     multiply-add), then the xor butterfly of warp_sum.
// No tensor cores (TF32 would round the products) and no split over the
// features (it would change the order).
//
// What bounds it on the H100: at the serve shape (C = 10, s = 508, d = 780)
// the fp32 bank is 15.9 MB (4.7 us at 3.35 TB/s), against n x 7.9 MFLOP of
// fp32 FMAs (operations bound from ~40 rows).  The design:
//   * one thread-block cluster of ks blocks per (row tile, class), ks <= 16:
//     block r computes K for the tile's BM rows against its ct tiles of BN
//     of the class's columns (ct = 1 up to s = 16 BN), a TM x TN register
//     micro-tile a thread.  The operands go through a ring of STAGES
//     shared-memory buffers, BK features a stage, row-major, by cp.async
//     (16 bytes a copy where d % 4 == 0), so that STAGES - 1 slices of the
//     bank are in flight a block; bf16 stays bf16 there and is widened as
//     it is read;
//   * each K value goes straight into the shared memory of the cluster
//     block that contracts its row (row i to block i % ks, a remote store:
//     nothing waits on it; a block arrives at a cluster barrier on entry and
//     waits on it before its first remote store, so that every block of the
//     cluster has started by then); after one more cluster barrier each warp
//     contracts a row of its block from local shared memory, alpha staged
//     beside it;
//   * the label needs every class: each block, once its rows' scores are
//     written, takes a ticket for its row tile (a counter in device memory);
//     the block that takes the last of the C ks tickets reads the tile's
//     scores back from L2 in one pass and writes the labels, and sets the
//     counter back to 0 for the next launch on the stream (the wrapper keeps
//     one set of counters a stream).  A binary model's one score gives its
//     label at once;
//   * the row tile follows n (CELL_RULE): a small microbatch spends no FMAs
//     on padding rows and keeps more of the bank in flight a block.
#include <atomic>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rbf_epilogue.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int MAX_CLUSTER = 16;  // column slices of a class (above 8: a non-portable cluster)
constexpr size_t SMEM_LIMIT = 232448 - 1024;   // Hopper's 227 KB, less the static arrays

// Four consecutive elements of shared memory as floats (bf16 widened).
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(t.x << 16); v[1] = __uint_as_float(t.x & 0xffff0000u);
  v[2] = __uint_as_float(t.y << 16); v[3] = __uint_as_float(t.y & 0xffff0000u);
}

constexpr int PAD = 4;   // elements after each staged row: keeps rows aligned, columns off-bank

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A cluster barrier in two halves: every thread of every block arrives, and
// waits before it touches another block's shared memory.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void fence_acq_rel() {
  asm volatile("fence.acq_rel.gpu;\n" ::: "memory");
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)   // streamed: past L1
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
                 "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
                 "n"(BYTES), "r"(in ? BYTES : 0));
}

// One operand's ROWS x BK slice at features [k0, k0 + BK), row-major into
// dst[ROWS][BK + PAD] in the operand's own type (bf16 stays bf16 until it
// is read); rows past ``rows`` and features past d are zeros (a staged zero
// adds nothing to a sum).  With VEC (d % 4 == 0, aligned rows) chunks of
// four elements go by cp.async (16 bytes fp32, 8 bf16); otherwise fp32
// elements go by 4-byte cp.async, and bf16 ones through registers, loaded
// in load() and written in store() so that the copy overlaps a stage of
// products.
template <typename T, int ROWS, int BK, int THREADS, bool VEC>
struct Loader {
  static constexpr bool REG = !VEC && sizeof(T) == 2;
  static constexpr int TOTAL = VEC ? ROWS * BK / 4 : ROWS * BK;   // copies a slice
  static constexpr int PER = (TOTAL + THREADS - 1) / THREADS;
  unsigned short held[REG ? PER : 1];
  __device__ __forceinline__ void load(const T* __restrict__ src, T* dst, int row0, int rows,
                                       int k0, int d) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int e = threadIdx.x + i * THREADS;
      if (TOTAL % THREADS != 0 && e >= TOTAL) break;
      if constexpr (VEC) {
        const int r = e / (BK / 4), kk = e % (BK / 4) * 4, gr = row0 + r, k = k0 + kk;
        const bool in = gr < rows && k < d;
        cp_async<(int)(4 * sizeof(T))>(dst + r * (BK + PAD) + kk, in ? src + (size_t)gr * d + k : src,
                                in);
      } else {
        const int r = e / BK, kk = e % BK, gr = row0 + r, k = k0 + kk;
        const bool in = gr < rows && k < d;
        if constexpr (REG) {
          held[i] = in ? __bfloat16_as_ushort(src[(size_t)gr * d + k]) : (unsigned short)0;
        } else {
          cp_async<4>(dst + r * (BK + PAD) + kk, in ? src + (size_t)gr * d + k : src, in);
        }
      }
    }
  }
  __device__ __forceinline__ void store(T* dst) {
    if constexpr (REG) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int e = threadIdx.x + i * THREADS;
        if (TOTAL % THREADS != 0 && e >= TOTAL) break;
        reinterpret_cast<unsigned short*>(dst)[e / BK * (BK + PAD) + e % BK] = held[i];
      }
    }
  }
};

template <int BM, int BN, int TM, int TN, int BK, int STAGES>
struct Shape {
  static constexpr int THREADS = (BM / TM) * (BN / TN);
  static constexpr int AS = BM * (BK + PAD), BS = BN * (BK + PAD);   // elements a stage
  static_assert(BM % TM == 0 && BN % TN == 0 && THREADS % 32 == 0 && BK % 4 == 0
                    && STAGES >= 2, "tile shape");
  static_assert(BM <= THREADS, "a thread a row labels the tile");
  // bytes of the stage ring for operands of x_elem and y_elem bytes
  __host__ __device__ static constexpr size_t ring(size_t x_elem, size_t y_elem) {
    return STAGES * (AS * x_elem + BS * y_elem);
  }
  // dynamic shared memory: the ring, then K of the rows this block contracts
  // (ceil(BM / ks) rows of s) and its class's alpha
  static size_t smem(int ks, int s, size_t x_elem, size_t y_elem) {
    return ring(x_elem, y_elem) + sizeof(float) * ((size_t)((BM + ks - 1) / ks + 1) * s);
  }
};

template <int BM, int BN, int TM, int TN, int BK, int STAGES, typename TX, typename TY, bool VEC>
__global__ void __launch_bounds__(Shape<BM, BN, TM, TN, BK, STAGES>::THREADS)
    class_scores_cell(const TX* __restrict__ x, const TY* __restrict__ bank,
                      const float* __restrict__ alpha, float* __restrict__ scores,
                      void* __restrict__ labels, unsigned* __restrict__ tickets, int n, int c,
                      int s, int d, int ct, float gamma, int binary) {
  using S = Shape<BM, BN, TM, TN, BK, STAGES>;
  constexpr int THREADS = S::THREADS, WARPS = THREADS / 32;
  constexpr size_t RING = S::ring(sizeof(TX), sizeof(TY));
  constexpr int RS = BM / TM, CS = BN / TN;   // a thread's rows and columns are RS and CS apart
  constexpr int NORMS = (BM + BN + THREADS - 1) / THREADS;   // norms a thread sums
  extern __shared__ __align__(16) unsigned char smem[];
  TX* const as = reinterpret_cast<TX*>(smem);                        // [STAGES][BM][BK + PAD]
  TY* const bs = reinterpret_cast<TY*>(smem + STAGES * S::AS * sizeof(TX));   // [STAGES][BN][BK + PAD]
  __shared__ float norm[BM + BN];   // |x_i|^2 of the tile's rows, then |y_j|^2 of its columns
  __shared__ bool last;
  const cg::cluster_group cluster = cg::this_cluster();
  const int ks = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  // K of the tile's rows i = rank, rank + ks, ...: kr[i / ks][j] for slot j
  float* const kr = reinterpret_cast<float*>(smem + RING);
  float* const al = kr + (BM + ks - 1) / ks * s;                     // [s]: the class's alpha
  const int cls = blockIdx.y / ks, w = ct * BN;
  const int row0 = blockIdx.x * BM, rows = min(BM, n - row0);
  const TY* const yc = bank + (size_t)cls * s * d;
  const int tid = threadIdx.x, ty = tid / CS, tx = tid % CS;
  const int warp = tid >> 5, lane = tid & 31;
  cluster_arrive_relaxed();   // waited on before the first remote store

  // stage g: column tile g / nk of this block's slice, features [(g % nk) BK, + BK)
  const int nk = max(1, (d + BK - 1) / BK), total = ct * nk;
  Loader<TX, BM, BK, THREADS, VEC> lx;
  Loader<TY, BN, BK, THREADS, VEC> ly;
  auto load = [&](int g) {   // one commit group a stage, empty past the last
    if (g < total) {
      const int k0 = (g % nk) * BK;
      lx.load(x, as + (g % STAGES) * S::AS, row0, n, k0, d);
      ly.load(yc, bs + (g % STAGES) * S::BS, rank * w + (g / nk) * BN, s, k0, d);
    }
    cp_async_commit();
  };
  auto store = [&](int g) {
    if (g < total) {
      lx.store(as + (g % STAGES) * S::AS);
      ly.store(bs + (g % STAGES) * S::BS);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int r = 0; r < TM; ++r)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[r][q] = 0.0f;
  float nrm[NORMS];   // entry u: norm[tid + u THREADS], a row below BM, else a column
#pragma unroll
  for (int u = 0; u < NORMS; ++u) nrm[u] = 0.0f;

  // the class's alpha lands with the first stage
  for (int j = tid; j < s; j += THREADS) cp_async<4>(al + j, alpha + (size_t)cls * s + j, true);
  for (int g = 0; g < STAGES - 1; ++g) {
    load(g);
    store(g);
  }
  for (int g = 0; g < total; ++g) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // stage g has landed; stage g - 1's buffer is free
    load(g + STAGES - 1);
    const TX* const A = as + (g % STAGES) * S::AS;
    const TY* const B = bs + (g % STAGES) * S::BS;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float a[TM][4], b[TN][4];
#pragma unroll
      for (int r = 0; r < TM; ++r) load4(A + (ty + r * RS) * (BK + PAD) + k4, a[r]);
#pragma unroll
      for (int q = 0; q < TN; ++q) load4(B + (tx + q * CS) * (BK + PAD) + k4, b[q]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < TM; ++r)
#pragma unroll
          for (int q = 0; q < TN; ++q) acc[r][q] = fmaf(a[r][kk], b[q][kk], acc[r][q]);
    }
#pragma unroll
    for (int u = 0; u < NORMS; ++u) {
      const int q = tid + u * THREADS;
      if (q >= BM + BN) break;
#pragma unroll
      for (int k4 = 0; k4 < BK; k4 += 4) {
        float v[4];
        if (q < BM) load4(A + q * (BK + PAD) + k4, v);
        else load4(B + (q - BM) * (BK + PAD) + k4, v);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) nrm[u] = fmaf(v[kk], v[kk], nrm[u]);
      }
    }
    store(g + STAGES - 1);   // the register copy of a later stage, into stage g - 1's buffer
    if (g % nk == nk - 1) {  // column tile g / nk is summed: its K to the rows' blocks
#pragma unroll
      for (int u = 0; u < NORMS; ++u) {
        if (tid + u * THREADS < BM + BN) norm[tid + u * THREADS] = nrm[u];
        nrm[u] = 0.0f;
      }
      __syncthreads();
      if (g == nk - 1) cluster_wait();   // every block of the cluster has started
      const int j0 = rank * w + (g / nk) * BN;   // the tile's first slot
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int i = ty + r * RS;
        float* const dst = cluster.map_shared_rank(kr, (unsigned)(i % ks)) + i / ks * s + j0;
#pragma unroll
        for (int q = 0; q < TN; ++q) {
          const int j = tx + q * CS;
          if (i < rows && j0 + j < s)
            dst[j] = rbf_from_sums(norm[i], norm[BM + j], acc[r][q], gamma);
          acc[r][q] = 0.0f;
        }
      }
    }
  }
  cp_async_wait<0>();
  cluster.sync();   // every row's K is in the shared memory of the block that contracts it

  // the contraction of this block's rows, a warp a row, UNROLL slots of a
  // lane loaded before they are summed in order
  constexpr int UNROLL = 4;
  const int padded = (s + 31) / 32 * 32;
  for (int lr = warp; lr * ks + rank < rows; lr += WARPS) {
    const float* const kq = kr + lr * s;
    float sum = 0.0f;
    for (int j0 = lane; j0 < padded; j0 += 32 * UNROLL) {
      float p[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + 32 * u;
        p[u] = j < s ? __fmul_rn(kq[j], al[j]) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        if (j0 - lane + 32 * u < padded) sum = __fadd_rn(sum, p[u]);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      const int i = row0 + lr * ks + rank;
      scores[(size_t)cls * n + i] = sum;
      if (c == 1) {   // one class: the label is this score's
        if (binary) static_cast<float*>(labels)[i] = sum > 0.0f ? 1.0f : (sum < 0.0f ? -1.0f : sum);
        else static_cast<int*>(labels)[i] = 0;
      }
    }
  }
  if (c == 1) return;

  // Each block's ticket for its row tile, its scores released by the block
  // barrier and thread 0's fence (fences are cumulative); the block that
  // takes the last of the C ks tickets labels the tile.
  __syncthreads();
  if (tid == 0) {
    fence_acq_rel();
    const unsigned t = atomicAdd(&tickets[blockIdx.x], 1u);
    last = t == (unsigned)(c * ks) - 1;
    if (last) tickets[blockIdx.x] = 0u;
    fence_acq_rel();
  }
  __syncthreads();
  if (!last) return;
  // the tile's scores, CH classes at a time, through the stage ring: one
  // round trip to L2 a pass; then a thread a row takes the first maximum
  constexpr int CH = (int)(RING / sizeof(float) / BM);
  float* const sc = reinterpret_cast<float*>(smem);
  float best = 0.0f;
  int arg = 0;
  for (int q0 = 0; q0 < c; q0 += CH) {
    const int cn = min(CH, c - q0);
    for (int e = tid; e < cn * rows; e += THREADS)
      sc[e] = __ldcg(&scores[(size_t)(q0 + e / rows) * n + row0 + e % rows]);
    __syncthreads();
    if (tid < rows) {
      for (int u = 0; u < cn; ++u) {
        const float v = sc[u * rows + tid];
        if (q0 + u == 0) best = v;
        else if (v > best || (v != v && best == best)) {
          best = v;
          arg = q0 + u;
        }
      }
    }
    __syncthreads();
  }
  if (tid < rows) static_cast<int*>(labels)[row0 + tid] = arg;
}

// Column tiles of bn a block (ct) and blocks a class (ks) for s slots.
inline void slices(int s, int bn, int* ct, int* ks) {
  const int tiles = (s + bn - 1) / bn;
  *ct = (tiles + MAX_CLUSTER - 1) / MAX_CLUSTER;
  *ks = (tiles + *ct - 1) / *ct;
}

template <int BM, int BN, int TM, int TN, int BK, int STAGES, typename TX, typename TY, bool VEC>
cudaError_t launch_cell(const void* x, const void* bank, const float* alpha, float* scores,
                        void* labels, unsigned* tickets, int n, int c, int s, int d,
                        float gamma, int binary, cudaStream_t stream) {
  using S = Shape<BM, BN, TM, TN, BK, STAGES>;
  int ct, ks;
  slices(s, BN, &ct, &ks);
  const size_t smem = S::smem(ks, s, sizeof(TX), sizeof(TY));
  if (smem > SMEM_LIMIT || (long long)c * ks > 65535) return cudaErrorInvalidValue;
  auto kernel = class_scores_cell<BM, BN, TM, TN, BK, STAGES, TX, TY, VEC>;
  // the kernel's attributes, set at its first launch on each card: all the
  // shared memory a block may have; clusters above 8 blocks
  static std::atomic<unsigned long long> ready{0};   // a bit a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(ready.load() & bit)) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_LIMIT);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    ready.fetch_or(bit);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((n + BM - 1) / BM), (unsigned)(c * ks), 1);
  cfg.blockDim = dim3((unsigned)S::THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = (unsigned)ks;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const TX*>(x), static_cast<const TY*>(bank),
                            alpha, scores, labels, tickets, n, c, s, d, ct, gamma, binary);
}

// The tiles: (id, BM, BN, TM, TN, BK, STAGES); the id is CELL_RULE's.
#define CELL_TILES(X)        \
  X(8, 8, 64, 4, 1, 64, 4)   \
  X(16, 16, 64, 4, 2, 64, 4) \
  X(32, 32, 64, 8, 2, 32, 4) \
  X(64, 64, 64, 8, 4, 32, 3)
// The tile the rule takes for n rows, from a sweep of tile shapes on an H100
// at C = 10, s = 508, d = 780 and n = 8, 16, ..., 256.  Up to 128 rows the
// 32-row tile (a grid of 64-row tiles, 80 or 160 blocks, loads the card's
// 132 SMs unevenly), above that 64.
#define CELL_RULE(n) ((n) <= 8 ? 8 : (n) <= 16 ? 16 : (n) <= 128 ? 32 : 64)

// BM of tile ``id``; 0 if no such tile.
inline int cell_rows(int id) {
#define CELL_ROWS(ID, BM, BN, TM, TN, BK, ST) \
  if (id == ID) return BM;
  CELL_TILES(CELL_ROWS)
#undef CELL_ROWS
  return 0;
}

// The dynamic shared memory of tile ``id`` at s slots and the operands'
// element bytes.
inline size_t cell_smem(int id, int s, int x_elem, int y_elem) {
#define CELL_SMEM(ID, BM, BN, TM, TN, BK, ST)                          \
  if (id == ID) {                                                      \
    int ct, ks;                                                        \
    slices(s, BN, &ct, &ks);                                           \
    return Shape<BM, BN, TM, TN, BK, ST>::smem(ks, s, x_elem, y_elem); \
  }
  CELL_TILES(CELL_SMEM)
#undef CELL_SMEM
  return 0;
}

// The tile the rule takes for n rows, s slots and the operands' element
// bytes: CELL_RULE's, or the next smaller one that fits shared memory; 0 if
// none does.
inline int rule_tile(int n, int s, int x_elem, int y_elem) {
  int best = 0;
  const int want = cell_rows(CELL_RULE(n));
#define CELL_FIT(ID, BM, BN, TM, TN, BK, ST)                         \
  if (BM <= want && BM > cell_rows(best)                             \
      && cell_smem(ID, s, x_elem, y_elem) <= SMEM_LIMIT)             \
    best = ID;
  CELL_TILES(CELL_FIT)
#undef CELL_FIT
  return best;
}

template <typename TX, typename TY, bool VEC>
cudaError_t launch(int id, const void* x, const void* bank, const float* alpha, float* scores,
                   void* labels, unsigned* tickets, int n, int c, int s, int d, float gamma,
                   int binary, cudaStream_t stream) {
#define CELL_LAUNCH(ID, BM, BN, TM, TN, BK, ST)                                               \
  if (id == ID)                                                                               \
    return launch_cell<BM, BN, TM, TN, BK, ST, TX, TY, VEC>(x, bank, alpha, scores, labels,   \
                                                            tickets, n, c, s, d, gamma, binary, \
                                                            stream);
  CELL_TILES(CELL_LAUNCH)
#undef CELL_LAUNCH
  return cudaErrorInvalidValue;
}

template <typename TX, typename TY>
cudaError_t launch_types(int id, bool vec, const void* x, const void* bank, const float* alpha,
                         float* scores, void* labels, unsigned* tickets, int n, int c, int s,
                         int d, float gamma, int binary, cudaStream_t stream) {
  return vec ? launch<TX, TY, true>(id, x, bank, alpha, scores, labels, tickets, n, c, s, d,
                                    gamma, binary, stream)
             : launch<TX, TY, false>(id, x, bank, alpha, scores, labels, tickets, n, c, s, d,
                                     gamma, binary, stream);
}

}  // namespace

// x: (n, d), bank: (C * s, d), each fp32 or bf16 (x_bf16 / bank_bf16), row-major
// and contiguous; alpha: (C, s) fp32; scores: (C, n) fp32; labels: (n,) int32
// class ids, or fp32 signs when binary (C must then be 1); tickets: at least
// ceil(n / 8) zeros, left zero (one set a stream).  Returns the launch's
// error.
extern "C" int class_scores_launch(const void* x, int x_bf16, const void* bank, int bank_bf16,
                                   const void* alpha, void* scores, void* labels, void* tickets,
                                   int n, int c, int s, int d, float gamma, int binary,
                                   void* stream) {
  if (n <= 0) return 0;
  if (c <= 0 || s <= 0 || d < 0 || (binary && c != 1)) return (int)cudaErrorInvalidValue;
  const int id = rule_tile(n, s, x_bf16 ? 2 : 4, bank_bf16 ? 2 : 4);
  if (cell_rows(id) == 0) return (int)cudaErrorInvalidValue;
  // four elements a copy where every row starts aligned to it
  const uintptr_t align = (uintptr_t)x | (uintptr_t)bank;
  const bool vec = d % 4 == 0 && align % (x_bf16 && bank_bf16 ? 8 : 16) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(alpha);
  float* sp = static_cast<float*>(scores);
  unsigned* tp = static_cast<unsigned*>(tickets);
  cudaError_t e;
  if (x_bf16 && bank_bf16)
    e = launch_types<__nv_bfloat16, __nv_bfloat16>(id, vec, x, bank, ap, sp, labels, tp, n, c, s,
                                                   d, gamma, binary, st);
  else if (x_bf16)
    e = launch_types<__nv_bfloat16, float>(id, vec, x, bank, ap, sp, labels, tp, n, c, s, d,
                                           gamma, binary, st);
  else if (bank_bf16)
    e = launch_types<float, __nv_bfloat16>(id, vec, x, bank, ap, sp, labels, tp, n, c, s, d,
                                           gamma, binary, st);
  else
    e = launch_types<float, float>(id, vec, x, bank, ap, sp, labels, tp, n, c, s, d, gamma,
                                   binary, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

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
// What bounds it on the H100 is the chain of count x rounds dependent
// coordinates, not the card's bandwidth: (rounds + 1) count^2 x 4 bytes is
// ~3 MB (~0.9 us at 3.35 TB/s) at count = 500, rounds = 2.  The earlier
// design walked that chain with the whole block in lockstep, a block-wide
// barrier and a shared-memory round trip on every coordinate (~245 ns each,
// PERF.md).  This one is a blocked sweep.  One block a class (grid = C);
// warp 0 is the chain warp and owns no columns of f, the other warps (the
// bulk) own them all.  The coordinates go in blocks of B = 32, one a lane:
//
//  - chain: lane l holds f_{i0+l} (every earlier block's deltas applied),
//    b_{i0+l} and column l of the diagonal sub-block k[i0..i0+31][i0+l] in
//    registers.  For k = 0 .. nb - 1 every lane computes its candidate step
//    from its own margin, __shfl_sync hands lane k's to all, and if
//    coordinate k is live each lane adds its product to its margin.  No
//    barrier sits inside the chain; the live mask comes from one ballot.
//    A link is one shuffle and six dependent fp32 operations (~50 cycles).
//  - bulk: the bulk warps apply a block's deltas, in k order, to every
//    column they own (the block's own too: their copies stay authoritative
//    and the chain warp's are thrown away) and publish the next block's
//    margins.
//
// Every column still receives the products d_i k[i][j] of exactly the live
// coordinates i, each rounded alone, in ascending i: the bits are the
// earlier design's and the plain version's.  The clip is max.NaN/min.NaN,
// so a NaN x stays NaN (the card's arithmetic returns its canonical NaN
// either way).  count is read on the card, so a step needs no host read
// and can be captured in a CUDA graph.
//
// One SM reads each class's cache (rounds + 1) times, ~1 MB each at s ~
// 500, so at s <= 512 (bdca_ascent_staged, every path's shape) the rows go
// through shared memory by bulk copies (TMA) into three buffers: the
// initial f = b @ k streams every row, and in the sweep block g + 1's rows
// land while block g runs.  The bulk applies block g - 1's deltas while the
// chain warp runs block g, and the chain warp carries the next block's
// margins itself (the bulk's, then its own block's deltas from the rows it
// already has), so the chain waits for the bulk at one barrier a block.
// Above 512 slots (bdca_ascent_wide, tests and rare shapes) the simple form:
// rows read from L2, two barriers a block.
//
// Two measurement probes sit beside it (not on any path; chip_smoke.py
// reads them): the chain warp alone over the same coordinates, with clock64
// around its chain, and the dependent latency of an fp32 add, a shuffle and
// a max.NaN on this card.  bdca_ascent_staged's bulk copies read up to 12
// bytes before a block of rows, inside the cache's own 16-byte-aligned
// allocation.
#include <cuda_runtime.h>

namespace {

constexpr int B = 32;                 // coordinates a block of the chain: one a lane
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_THREADS = 32 + 512;  // the chain warp and at most 16 bulk warps

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(arrivals)
               : "memory");
}
// wait until the fill of `bar` with this parity has landed
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// the bulk threads' own barrier (named barrier 1), the chain warp not in it
__device__ __forceinline__ void bulk_sync(int bulk_threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(bulk_threads) : "memory");
}

// x with its sign flipped when `flip` (bit 0), exactly: a sign is y = +-1
__device__ __forceinline__ float flip_sign(float x, unsigned flip) {
  return __int_as_float(__float_as_int(x) ^ (int)((flip & 1u) << 31));
}

struct Block {
  int i0, nb;
};

// block `mi` of a sweep: coordinates from mi * B
__device__ __forceinline__ Block block_at(int mi, int n) {
  const int i0 = mi * B;
  return {i0, min(B, n - i0)};
}

// Rows [j0, j0 + r) of a class's cache, contiguous in memory, into `buf` by
// one bulk copy (TMA) from the 16-byte boundary at or before their start
// (so row j0 begins at buf[row_shift]); the last < 16 bytes by plain loads.
// Called by one thread; `bar` (count 1) completes when all of it landed.
__device__ __forceinline__ int row_shift(const float* k, int s, int j0) {
  return (int)(((size_t)(k + (size_t)j0 * s) & 15) >> 2);
}
__device__ __forceinline__ void load_rows(float* buf, const float* __restrict__ k, int s, int j0,
                                          int r, unsigned long long* bar) {
  const float* first = k + (size_t)j0 * s;
  const float* end = first + (size_t)r * s;
  const size_t a0 = (size_t)first & ~(size_t)15, a1 = (size_t)end & ~(size_t)15;
  float* tail = buf + (a1 - a0) / 4;
  for (const float* q = reinterpret_cast<const float*>(a1); q < end; ++q)
    tail[q - reinterpret_cast<const float*>(a1)] = *q;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"((unsigned)(a1 - a0))
               : "memory");
  if (a1 > a0)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_u32(buf)),
        "l"(a0), "r"((unsigned)(a1 - a0)), "r"(smem_u32(bar))
        : "memory");
}

// The chain warp copies the diagonal sub-block k[i0..i0+nb)[i0..i0+nb) into
// a tile, row-major with stride B (lane l its column l), asynchronously.
__device__ __forceinline__ void stage_diag(float* tile, const float* __restrict__ k, int s,
                                           Block b) {
  const int lane = threadIdx.x & 31;
  if (lane < b.nb)
    for (int q = 0; q < b.nb; ++q)
      cp_async4(tile + q * B + lane, k + (size_t)(b.i0 + q) * s + b.i0 + lane);
  cp_async_commit();
}

// The chain over one block of coordinates on one warp, in the margins'
// signed form: lane l carries h_l = y_l f_l (exact: y = +-1), so that
//   x = (|b| + 1) - h,  a = clip(x, 0, C),  e = a - |b|
// and coordinate k moves lane l's margin by e_k (y_k y_l k[i0+k][i0+l]),
// which is y_l times d_k k[i0+k][i0+l] with d_k = y_k a - b_k, rounded alike
// (rounding to nearest is symmetric in sign).  So x, a and every d_k are
// the plain version's bits; a coordinate that is not live adds nothing (a
// predicated add: no branch in the chain).  FULL: nb = 32, no bound check.
template <bool FULL_BLOCK>
__device__ __forceinline__ void chain(float h, float ab, float ab1, const float (&kp)[B], int nb,
                                      unsigned live, float cap, float& a_out) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < B; ++k) {
    if (!FULL_BLOCK && k >= nb) break;
    const float x = __fsub_rn(ab1, h);
    float a;   // clip(x, 0, C); a NaN x stays NaN
    asm("max.NaN.f32 %0, %1, 0f00000000;\n\tmin.NaN.f32 %0, %0, %2;" : "=f"(a) : "f"(x), "f"(cap));
    const float e = __fsub_rn(a, ab);
    if (lane == k) a_out = a;
    const float p = __fmul_rn(__shfl_sync(FULL, e, k), kp[k]);
    if (live >> k & 1u) h = __fadd_rn(h, p);
  }
}

// Block b on the chain warp: gather (this lane's margin fl, coefficients
// from src, the diagonal sub-block from diag[q * stride + lane]), run the
// chain, write b' to dst and the deltas d_k = y_k a_k - b_k (0 where
// frozen) to d_list.  Returns the live mask (bit k: coordinate i0 + k).
// `spent`, where given, gathers the clock64 cycles of the chain loop alone.
__device__ __forceinline__ unsigned chain_block(float fl, const float* src, float* dst,
                                                float* d_list, const float* diag, int stride,
                                                Block b, float cap,
                                                long long* spent = nullptr) {
  // every pointer here is into shared memory: indices stay 32-bit
  const int lane = threadIdx.x & 31;
  const bool mine = lane < b.nb;
  const float bl = mine ? src[b.i0 + lane] : 0.0f;
  const unsigned live = __ballot_sync(FULL, bl != 0.0f);   // bl is 0 past nb
  const unsigned neg = __ballot_sync(FULL, bl < 0.0f);
  const unsigned my_neg = neg >> lane;
  float kp[B];
#pragma unroll
  for (int q = 0; q < B; ++q)   // past nb: whatever is there, never used
    kp[q] = flip_sign(diag[q * stride + lane], (neg >> q) ^ my_neg);
  const float ab = fabsf(bl);
  const float ab1 = __fadd_rn(ab, 1.0f);
  float a = 0.0f;
  const float h = flip_sign(fl, my_neg);
  long long t0 = 0;
  if (spent) asm volatile("mov.u64 %0, %%clock64;" : "=l"(t0), "+f"(a)::"memory");
  if (b.nb == B)
    chain<true>(h, ab, ab1, kp, B, live, cap, a);
  else
    chain<false>(h, ab, ab1, kp, b.nb, live, cap, a);
  if (spent) {
    long long t1;
    asm volatile("mov.u64 %0, %%clock64;" : "=l"(t1), "+f"(a)::"memory");
    *spent += t1 - t0;
  }
  if (mine) {
    const bool is_live = live >> lane & 1u;
    const float y = (float)((0.0f < bl) - (bl < 0.0f));
    const float bn = is_live ? __fmul_rn(y, a) : bl;
    dst[b.i0 + lane] = bn;
    d_list[lane] = is_live ? __fsub_rn(bn, bl) : 0.0f;
  }
  return live;
}

// acc plus the products d[kk] row[kk] of the live kk, in kk order
__device__ __forceinline__ float apply_deltas(float acc, const float (&d)[B],
                                              const float (&row)[B], unsigned live) {
#pragma unroll
  for (int kk = 0; kk < B; ++kk) {
    const float p = __fmul_rn(d[kk], row[kk]);
    if (live >> kk & 1u) acc = __fadd_rn(acc, p);
  }
  return acc;
}

// floats of one staged block of rows: B rows and the 16-byte realignment
__host__ __device__ constexpr int staged_floats(int s) { return (B * s + 7) & ~3; }
constexpr int NBUF = 3;   // staged buffers: block g - 1 (bulk), g (chain), g + 1 (landing)

// s <= 512: one column a bulk thread, the cache rows through shared memory.
//
// Fills: the initial pass's m blocks of rows, then the sweep's blocks,
// fill F into buffer F % 3 (its (F / 3)-th fill); a fill is issued once the
// one three before it is read by everyone.  Block g of the sweep is fill
// m + g: the chain warp runs it in iteration g while the bulk applies block
// g - 1's deltas and block g + 1's rows land.  The chain warp carries block
// g + 1's margins itself: the bulk publishes them with every delta up to
// block g - 1 (an mbarrier, `pub`), and the chain warp adds block g's, in k
// order, from the off-diagonal rows it already has.  So the chain waits for
// the bulk only at one barrier a block, and the bulk's work runs beside the
// next chain.
__global__ void __launch_bounds__(MAX_THREADS, 1)
bdca_ascent_staged(float* __restrict__ alpha, const float* __restrict__ kmat,
                   const int* __restrict__ count, int s, float cap, int rounds) {
  extern __shared__ __align__(128) float smem[];
  __shared__ unsigned long long bars[NBUF];     // fill landed, one a buffer
  __shared__ unsigned long long pub;            // the next block's margins are out
  __shared__ float f_pub[2][B];                 // block g + 1's margins, slot (g + 1) & 1
  __shared__ __align__(16) float d_list[2][B];  // block g's deltas, slot g & 1
  __shared__ unsigned live_sh[2];
  const int T = blockDim.x, t = threadIdx.x;
  const bool chain_warp = t < 32, producer = t == 32;
  const int tb = t - 32, Tb = T - 32;           // bulk thread index (its column) and count
  const int lane = t & 31;
  float* al = alpha + (size_t)blockIdx.x * s;
  const float* k = kmat + (size_t)blockIdx.x * s * s;
  int n = count[blockIdx.x];
  n = n < 0 ? 0 : (n > s ? s : n);
  const int sf = staged_floats(s);              // buffer b: smem + b * sf
  float* src = smem + NBUF * sf;                // b as the sweep found it
  float* dst = src + s;                         // b as the sweep leaves it

  if (t == 0) {
    for (int b = 0; b < NBUF; ++b) mbar_init(&bars[b], 1);
    mbar_init(&pub, 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int j = t; j < s; j += T) src[j] = j < n ? al[j] : 0.0f;
  __syncthreads();

  const int m = (n + B - 1) / B;   // blocks a sweep; blocks of rows in the initial pass
  const int blocks = rounds * m;
  // fill F: rows of the initial pass's block F, or of the sweep's block F - m
  auto issue = [&](int F) {
    const Block r = block_at(F < m ? F : (F - m) % m, n);
    load_rows(smem + (F % NBUF) * sf, k, s, r.i0, r.nb, &bars[F % NBUF]);
  };
  auto landed = [&](int F) { mbar_wait(&bars[F % NBUF], (unsigned)(F / NBUF) & 1u); };
  auto rows_of = [&](int F, int i0) { return smem + (F % NBUF) * sf + row_shift(k, s, i0); };
  const int last_early = blocks > 0 ? m : m - 1;   // fills issued before the sweep

  float f = 0.0f;                  // the bulk thread's column of f
  if (!chain_warp) {
    // f = b @ k: ascending j, a product rounded, then added
    if (producer)
      for (int F = 0; F < NBUF && F <= last_early; ++F) issue(F);
    for (int ti = 0; ti < m; ++ti) {
      const int j0 = ti * B, nr = min(B, n - j0);
      landed(ti);
      if (tb < n) {
        const float* rp = rows_of(ti, j0) + tb;
        if (nr == B) {
          float kv[B], bv[B];
#pragma unroll
          for (int u = 0; u < B; ++u) {
            kv[u] = rp[u * s];
            bv[u] = src[j0 + u];
          }
#pragma unroll
          for (int u = 0; u < B; ++u) f = __fadd_rn(f, __fmul_rn(bv[u], kv[u]));
        } else {
          for (int u = 0; u < nr; ++u) f = __fadd_rn(f, __fmul_rn(src[j0 + u], rp[u * s]));
        }
      }
      bulk_sync(Tb);               // every bulk thread is done with this buffer
      if (producer && ti + NBUF <= last_early) issue(ti + NBUF);
    }
    if (blocks > 0 && tb < B) f_pub[0][tb] = f;   // block 0's margins (tb < n: f set)
  }
  __syncthreads();

  float fn = 0.0f;                 // chain warp: lane's margin of the block it runs next
  Block prev{0, 0};
  for (int g = 0, mi = 0; g < blocks; ++g) {
    const Block cur = block_at(mi, n);
    mi = mi + 1 == m ? 0 : mi + 1;              // the next block, in this sweep or the next
    const Block next = block_at(mi, n);
    const bool more = g + 1 < blocks;
    if (chain_warp) {
      landed(m + g);
      const float* rows = rows_of(m + g, cur.i0);
      const unsigned live = chain_block(g == 0 ? f_pub[0][lane] : fn, src, dst, d_list[g & 1],
                                        rows + cur.i0, s, cur, cap);
      if (lane == 0) live_sh[g & 1] = live;
      if (more) {
        // block g + 1's margins: the bulk's (every delta to block g - 1), then
        // block g's deltas in k order, each product rounded, then added
        __syncwarp();
        mbar_wait(&pub, (unsigned)g & 1u);
        const bool mine = lane < next.nb;
        float v = mine ? f_pub[(g + 1) & 1][lane] : 0.0f;
        const float* col = rows + (mine ? next.i0 + lane : 0);
#pragma unroll
        for (int kk = 0; kk < B; ++kk) {
          const float p = __fmul_rn(d_list[g & 1][kk], col[kk * s]);
          if (live >> kk & 1u) v = __fadd_rn(v, p);
        }
        fn = v;
      }
    } else {
      if (producer && more) issue(m + g + 1);    // lands while this block runs
      if (g > 0) {                               // block g - 1's deltas on every column
        landed(m + g - 1);
        if (tb < n) {
          const float* rows = rows_of(m + g - 1, prev.i0) + tb;
          float d[B], row[B];
#pragma unroll
          for (int kk = 0; kk < B; ++kk) {
            d[kk] = d_list[(g - 1) & 1][kk];
            row[kk] = rows[kk * s];               // past nb: not live
          }
          f = apply_deltas(f, d, row, live_sh[(g - 1) & 1]);
        }
      }
      if (more && tb >= next.i0 && tb < next.i0 + B) {   // the warp that owns block g + 1
        if (tb < next.i0 + next.nb) f_pub[(g + 1) & 1][tb - next.i0] = f;
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(&pub))
                     : "memory");
      }
    }
    __syncthreads();               // block g's deltas are out; block g - 1's are applied
    prev = cur;
    if (mi == 0) {                 // a sweep ends
      float* tmp = src;
      src = dst;
      dst = tmp;
    }
  }

  for (int j = t; j < s; j += T) al[j] = j < n ? src[j] : 0.0f;
}

// s > 512: NQ columns of f a bulk thread (strided by the bulk's size).  The
// simple blocked sweep: the chain warp copies each diagonal sub-block by
// cp.async, a block ahead; the bulk loads a block's rows from L2 after the
// barrier, applies its deltas and publishes the next block's margins; two
// barriers a block.  The initial pass loads 32 / NQ rows ahead a thread.
template <int NQ>
__global__ void __launch_bounds__(MAX_THREADS, 1)
bdca_ascent_wide(float* __restrict__ alpha, const float* __restrict__ kmat,
                 const int* __restrict__ count, int s, float cap, int rounds) {
  constexpr int R = 32 / NQ > 0 ? 32 / NQ : 1;
  extern __shared__ float smem[];
  __shared__ float tiles[2][B * B];             // diagonal sub-blocks, by g & 1
  __shared__ float f_pub[B];                    // the next block's margins
  __shared__ __align__(16) float d_list[B];     // the block's deltas, in k order
  __shared__ unsigned live_sh;
  const int T = blockDim.x, t = threadIdx.x;
  const bool chain_warp = t < 32;
  const int tb = t - 32, Tb = T - 32, lane = t & 31;
  float* al = alpha + (size_t)blockIdx.x * s;
  const float* k = kmat + (size_t)blockIdx.x * s * s;
  int n = count[blockIdx.x];
  n = n < 0 ? 0 : (n > s ? s : n);
  float* src = smem;
  float* dst = smem + s;

  for (int j = t; j < s; j += T) src[j] = j < n ? al[j] : 0.0f;
  __syncthreads();

  const int m = (n + B - 1) / B;
  const int blocks = rounds * m;
  const Block first = block_at(0, n);
  float f[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) f[q] = 0.0f;
  if (chain_warp) {
    if (blocks > 0) stage_diag(tiles[0], k, s, first);
  } else {
    for (int j0 = 0; j0 < n; j0 += R) {
      float kv[R][NQ];
#pragma unroll
      for (int u = 0; u < R; ++u)
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int col = tb + q * Tb;
          kv[u][q] = j0 + u < n && col < n ? k[(size_t)(j0 + u) * s + col] : 0.0f;
        }
#pragma unroll
      for (int u = 0; u < R; ++u) {
        if (j0 + u >= n) break;
        const float bj = src[j0 + u];
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          if (tb + q * Tb < n) f[q] = __fadd_rn(f[q], __fmul_rn(bj, kv[u][q]));
      }
    }
    if (blocks > 0) {
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int at = tb + q * Tb - first.i0;
        if (at >= 0 && at < first.nb) f_pub[at] = f[q];
      }
    }
  }
  __syncthreads();

  for (int g = 0, mi = 0; g < blocks; ++g) {
    const Block cur = block_at(mi, n);
    mi = mi + 1 == m ? 0 : mi + 1;
    const Block next = block_at(mi, n);
    const bool more = g + 1 < blocks;
    if (chain_warp) {
      cp_async_wait_all();
      __syncwarp();
      if (more) stage_diag(tiles[(g + 1) & 1], k, s, next);
      const unsigned live = chain_block(lane < cur.nb ? f_pub[lane] : 0.0f, src, dst, d_list,
                                        tiles[g & 1], B, cur, cap);
      if (t == 0) live_sh = live;
    }
    __syncthreads();                            // the chain's deltas are in d_list
    if (!chain_warp) {
      const unsigned live = live_sh;            // bit kk set only below nb
      float d[B];
#pragma unroll
      for (int kk = 0; kk < B; ++kk) d[kk] = d_list[kk];
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int col = tb + q * Tb;
        if (col >= n) continue;
        float row[B];
#pragma unroll
        for (int kk = 0; kk < B; ++kk)
          row[kk] = kk < cur.nb ? k[(size_t)(cur.i0 + kk) * s + col] : 0.0f;
        f[q] = apply_deltas(f[q], d, row, live);
      }
      if (more) {
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int at = tb + q * Tb - next.i0;
          if (at >= 0 && at < next.nb) f_pub[at] = f[q];
        }
      }
    }
    __syncthreads();                            // the next block's margins are out
    if (mi == 0) {
      float* tmp = src;
      src = dst;
      dst = tmp;
    }
  }

  for (int j = t; j < s; j += T) al[j] = j < n ? src[j] : 0.0f;
}

// The chain warp alone (grid = C, one warp): the same blocks, gathers and
// chains over the same coordinates, every block's margins read from a zeroed
// array that no bulk updates (its alpha means nothing); cycles[c] gets the
// clock64 cycles of the class's whole chain, cycles[C + c] those of its
// chain loops alone (no gather, no copies).
__global__ void __launch_bounds__(32)
bdca_chain_probe_kernel(float* __restrict__ alpha, const float* __restrict__ kmat,
                        const int* __restrict__ count, int s, float cap, int rounds,
                        long long* __restrict__ cycles) {
  extern __shared__ float smem[];
  __shared__ float tiles[2][B * B];
  __shared__ float d_list[B];
  const int lane = threadIdx.x;
  float* al = alpha + (size_t)blockIdx.x * s;
  const float* k = kmat + (size_t)blockIdx.x * s * s;
  int n = count[blockIdx.x];
  n = n < 0 ? 0 : (n > s ? s : n);
  float* src = smem;
  float* dst = smem + s;
  float* fz = smem + 2 * s;
  for (int j = lane; j < s; j += 32) {
    src[j] = j < n ? al[j] : 0.0f;
    fz[j] = 0.0f;
  }
  __syncwarp();
  const int m = (n + B - 1) / B;
  const int blocks = rounds * m;
  if (blocks > 0) stage_diag(tiles[0], k, s, block_at(0, n));
  long long in_chain = 0, t0;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t0)::"memory");
  for (int g = 0, mi = 0; g < blocks; ++g) {
    const Block cur = block_at(mi, n);
    mi = mi + 1 == m ? 0 : mi + 1;
    cp_async_wait_all();
    __syncwarp();
    if (g + 1 < blocks) stage_diag(tiles[(g + 1) & 1], k, s, block_at(mi, n));
    chain_block(lane < cur.nb ? fz[cur.i0 + lane] : 0.0f, src, dst, d_list, tiles[g & 1], B, cur,
                cap, &in_chain);
    __syncwarp();
    if (mi == 0) {
      float* tmp = src;
      src = dst;
      dst = tmp;
    }
  }
  long long t1;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t1)::"memory");
  for (int j = lane; j < s; j += 32) al[j] = j < n ? src[j] : 0.0f;
  if (lane == 0) {
    cycles[blockIdx.x] = t1 - t0;
    cycles[gridDim.x + blockIdx.x] = in_chain;
  }
}

// clock64 cycles of 256 dependent fp32 adds (out[0]), 256 dependent
// __shfl_sync (out[1]) and 256 dependent max.NaN (out[2], the clip's) on
// one warp.
__global__ void __launch_bounds__(32) bdca_latency_probe_kernel(float w, long long* out,
                                                                float* sink) {
  constexpr int N = 256;
  const int lane = threadIdx.x;
  float v = (float)lane;
  long long t0, t1, t2;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t0), "+f"(v)::"memory");
#pragma unroll
  for (int i = 0; i < N; ++i) v = __fadd_rn(v, w);
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t1), "+f"(v)::"memory");
#pragma unroll
  for (int i = 0; i < N; ++i) v = __shfl_sync(FULL, v, (lane + 1) & 31);
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t2), "+f"(v)::"memory");
#pragma unroll
  for (int i = 0; i < N; ++i) asm("max.NaN.f32 %0, %0, %1;" : "+f"(v) : "f"(w));
  long long t3;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t3), "+f"(v)::"memory");
  sink[lane] = v;
  if (lane == 0) {
    out[0] = t1 - t0;
    out[1] = t2 - t1;
    out[2] = t3 - t2;
  }
}

template <typename K>
int launch(K* kernel, float* alpha, const float* kmat, const int* count, int c, int s, float cap,
           int rounds, int threads, size_t smem, cudaStream_t st) {
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<c, threads, smem, st>>>(alpha, kmat, count, s, cap, rounds);
  return (int)cudaGetLastError();
}

}  // namespace

// alpha: (c, s) fp32, updated in place; kmat: (c, s, s) fp32; count: (c,)
// int32.  All row-major and contiguous; s <= 16,384.  The launch geometry
// comes from kernels/bdca.py `geometry`: nq columns a bulk thread (1, 2, 4,
// 8 or 32), threads = 32 + the bulk threads (at most 544), nq x bulk >= s,
// and b twice in dynamic shared memory, with three staged blocks of rows at
// nq = 1.  Returns the launch's error.
extern "C" int bdca_ascent_launch(void* alpha, const void* kmat, const void* count, int c, int s,
                                  float cap, int rounds, int nq, int threads, void* stream) {
  if (c <= 0) return 0;
  if (s <= 0 || s > 16 * 1024 || rounds < 0 || threads <= 32 || threads > MAX_THREADS ||
      threads % 32 != 0 || (long long)nq * (threads - 32) < s)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(alpha);
  const float* k = static_cast<const float*>(kmat);
  const int* n = static_cast<const int*>(count);
  const size_t smem =
      ((nq == 1 ? NBUF * (size_t)staged_floats(s) : 0) + 2 * (size_t)s) * sizeof(float);
  switch (nq) {
    case 1: return launch(bdca_ascent_staged, a, k, n, c, s, cap, rounds, threads, smem, st);
    case 2: return launch(bdca_ascent_wide<2>, a, k, n, c, s, cap, rounds, threads, smem, st);
    case 4: return launch(bdca_ascent_wide<4>, a, k, n, c, s, cap, rounds, threads, smem, st);
    case 8: return launch(bdca_ascent_wide<8>, a, k, n, c, s, cap, rounds, threads, smem, st);
    case 32: return launch(bdca_ascent_wide<32>, a, k, n, c, s, cap, rounds, threads, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The chain warp alone on the same arguments (alpha overwritten with what
// it means nothing); cycles: (2, c) int64, each class's whole chain and its
// chain loops alone, in clock64 cycles.
extern "C" int bdca_chain_probe_launch(void* alpha, const void* kmat, const void* count, int c,
                                       int s, float cap, int rounds, void* cycles,
                                       void* stream) {
  if (c <= 0) return 0;
  if (s <= 0 || s > 16 * 1024 || rounds < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 3 * (size_t)s * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        bdca_chain_probe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  bdca_chain_probe_kernel<<<c, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(alpha), static_cast<const float*>(kmat),
      static_cast<const int*>(count), s, cap, rounds, static_cast<long long*>(cycles));
  return (int)cudaGetLastError();
}

// out: 3 int64 (the add, shuffle and max.NaN chains' cycles, 256 links
// each); sink: 32 fp32 the chains leave behind.
extern "C" int bdca_latency_probe_launch(void* out, void* sink, void* stream) {
  bdca_latency_probe_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      1.0f, static_cast<long long*>(out), static_cast<float*>(sink));
  return (int)cudaGetLastError();
}

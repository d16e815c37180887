// One whole BSGD training step per class, in place: margin rows, Pegasos
// shrink and violator insert with the kernel-cache insert, then batch_size
// masked maintenance event rounds.
//
// Replaces the TPU kernel src/repro/kernels/train_step.py::train_step_pallas
// (bodies _train_step_kernel, _insert_body, _multi_merge_body, and
// merge_event._merge_event_body for the merge rounds).  Each class c is one
// thread-block cluster of K blocks of 256 threads (cluster.cuh: block r owns
// a range of the S slots and of the D features), on the class's slice of the
// stacked state (sv (S, D) fp32 or bf16, alpha (S,), the cache km (S, S)
// fp32, the counters).  Every block keeps a copy of the class's alpha in
// shared memory, applies the same updates to it and writes its own range
// back at the end.
//   1. margin rows k(xb_i, sv_j) = exp(-gamma max(|x|^2 + |sv|^2 - 2 x.sv, 0))
//      for the B batch rows (staged in every block's shared memory eight
//      rows at a time; the chunk's row count is a template argument) against
//      the block's own slots: one warp per SV row, the lanes striding over D
//      and reading the row once a chunk (four loads in flight), the chunk's
//      dot products and the row's norm kept in registers and summed by a
//      butterfly, the epilogue rbf_from_sums (rbf_epilogue.cuh, shared with
//      rbf_kernel.cu, whose thin path sums in the same order); each block
//      keeps its slots' margin rows in its shared memory;
//   2. f_i = k_i . alpha over the active slots (one warp per batch row, in
//      every block, the other blocks' margin rows read through distributed
//      shared memory in the same lane order) and margin_i = y_i f_i; eta =
//      1 / (lambda t) and the shrink 1 - eta lambda rounded once through a
//      double product, as core.bsgd.insert_from_rows does; every violator
//      (margin < 1) goes to the watermark in batch order with alpha = eta y /
//      B, its SV row (bf16 rounded to nearest), and the cache rows, then
//      columns, then diagonal of kernel_cache.insert_rows, with the
//      new-vs-new block from k_bb, each block its own slots and features;
//   3. B rounds, each a no-op unless count > budget: under "merge" the event
//      of merge_event_body.cuh (the merge_event kernels' own body); under
//      "multi-merge" multi_merge_body below, up to P disjoint same-sign pairs
//      retired in one event;
//   4. count, n_inserts and n_merges (+1 per round run) written back by rank
//      0; the caller owns step + 1.
//
// What bounds it on the H100: at C = 10, S = 508, D = 780, B = 8 in fp32 the
// margin reads the 15.8 MB bank once (about 4.7 us at 3.35 TB/s) for 63
// MFLOP (about 0.9 us at 67 TFLOP/s in fp32), and the insert and events touch
// ~2 MB of cache rows, so the step is bytes-bound at about 5 us.  A class's
// 1 MB cache and 1.58 MB bank do not fit the 227 KB of shared memory, so both
// stay in device memory, updated in place (the whole stacked state, ~26 MB at
// C = 10, fits the 50 MB L2).  One block a class left 122 of 132 SMs idle at
// C = 10 and 131 at C = 1, its warps waiting on one row's loads at a time: K
// blocks a class put K times the warps on the margin rows, and every slot
// loop of an event runs over S / K slots a block; what is left of an event
// round is a chain of cluster argmins and barriers.  The TPU kernel's
// one-hot matmul gathers, hat-basis lookups, lower-triangular cumsum and
// 128-lane padding are TPU idioms and are not carried over.
//
// Exactness: compiled with -fmad=false, expf/logf without fast math, no
// atomics, first-occurrence argmins (exact in any reduction order); every
// float is computed by one thread in the plain version's order of operations
// (repro_torch.kernels.ref.train_step_fused), whatever K, so every K writes
// the same bits.  The one place where kernel and plain version may part is
// the margins' summation order, a near-tie of the insert rule.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "merge_event_body.cuh"
#include "multi_merge_choice.cuh"
#include "rbf_epilogue.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROW_CHUNK = 8;   // batch rows whose dot products a lane keeps at once
constexpr int LOADS = 4;       // SV row loads a lane keeps in flight

// The multi-merge event's per-pair scalars and lists, in shared memory: the
// choice (multi_merge_choice.cuh), this block's local top-p, and what the
// update needs after the choice.  The same in every block of a cluster.
// The lists are P long, in dynamic shared memory (carve_scratch).
struct PairScratch : PairChoice {
  float *top_v, *h, *a_z, *lk_ab;
  int *top_i, *dst, *src, *holes;
  int n_mv;
};

// Bytes of PairScratch's lists for P pairs (a multiple of 16).
__host__ __device__ constexpr size_t scratch_bytes(int p) {
  return pair_choice_bytes(p) + (size_t)8 * p * 4;
}

// Points sc's lists into ``base`` (scratch_bytes(p) bytes of shared memory).
// One thread calls it, before a barrier and any use.
__device__ void carve_scratch(PairScratch& sc, char* base, int p) {
  carve_pairs(sc, base, p);
  float* f = reinterpret_cast<float*>(base + pair_choice_bytes(p));
  sc.top_v = f;
  sc.h = f + p;
  sc.a_z = f + 2 * p;
  sc.lk_ab = f + 3 * p;
  int* w = reinterpret_cast<int*>(f + 4 * p);
  sc.top_i = w;
  sc.dst = w + p;
  sc.src = w + 2 * p;
  sc.holes = w + 3 * p;
}

// One multi-merge event on a class that is over budget: the restatement of
// core.budget._multi_merge_once with the cache (oracle kernels.ref
// .multi_merge_event), run by the class's cluster.  al: the block's copy of
// alpha; buf: 3 * p * pt.cs floats of shared memory (this block's range of
// the pairs' cache rows and scores).  Returns the new count.
template <typename TS>
__device__ int multi_merge_body(const Part& pt, TS* sv, float* al, float* km, int cnt,
                                int budget, int p, const float* __restrict__ h_table,
                                const float* __restrict__ wd_table, int g0, int g1, int s,
                                int d, float* buf, PairScratch& sc, Reduce& rd, int& ph) {
  const int tid = threadIdx.x, nt = blockDim.x, cs = pt.cs;
  const int n_loc = pt.hi - pt.lo;
  float* rows_a = buf;               // (p, cs) km[a_k]: the kappa rows
  float* rows_b = buf + p * cs;      // (p, cs) km[b_k] of the merging pairs
  float* wd = buf + 2 * p * cs;      // (p, cs) scores; later the moved rows

  // 1. the p smallest |alpha| among the active slots, first index on ties
  //    (top_k's order): each block's own p smallest (p block argmins), then
  //    the p smallest of the cluster's K lists, picked by warp 0 of every block
  for (int k = 0; k < p; ++k) {
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int q = pt.lo + tid; q < pt.hi; q += nt) {
      bool chosen = false;
      for (int r = 0; r < k; ++r) chosen |= sc.top_i[r] == q;
      const float v = q < cnt && !chosen ? fabsf(al[q]) : INFINITY;
      if (better(v, q, bv, bi)) { bv = v; bi = q; }
    }
    float mv;
    int mi;
    cluster_argmin(pt, false, rd, ph, bv, bi, &mv, &mi);
    if (tid == 0) {
      sc.top_v[k] = mv;
      sc.top_i[k] = mi;
    }
    __syncthreads();
  }
  part_sync(pt);
  if (tid < 32) {
    const int lane = tid;
    for (int k = 0; k < p; ++k) {
      float bv = INFINITY;
      int bi = INT_MAX;
      for (int e = lane; e < pt.k * p; e += 32) {
        const int r = e / p, t = e - r * p;
        const float v = at_rank(pt, sc.top_v, r)[t];
        const int i = at_rank(pt, sc.top_i, r)[t];
        bool chosen = false;
        for (int x = 0; x < k; ++x) chosen |= sc.a[x] == i;
        if (!chosen && better(v, i, bv, bi)) { bv = v; bi = i; }
      }
      warp_argmin(bv, bi);
      if (lane == 0) {
        sc.a[k] = bi;
        sc.a_min[k] = al[bi];
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // 2. this block's range of the kappa rows; 3. its candidates' Lookup-WD
  // scores; 4. the greedy disjoint choice, one cluster argmin a pair
  for (int e = tid; e < p * n_loc; e += nt) {
    const int k = e / n_loc, l = e - k * n_loc;
    rows_a[k * cs + l] = ld_state(km + (size_t)sc.a[k] * s + pt.lo + l);
  }
  score_pairs(pt, rows_a, al, cnt, p, sc, wd_table, g0, g1, wd);
  greedy_choice(pt, wd, p, cnt - budget, sc, rd, ph);

  // 5. per pair: h from the h table at the winner, a_z, log k(a, b)
  for (int k = tid; k < p; k += nt) {
    const int bk = sc.b[k];
    const float a_min = sc.a_min[k], ab = al[bk], kab = slot_entry(pt, rows_a, k, bk);
    int off;
    float du, dv;
    lookup_coords(merge_m(a_min, ab), clip01(kab), g0, g1, &off, &du, &dv);
    const float h = corner_mix(h_table, off, g1, du, dv);
    const float u = 1.0f - h;
    const float lk = safe_log(clip01(kab));
    sc.h[k] = h;
    sc.a_z[k] = a_min * expf((u * u) * lk) + ab * expf((h * h) * lk);
    sc.lk_ab[k] = safe_log(kab);
  }
  // the partners' rows over this block's range, staged before any write
  for (int e = tid; e < p * n_loc; e += nt) {
    const int k = e / n_loc, l = e - k * n_loc;
    if (sc.merged[k]) rows_b[k * cs + l] = ld_state(km + (size_t)sc.b[k] * s + pt.lo + l);
  }
  __syncthreads();

  // z_k's cache row in log space at slot q (kernel_cache's merge identity,
  // clamped at 0), from the rows staged by q's owner
  auto lz = [&](int k, int q) {
    const float h = sc.h[k];
    return fminf(h * safe_log(slot_entry(pt, rows_a, k, q))
                     + (1.0f - h) * safe_log(slot_entry(pt, rows_b, k, q))
                     - (h * (1.0f - h)) * sc.lk_ab[k],
                 0.0f);
  };
  // k(z_i, z_j): the identity applied to z_i's row at a_j and b_j
  auto cross = [&](int i, int j) {
    const float h = sc.h[j];
    return expf(fminf(h * lz(i, sc.a[j]) + (1.0f - h) * lz(i, sc.b[j])
                          - (h * (1.0f - h)) * sc.lk_ab[j],
                      0.0f));
  };
  // z rows, then columns, then the symmetrized (P, P) block with its
  // diagonal 1 (entry (a_i, a_j) by a_i's owner, which wrote its column)
  for (int e = tid; e < p * n_loc; e += nt) {
    const int k = e / n_loc, l = e - k * n_loc;
    if (sc.merged[k]) km[(size_t)sc.a[k] * s + pt.lo + l] = expf(lz(k, pt.lo + l));
  }
  part_sync(pt);
  for (int e = tid; e < p * n_loc; e += nt) {
    const int k = e / n_loc, l = e - k * n_loc;
    if (sc.merged[k]) km[(size_t)(pt.lo + l) * s + sc.a[k]] = expf(lz(k, pt.lo + l));
  }
  __syncthreads();
  for (int e = tid; e < p * p; e += nt) {
    const int i = e / p, j = e % p;
    const int ai = sc.a[i];
    if (sc.merged[i] && sc.merged[j] && ai >= pt.lo && ai < pt.hi)
      km[(size_t)ai * s + sc.a[j]] = i == j ? 1.0f : 0.5f * (cross(i, j) + cross(j, i));
  }
  // z = h x_a + (1 - h) x_b into slot a (the merging pairs' slots are
  // disjoint), this block's features
  for (int e = pt.f_lo + tid; e < pt.f_hi; e += nt)
    for (int k = 0; k < p; ++k)
      if (sc.merged[k]) {
        const float h = sc.h[k];
        const float z = h * to_f32(ld_state(sv + (size_t)sc.a[k] * d + e))
                        + (1.0f - h) * to_f32(ld_state(sv + (size_t)sc.b[k] * d + e));
        sv[(size_t)sc.a[k] * d + e] = from_f32<TS>(z);
      }
  const int new_cnt = cnt - sc.n_exec;
  if (tid == 0) {
    for (int k = 0; k < p; ++k)
      if (sc.merged[k]) al[sc.a[k]] = sc.a_z[k];
    // 6. targeted-move compaction: the k-th hole below the new watermark
    //    takes the k-th surviving slot above it (both ascending)
    int* holes = sc.holes;
    int n_holes = 0;
    for (int k = 0; k < p; ++k)
      if (sc.executed[k]) holes[n_holes++] = sc.merged[k] ? sc.b[k] : sc.a[k];
    for (int i = 1; i < n_holes; ++i)            // insertion sort, ascending
      for (int j = i; j > 0 && holes[j - 1] > holes[j]; --j) {
        const int t = holes[j];
        holes[j] = holes[j - 1];
        holes[j - 1] = t;
      }
    int n_dst = 0, n_src = 0;
    for (int k = 0; k < n_holes; ++k)
      if (holes[k] < new_cnt) sc.dst[n_dst++] = holes[k];
    for (int q = new_cnt; q < cnt; ++q) {
      bool hole = false;
      for (int k = 0; k < n_holes; ++k) hole |= holes[k] == q;
      if (!hole && n_src < p) sc.src[n_src++] = q;
    }
    sc.n_mv = min(n_dst, n_src);
  }
  // the moved rows, read after every block's z writes
  part_sync(pt);
  const int n_mv = sc.n_mv;
  float* moved = wd;   // (n_mv, cs), this block's range
  for (int e = tid; e < n_mv * n_loc; e += nt) {
    const int k = e / n_loc, l = e - k * n_loc;
    moved[k * cs + l] = ld_state(km + (size_t)sc.src[k] * s + pt.lo + l);
    km[(size_t)sc.dst[k] * s + pt.lo + l] = moved[k * cs + l];
  }
  part_sync(pt);
  for (int e = tid; e < n_mv * n_loc; e += nt) {
    const int k = e / n_loc, l = e - k * n_loc;
    km[(size_t)(pt.lo + l) * s + sc.dst[k]] = moved[k * cs + l];
  }
  __syncthreads();
  for (int e = tid; e < n_mv * n_mv; e += nt) {
    const int i = e / n_mv, j = e % n_mv;
    const int di = sc.dst[i];
    if (di >= pt.lo && di < pt.hi)
      km[(size_t)di * s + sc.dst[j]] = slot_entry(pt, moved, i, sc.src[j]);
  }
  const int nf = pt.f_hi - pt.f_lo;   // sources lie above new_cnt, holes below
  for (int e = tid; e < n_mv * nf; e += nt) {
    const int k = e / nf, f = pt.f_lo + e - k * nf;
    sv[(size_t)sc.dst[k] * d + f] = ld_state(sv + (size_t)sc.src[k] * d + f);
  }
  if (tid == 0)
    for (int k = 0; k < n_mv; ++k) al[sc.dst[k]] = al[sc.src[k]];
  __syncthreads();
  for (int q = new_cnt + tid; q < s; q += nt) al[q] = 0.0f;
  __syncthreads();
  return new_cnt;
}

// The margin rows k(xb_i, sv_j) of batch rows [i0, i0 + NR), staged in xs
// with their norms in xn, against this block's slots, into kb: one warp per
// SV row, the lanes striding over D (LOADS loads in flight), NR dot
// products and the row's norm in registers, one butterfly each, the
// epilogue rbf_from_sums.  NR is a template argument: a row count known
// only at run time would put a predicate on every product of the unrolled
// loop (PERF.md: the step's device time fell by a quarter without it).
template <int NR, typename TS>
__device__ __forceinline__ void margin_rows(const Part& pt, const TS* sv, const float* xs,
                                            const float* xn, float* kb, int i0, int d,
                                            float gamma) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, n_warps = blockDim.x / 32;
  for (int j = pt.lo + warp; j < pt.hi; j += n_warps) {
    const TS* row = sv + (size_t)j * d;
    float yn = 0.0f;
    float xy[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) xy[r] = 0.0f;
    for (int e0 = lane; e0 < d; e0 += LOADS * 32) {
      float v[LOADS];
#pragma unroll
      for (int t = 0; t < LOADS; ++t) {
        const int e = e0 + t * 32;
        v[t] = e < d ? to_f32(ld_state(row + e)) : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < LOADS; ++t) {
        const int e = e0 + t * 32;
        if (e < d) {
          yn = fmaf(v[t], v[t], yn);
#pragma unroll
          for (int r = 0; r < NR; ++r) xy[r] = fmaf(xs[r * d + e], v[t], xy[r]);
        }
      }
    }
    yn = warp_sum(yn);
#pragma unroll
    for (int r = 0; r < NR; ++r) {
      const float dot = warp_sum(xy[r]);
      if (lane == 0)
        kb[(size_t)(i0 + r) * pt.cs + (j - pt.lo)] = rbf_from_sums(xn[i0 + r], yn, dot, gamma);
    }
  }
}

template <typename TS>
__global__ void __launch_bounds__(THREADS) train_step_kernel(
    TS* sv_x, float* alpha, float* kmat, int* count, const int* __restrict__ step,
    int* n_inserts, int* n_merges, const float* __restrict__ xb, const float* __restrict__ yb,
    const float* __restrict__ k_bb, const float* __restrict__ h_table,
    const float* __restrict__ wd_table, int g0, int g1, int s, int d, int b, int budget,
    float lambda, float gamma, int multi, int p, int k) {
  extern __shared__ float4 smem_ts[];
  __shared__ Reduce rd;
  __shared__ PairScratch sc;
  __shared__ float shrink_s;
  __shared__ int n_new_s;
  const Part pt = make_part(k, s, d);
  const int c = blockIdx.x / k, tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, n_warps = nt / 32;
  const int cs = pt.cs;
  TS* sv = sv_x + (size_t)c * s * d;
  float* km = kmat + (size_t)c * s * s;
  const float* y = yb + (size_t)c * b;
  int cnt = count[c];
  int ph = 0;

  // the multi-merge pair lists, then alpha and the phases' buffers
  char* scratch = reinterpret_cast<char*>(smem_ts);
  float* al = reinterpret_cast<float*>(scratch + (multi ? scratch_bytes(p) : 0));   // (s,)
  float* xs = al + s;                  // (ROW_CHUNK, d) a chunk of the minibatch rows
  float* kb = xs + (size_t)min(b, ROW_CHUNK) * d;   // (b, cs) k(xb_i, sv_j), this block's slots
  float* xn = kb + (size_t)b * cs;     // (b,) |xb_i|^2
  float* new_a = xn + b;               // (b,) margins, then the inserted alphas
  int* pos = reinterpret_cast<int*>(new_a + b);   // (b,) target slots, s = none
  if (multi && tid == 0) carve_scratch(sc, scratch, p);
  for (int q = tid; q < s; q += nt) al[q] = ld_state(alpha + (size_t)c * s + q);

  // 1. margin rows of this block's slots, the minibatch staged ROW_CHUNK
  // rows at a time (a lane's features in the same order for every chunk)
  for (int i0 = 0; i0 < b; i0 += ROW_CHUNK) {
    const int nr = min(ROW_CHUNK, b - i0);
    __syncthreads();   // the previous chunk's rows are read
    for (int e = tid; e < nr * d; e += nt) xs[e] = xb[(size_t)i0 * d + e];
    __syncthreads();
    for (int i = warp; i < nr; i += n_warps) {
      float acc = 0.0f;
      for (int e = lane; e < d; e += 32) acc = fmaf(xs[i * d + e], xs[i * d + e], acc);
      acc = warp_sum(acc);
      if (lane == 0) xn[i0 + i] = acc;
    }
    __syncthreads();
    switch (nr) {   // the row count as a template argument: no predicate in the loop
      case 1: margin_rows<1>(pt, sv, xs, xn, kb, i0, d, gamma); break;
      case 2: margin_rows<2>(pt, sv, xs, xn, kb, i0, d, gamma); break;
      case 3: margin_rows<3>(pt, sv, xs, xn, kb, i0, d, gamma); break;
      case 4: margin_rows<4>(pt, sv, xs, xn, kb, i0, d, gamma); break;
      case 5: margin_rows<5>(pt, sv, xs, xn, kb, i0, d, gamma); break;
      case 6: margin_rows<6>(pt, sv, xs, xn, kb, i0, d, gamma); break;
      case 7: margin_rows<7>(pt, sv, xs, xn, kb, i0, d, gamma); break;
      default: margin_rows<ROW_CHUNK>(pt, sv, xs, xn, kb, i0, d, gamma); break;
    }
  }
  part_sync(pt);   // every block's margin rows are readable cluster-wide

  // 2. margins over the active slots (the same in every block), then the
  // shrink and the insert
  for (int i = warp; i < b; i += n_warps) {
    float acc = 0.0f;
    for (int j0 = lane; j0 < s; j0 += LOADS * 32) {
      float kv[LOADS], av[LOADS];
#pragma unroll
      for (int t = 0; t < LOADS; ++t) {
        const int j = j0 + t * 32;
        kv[t] = j < s ? slot_entry(pt, kb, i, j) : 0.0f;
        av[t] = j < s && j < cnt ? al[j] : 0.0f;
      }
#pragma unroll
      for (int t = 0; t < LOADS; ++t)
        if (j0 + t * 32 < s) acc += kv[t] * av[t];
    }
    acc = warp_sum(acc);
    if (lane == 0) new_a[i] = y[i] * acc;
  }
  __syncthreads();
  if (tid == 0) {
    const float eta = 1.0f / (lambda * (float)step[c]);
    int n_new = 0;
    for (int i = 0; i < b; ++i) {
      const bool viol = new_a[i] < 1.0f;
      pos[i] = viol ? min(cnt + n_new, s) : s;   // a slot past the bank drops
      new_a[i] = (eta * y[i]) / (float)b;
      n_new += viol ? 1 : 0;
    }
    shrink_s = (float)(1.0 - (double)eta * (double)lambda);
    n_new_s = n_new;
  }
  __syncthreads();
  const float shrink = shrink_s;
  for (int q = tid; q < s; q += nt) {
    int hit = -1;
    for (int i = 0; i < b && hit < 0; ++i) hit = pos[i] == q ? i : -1;
    al[q] = hit >= 0 ? new_a[hit] : al[q] * shrink;
  }
  // the cache row of batch row i at slot q of this block: its margin row,
  // with the new-vs-new block k_bb at the inserted slots
  auto ins_row = [&](int i, int q) {
    for (int x = 0; x < b; ++x)
      if (pos[x] == q) return k_bb[i * b + x];
    return kb[(size_t)i * cs + (q - pt.lo)];
  };
  for (int i = 0; i < b; ++i) {
    if (pos[i] >= s) continue;
    for (int e = pt.f_lo + tid; e < pt.f_hi; e += nt)
      sv[(size_t)pos[i] * d + e] = from_f32<TS>(xb[(size_t)i * d + e]);
    for (int q = pt.lo + tid; q < pt.hi; q += nt) km[(size_t)pos[i] * s + q] = ins_row(i, q);
  }
  part_sync(pt);
  for (int i = 0; i < b; ++i)
    if (pos[i] < s)
      for (int q = pt.lo + tid; q < pt.hi; q += nt) km[(size_t)q * s + pos[i]] = ins_row(i, q);
  __syncthreads();
  for (int i = tid; i < b; i += nt)
    if (pos[i] >= pt.lo && pos[i] < pt.hi) km[(size_t)pos[i] * s + pos[i]] = 1.0f;
  cnt += n_new_s;
  const int n_ins = n_inserts[c] + n_new_s;
  __syncthreads();

  // 3. the event rounds: a class at or under budget skips them all.  Their
  // first cluster barrier orders the insert's writes before any read.
  int n_mrg = n_merges[c];
  float* buf = al + s;   // the margin phase's buffers are no longer read
  for (int r = 0; r < b && cnt > budget; ++r) {
    if (multi) {
      cnt = multi_merge_body(pt, sv, al, km, cnt, budget, p, h_table, wd_table, g0, g1, s, d,
                             buf, sc, rd, ph);
    } else {
      merge_event_body(pt, sv, al, km, cnt, h_table, wd_table, g0, g1, s, d, buf, rd, ph,
                       static_cast<int*>(nullptr));
      cnt -= 1;
    }
    n_mrg += 1;
    __syncthreads();
  }
  for (int q = pt.lo + tid; q < pt.hi; q += nt) alpha[(size_t)c * s + q] = al[q];
  part_sync(pt);   // no block leaves while another may read its shared memory
  if (pt.rank == 0 && tid == 0) {
    count[c] = cnt;
    n_inserts[c] = n_ins;
    n_merges[c] = n_mrg;
  }
}

// Dynamic shared memory of one block with clusters of k, in bytes: the
// multi-merge pair lists, the copy of alpha, then the margin phase's chunk
// of minibatch rows, margin rows and per-row scalars, or the event phase's
// rows, whichever is larger (the phases reuse one buffer).
size_t smem_bytes(int s, int d, int b, int multi, int p, int k) {
  const size_t cs = (size_t)((s + k - 1) / k);
  const size_t rows = (size_t)(b < ROW_CHUNK ? b : ROW_CHUNK);   // a chunk of the minibatch
  const size_t insert = rows * d + (size_t)b * cs + 3 * (size_t)b;
  const size_t event = multi ? 3 * (size_t)p * cs : 3 * cs;
  return (multi ? scratch_bytes(p) : 0)
         + ((size_t)s + (insert > event ? insert : event)) * sizeof(float);
}

}  // namespace

// Shared memory one block needs with clusters of k, dynamic and static, in
// bytes; -1 if the kernel's attributes cannot be read.
extern "C" long long train_step_smem_bytes(int s, int d, int b, int multi, int p, int k) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, train_step_kernel<float>) != cudaSuccess) return -1;
  return (long long)smem_bytes(s, d, b, multi, p, k) + (long long)attr.sharedSizeBytes;
}

// How many clusters of k blocks the card keeps resident at once for this
// shape (cudaOccupancyMaxActiveClusters); 0 if it refuses clusters of k,
// -error on another failure.
extern "C" int train_step_max_clusters(int k, int sv_bf16, int c, int s, int d, int b,
                                       int multi, int p) {
  const size_t smem = smem_bytes(s, d, b, multi, p, k);
  if (sv_bf16) return max_active_clusters(train_step_kernel<__nv_bfloat16>, c, k, THREADS, smem);
  return max_active_clusters(train_step_kernel<float>, c, k, THREADS, smem);
}

// sv_x: (C, s, d) fp32 (sv_bf16 = 0) or bf16 (sv_bf16 = 1); alpha: (C, s)
// fp32; kmat: (C, s, s) fp32; count, step, n_inserts, n_merges: (C,) int32;
// xb: (b, d) fp32; yb: (C, b) fp32; k_bb: (b, b) fp32; h_table, wd_table:
// (g0, g1) fp32.  sv_x, alpha, kmat, count, n_inserts and n_merges are
// updated in place.  multi: 0 = merge rounds, 1 = multi-merge rounds of p
// pairs; k: blocks a class (one cluster).  Returns the launch's error, or
// cudaGetLastError() after it.
extern "C" int train_step_launch(void* sv_x, int sv_bf16, void* alpha, void* kmat, void* count,
                                 const void* step, void* n_inserts, void* n_merges,
                                 const void* xb, const void* yb, const void* k_bb,
                                 const void* h_table, const void* wd_table, int g0, int g1,
                                 int c, int s, int d, int b, int budget, float lambda,
                                 float gamma, int multi, int p, int k, void* stream) {
  if (p < 1 || k < 1 || k > 16) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(s, d, b, multi, p, k);
  auto launch = [&](auto* sv, auto kernel) {
    cudaError_t e = cluster_prepare(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = cluster_config(c, k, THREADS, smem, stream, &attr);
    e = cudaLaunchKernelEx(&cfg, kernel, sv, static_cast<float*>(alpha),
                           static_cast<float*>(kmat), static_cast<int*>(count),
                           static_cast<const int*>(step), static_cast<int*>(n_inserts),
                           static_cast<int*>(n_merges), static_cast<const float*>(xb),
                           static_cast<const float*>(yb), static_cast<const float*>(k_bb),
                           static_cast<const float*>(h_table),
                           static_cast<const float*>(wd_table), g0, g1, s, d, b, budget, lambda,
                           gamma, multi, p, k);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  };
  if (sv_bf16) return launch(static_cast<__nv_bfloat16*>(sv_x), train_step_kernel<__nv_bfloat16>);
  return launch(static_cast<float*>(sv_x), train_step_kernel<float>);
}

// One whole BSGD training step per class, in place: margin rows, Pegasos
// shrink and violator insert with the kernel-cache insert, then batch_size
// masked maintenance event rounds.
//
// Replaces the TPU kernel src/repro/kernels/train_step.py::train_step_pallas
// (bodies _train_step_kernel, _insert_body, _multi_merge_body, and
// merge_event._merge_event_body for the merge rounds).  One block of 256
// threads per class c runs, on its slice of the stacked state (sv (S, D) fp32
// or bf16, alpha (S,), the cache km (S, S) fp32, the counters):
//   1. margin rows k(xb_i, sv_j) = exp(-gamma max(|x|^2 + |sv|^2 - 2 x.sv, 0))
//      for the B batch rows (staged in shared memory) against all S slots: one
//      warp per SV row, the lanes striding over D and reading the row once,
//      the B dot products and the row's norm kept in registers and summed by
//      a butterfly, the epilogue rbf_from_sums (rbf_epilogue.cuh, shared with
//      rbf_kernel.cu, whose thin path sums in the same order);
//   2. f_i = k_i . alpha over the active slots (one warp per batch row) and
//      margin_i = y_i f_i; eta = 1 / (lambda t) and the shrink 1 - eta lambda
//      rounded once through a double product, as core.bsgd.insert_from_rows
//      does; every violator (margin < 1) goes to the watermark in batch order
//      with alpha = eta y / B, its SV row (bf16 rounded to nearest), and the
//      cache rows, then columns, then diagonal of kernel_cache.insert_rows,
//      with the new-vs-new block from k_bb;
//   3. B rounds, each a no-op unless count > budget: under "merge" the event
//      of merge_event_body.cuh (the merge_event kernel's own body); under
//      "multi-merge" multi_merge_body below, up to P disjoint same-sign pairs
//      retired in one event;
//   4. count, n_inserts and n_merges (+1 per round run) written back; the
//      caller owns step + 1.
//
// What bounds it on the H100: at C = 10, S = 508, D = 780, B = 8 in fp32 the
// margin reads the 15.8 MB bank once (about 4.7 us at 3.35 TB/s) for 63
// MFLOP (about 0.9 us at 67 TFLOP/s in fp32), and the insert and events touch
// ~2 MB of cache rows, so the step is bytes-bound at about 5 us.  The design
// does not come near that: a class's 1 MB cache and 1.58 MB bank do not fit
// the 227 KB of shared memory, so both stay in device memory, updated in
// place (the whole stacked state, ~26 MB at C = 10, fits the 50 MB L2, so the
// re-reads within a step should hit it); and there is one block per class,
// so only C of the 132 SMs have work (10 on the class axis, 1 for a binary
// problem), each running a chain of block reductions.  Splitting a class's
// margin rows and scoring over several blocks is later work.  The TPU
// kernel's one-hot matmul gathers, hat-basis lookups, lower-triangular cumsum
// and 128-lane padding are TPU idioms and are not carried over.
//
// Exactness: compiled with -fmad=false, expf/logf without fast math, no
// atomics, first-occurrence argmins; the plain version's order of operations
// (repro_torch.kernels.ref.train_step_fused).  The one place where the two
// may part is the margins' summation order, a near-tie of the insert rule.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "merge_event_body.cuh"
#include "multi_merge_choice.cuh"
#include "rbf_epilogue.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROW_CHUNK = 8;   // batch rows whose dot products a lane keeps at once

// The multi-merge event's per-pair scalars and lists, in shared memory: the
// choice (multi_merge_choice.cuh) and what the update needs after it.
struct PairScratch : PairChoice {
  int dst[MAX_P], src[MAX_P];
  float h[MAX_P], a_z[MAX_P], lk_ab[MAX_P];
  int n_mv;
};

// One multi-merge event on a class that is over budget: the restatement of
// core.budget._multi_merge_once with the cache (oracle kernels.ref
// .multi_merge_event).  buf: 3 * p * s floats of shared memory.  Returns the
// new count.
template <typename TS>
__device__ int multi_merge_body(TS* sv, float* al, float* km, int cnt, int budget, int p,
                                const float* __restrict__ h_table,
                                const float* __restrict__ wd_table, int g0, int g1, int s,
                                int d, float* buf, PairScratch& sc, float* red_v, int* red_i) {
  const int tid = threadIdx.x, nt = blockDim.x;
  float* rows_a = buf;              // (p, s) km[a_k]: the kappa rows
  float* rows_b = buf + p * s;      // (p, s) km[b_k] of the merging pairs
  float* wd = buf + 2 * p * s;      // (p, s) scores; later the moved rows

  // 1. the p smallest |alpha| among the active slots, first index on ties
  //    (top_k's order): p masked block argmins
  for (int k = 0; k < p; ++k) {
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int q = tid; q < s; q += nt) {
      bool chosen = false;
      for (int r = 0; r < k; ++r) chosen |= sc.a[r] == q;
      const float v = q < cnt && !chosen ? fabsf(al[q]) : INFINITY;
      if (better(v, q, bv, bi)) { bv = v; bi = q; }
    }
    float unused;
    int ak;
    block_argmin(bv, bi, red_v, red_i, &unused, &ak);
    if (tid == 0) {
      sc.a[k] = ak;
      sc.a_min[k] = al[ak];
    }
    __syncthreads();
  }

  // 2. the kappa rows from the cache; 3. every candidate's Lookup-WD score;
  // 4. the greedy disjoint choice (multi_merge_choice.cuh)
  for (int e = tid; e < p * s; e += nt) rows_a[e] = km[(size_t)sc.a[e / s] * s + e % s];
  __syncthreads();
  score_pairs(rows_a, al, cnt, p, s, sc, wd_table, g0, g1, wd);
  greedy_choice(wd, p, s, cnt - budget, sc, red_v, red_i);

  // 5. per pair: h from the h table at the winner, a_z, log k(a, b)
  for (int k = tid; k < p; k += nt) {
    const int bk = sc.b[k];
    const float a_min = sc.a_min[k], ab = al[bk], kab = rows_a[k * s + bk];
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
  // the partners' rows, staged before any write
  for (int e = tid; e < p * s; e += nt)
    if (sc.merged[e / s]) rows_b[e] = km[(size_t)sc.b[e / s] * s + e % s];
  __syncthreads();

  // z_k's cache row in log space (kernel_cache's merge identity, clamped at 0)
  auto lz = [&](int k, int q) {
    const float h = sc.h[k];
    return fminf(h * safe_log(rows_a[k * s + q]) + (1.0f - h) * safe_log(rows_b[k * s + q])
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
  // z rows, then columns, then the symmetrized (P, P) block with its diagonal 1
  for (int e = tid; e < p * s; e += nt)
    if (sc.merged[e / s]) km[(size_t)sc.a[e / s] * s + e % s] = expf(lz(e / s, e % s));
  __syncthreads();
  for (int e = tid; e < p * s; e += nt)
    if (sc.merged[e / s]) km[(size_t)(e % s) * s + sc.a[e / s]] = expf(lz(e / s, e % s));
  __syncthreads();
  for (int e = tid; e < p * p; e += nt) {
    const int i = e / p, j = e % p;
    if (sc.merged[i] && sc.merged[j])
      km[(size_t)sc.a[i] * s + sc.a[j]] = i == j ? 1.0f : 0.5f * (cross(i, j) + cross(j, i));
  }
  // z = h x_a + (1 - h) x_b into slot a (the merging pairs' slots are disjoint)
  for (int e = tid; e < d; e += nt)
    for (int k = 0; k < p; ++k)
      if (sc.merged[k]) {
        const float h = sc.h[k];
        const float z = h * to_f32(sv[(size_t)sc.a[k] * d + e])
                        + (1.0f - h) * to_f32(sv[(size_t)sc.b[k] * d + e]);
        sv[(size_t)sc.a[k] * d + e] = from_f32<TS>(z);
      }
  const int new_cnt = cnt - sc.n_exec;
  if (tid == 0) {
    for (int k = 0; k < p; ++k)
      if (sc.merged[k]) al[sc.a[k]] = sc.a_z[k];
    // 6. targeted-move compaction: the k-th hole below the new watermark
    //    takes the k-th surviving slot above it (both ascending)
    int holes[MAX_P];
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
  __syncthreads();
  // the moved rows, read after the z writes
  const int n_mv = sc.n_mv;
  float* moved = wd;
  for (int e = tid; e < n_mv * s; e += nt) moved[e] = km[(size_t)sc.src[e / s] * s + e % s];
  __syncthreads();
  for (int e = tid; e < n_mv * s; e += nt) km[(size_t)sc.dst[e / s] * s + e % s] = moved[e];
  __syncthreads();
  for (int e = tid; e < n_mv * s; e += nt) km[(size_t)(e % s) * s + sc.dst[e / s]] = moved[e];
  __syncthreads();
  for (int e = tid; e < n_mv * n_mv; e += nt) {
    const int i = e / n_mv, j = e % n_mv;
    km[(size_t)sc.dst[i] * s + sc.dst[j]] = moved[i * s + sc.src[j]];
  }
  for (int e = tid; e < n_mv * d; e += nt)   // sources lie above new_cnt, holes below
    sv[(size_t)sc.dst[e / d] * d + e % d] = sv[(size_t)sc.src[e / d] * d + e % d];
  if (tid == 0)
    for (int k = 0; k < n_mv; ++k) al[sc.dst[k]] = al[sc.src[k]];
  __syncthreads();
  for (int q = new_cnt + tid; q < s; q += nt) al[q] = 0.0f;
  __syncthreads();
  return new_cnt;
}

template <typename TS>
__global__ void __launch_bounds__(THREADS) train_step_kernel(
    TS* sv_x, float* alpha, float* kmat, int* count, const int* __restrict__ step,
    int* n_inserts, int* n_merges, const float* __restrict__ xb, const float* __restrict__ yb,
    const float* __restrict__ k_bb, const float* __restrict__ h_table,
    const float* __restrict__ wd_table, int g0, int g1, int s, int d, int b, int budget,
    float lambda, float gamma, int multi, int p) {
  extern __shared__ float smem[];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ PairScratch sc;
  __shared__ float shrink_s;
  __shared__ int n_new_s;
  const int c = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, n_warps = nt / 32;
  TS* sv = sv_x + (size_t)c * s * d;
  float* al = alpha + (size_t)c * s;
  float* km = kmat + (size_t)c * s * s;
  const float* y = yb + (size_t)c * b;
  int cnt = count[c];

  // 1. margin rows
  float* xs = smem;                    // (b, d) the minibatch
  float* kb = xs + (size_t)b * d;      // (b, s) k(xb_i, sv_j)
  float* xn = kb + (size_t)b * s;      // (b,) |xb_i|^2
  float* new_a = xn + b;               // (b,) margins, then the inserted alphas
  int* pos = reinterpret_cast<int*>(new_a + b);   // (b,) target slots, s = none
  for (int e = tid; e < b * d; e += nt) xs[e] = xb[e];
  __syncthreads();
  for (int i = warp; i < b; i += n_warps) {
    float acc = 0.0f;
    for (int k = lane; k < d; k += 32) acc = fmaf(xs[i * d + k], xs[i * d + k], acc);
    acc = warp_sum(acc);
    if (lane == 0) xn[i] = acc;
  }
  __syncthreads();
  for (int j = warp; j < s; j += n_warps) {
    const TS* row = sv + (size_t)j * d;
    float yn = 0.0f;
    for (int i0 = 0; i0 < b; i0 += ROW_CHUNK) {
      float xy[ROW_CHUNK];
#pragma unroll
      for (int r = 0; r < ROW_CHUNK; ++r) xy[r] = 0.0f;
      for (int k = lane; k < d; k += 32) {
        const float v = to_f32(row[k]);
        if (i0 == 0) yn = fmaf(v, v, yn);
#pragma unroll
        for (int r = 0; r < ROW_CHUNK; ++r)
          if (i0 + r < b) xy[r] = fmaf(xs[(i0 + r) * d + k], v, xy[r]);
      }
      if (i0 == 0) yn = warp_sum(yn);
#pragma unroll
      for (int r = 0; r < ROW_CHUNK; ++r) {
        const float dot = warp_sum(xy[r]);
        if (lane == 0 && i0 + r < b)
          kb[(size_t)(i0 + r) * s + j] = rbf_from_sums(xn[i0 + r], yn, dot, gamma);
      }
    }
  }
  __syncthreads();

  // 2. margins over the active slots, then the shrink and the insert
  for (int i = warp; i < b; i += n_warps) {
    float acc = 0.0f;
    for (int j = lane; j < s; j += 32) acc += kb[(size_t)i * s + j] * (j < cnt ? al[j] : 0.0f);
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
  // the cache row of batch row i: its margin row, with the new-vs-new block
  // k_bb at the inserted slots
  auto ins_row = [&](int i, int q) {
    for (int k = 0; k < b; ++k)
      if (pos[k] == q) return k_bb[i * b + k];
    return kb[(size_t)i * s + q];
  };
  for (int i = 0; i < b; ++i) {
    if (pos[i] >= s) continue;
    for (int e = tid; e < d; e += nt) sv[(size_t)pos[i] * d + e] = from_f32<TS>(xs[i * d + e]);
    for (int q = tid; q < s; q += nt) km[(size_t)pos[i] * s + q] = ins_row(i, q);
  }
  __syncthreads();
  for (int i = 0; i < b; ++i)
    if (pos[i] < s)
      for (int q = tid; q < s; q += nt) km[(size_t)q * s + pos[i]] = ins_row(i, q);
  __syncthreads();
  for (int i = tid; i < b; i += nt)
    if (pos[i] < s) km[(size_t)pos[i] * s + pos[i]] = 1.0f;
  cnt += n_new_s;
  const int n_ins = n_inserts[c] + n_new_s;
  __syncthreads();

  // 3. the event rounds: a class at or under budget skips them all
  int n_mrg = n_merges[c];
  for (int r = 0; r < b && cnt > budget; ++r) {
    if (multi) {
      cnt = multi_merge_body(sv, al, km, cnt, budget, p, h_table, wd_table, g0, g1, s, d, smem,
                             sc, red_v, red_i);
    } else {
      merge_event_body(sv, al, km, cnt, h_table, wd_table, g0, g1, s, d, smem, red_v, red_i,
                       static_cast<int*>(nullptr));
      cnt -= 1;
    }
    n_mrg += 1;
    __syncthreads();
  }
  if (tid == 0) {
    count[c] = cnt;
    n_inserts[c] = n_ins;
    n_merges[c] = n_mrg;
  }
}

// Dynamic shared memory of one block, in bytes: the margin phase's minibatch,
// margin rows and per-row scalars, or the event phase's rows, whichever is
// larger (the phases reuse one buffer).
size_t smem_bytes(int s, int d, int b, int multi, int p) {
  const size_t insert = ((size_t)b * d + (size_t)b * s + 3 * (size_t)b) * sizeof(float);
  const size_t event = (multi ? 3 * (size_t)p * s : 3 * (size_t)s) * sizeof(float);
  return insert > event ? insert : event;
}

}  // namespace

// Shared memory one block needs, dynamic and static, in bytes; -1 if the
// kernel's attributes cannot be read.
extern "C" long long train_step_smem_bytes(int s, int d, int b, int multi, int p) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, train_step_kernel<float>) != cudaSuccess) return -1;
  return (long long)smem_bytes(s, d, b, multi, p) + (long long)attr.sharedSizeBytes;
}

// sv_x: (C, s, d) fp32 (sv_bf16 = 0) or bf16 (sv_bf16 = 1); alpha: (C, s)
// fp32; kmat: (C, s, s) fp32; count, step, n_inserts, n_merges: (C,) int32;
// xb: (b, d) fp32; yb: (C, b) fp32; k_bb: (b, b) fp32; h_table, wd_table:
// (g0, g1) fp32.  sv_x, alpha, kmat, count, n_inserts and n_merges are
// updated in place.  multi: 0 = merge rounds, 1 = multi-merge rounds of p
// pairs.  Returns cudaGetLastError() (or the error of raising the
// shared-memory limit).
extern "C" int train_step_launch(void* sv_x, int sv_bf16, void* alpha, void* kmat, void* count,
                                 const void* step, void* n_inserts, void* n_merges,
                                 const void* xb, const void* yb, const void* k_bb,
                                 const void* h_table, const void* wd_table, int g0, int g1,
                                 int c, int s, int d, int b, int budget, float lambda,
                                 float gamma, int multi, int p, void* stream) {
  if (p > MAX_P) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(s, d, b, multi, p);
  auto launch = [&](auto* sv, auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<c, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        sv, static_cast<float*>(alpha), static_cast<float*>(kmat), static_cast<int*>(count),
        static_cast<const int*>(step), static_cast<int*>(n_inserts),
        static_cast<int*>(n_merges), static_cast<const float*>(xb),
        static_cast<const float*>(yb), static_cast<const float*>(k_bb),
        static_cast<const float*>(h_table), static_cast<const float*>(wd_table), g0, g1, s, d,
        b, budget, lambda, gamma, multi, p);
    return (int)cudaGetLastError();
  };
  if (sv_bf16) return launch(static_cast<__nv_bfloat16*>(sv_x), train_step_kernel<__nv_bfloat16>);
  return launch(static_cast<float*>(sv_x), train_step_kernel<float>);
}

// One whole Lookup-WD merge event on one class's slice of the stacked state,
// run by one thread block: the body of merge_event.cu's kernel (one event per
// over-budget class) and of train_step.cu's merge rounds, so both run the
// same event.  On the slice (sv (S, D), alpha (S,), the kernel cache km
// (S, S)) with cnt active slots:
//   1. i_min = the active (slot < cnt) argmin of |alpha|, first on ties;
//   2. the kappa row is km[i_min] (the cache is symmetric);
//   3. every candidate j is scored from the WD_norm table:
//        wd_j = (a_min + alpha_j)^2 * bilinear(m_j, kap_j), 3.4e38 unless j is
//        active, of a_min's sign and not i_min;
//   4. j_star = argmin wd, first on ties; no partner (wd >= 1e30) means removal;
//   5. h from the h table at j_star, a_z = a_min k^((1-h)^2) + a_j k^(h^2),
//      z = h x_i + (1-h) x_j in fp32, and z's cache row by the log-space
//      combine of rows i_min and j_star (core.kernel_cache);
//   6. two cache rows, then (after a barrier) the same two columns: slot
//      t1 = lo (merge) or i_min (removal) takes z's row (or the old last's),
//      slot t2 = hi takes the old last's row; columns go last so the
//      intersections take the reference's values;
//   7. sv and alpha rows t1, t2, and alpha[last] = 0 (thread 0).
// The caller owns cnt -= 1 and the barrier before anything reads the slice
// again.  The arithmetic follows the plain version
// (repro_torch.kernels.ref.merge_event) operation by operation; files that
// include this are compiled with -fmad=false and use expf/logf without fast
// math, so the decisions are the plain version's.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "lookup.cuh"
#include "block_argmin.cuh"

namespace {

constexpr float KAPPA_MIN = 1e-30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float safe_log(float k) {
  return logf(fminf(fmaxf(k, KAPPA_MIN), 1.0f));
}

// rows: 3 * s floats of shared memory (the three cache rows the event reads,
// so the updates never read what they have just written); red_v/red_i: 32
// entries each.  decision, when not null, receives (i_min, j_star, merged).
// The state pointers carry no __restrict__: other threads of the block write
// them between the reads.
template <typename TS>
__device__ void merge_event_body(TS* sv, float* al, float* km, int cnt,
                                 const float* __restrict__ h_table,
                                 const float* __restrict__ wd_table, int g0, int g1, int s,
                                 int d, float* rows, float* red_v, int* red_i, int* decision) {
  float* kap_row = rows;          // km[i_min]
  float* row_j = rows + s;        // km[j_star]
  float* row_last = rows + 2 * s; // km[last]
  const int last = cnt - 1;
  const int tid = threadIdx.x, nt = blockDim.x;

  // 1. fixed partner
  float bv = INFINITY;
  int bi = INT_MAX;
  for (int q = tid; q < s; q += nt) {
    const float v = q < cnt ? fabsf(al[q]) : INFINITY;
    if (better(v, q, bv, bi)) { bv = v; bi = q; }
  }
  float unused;
  int i_min;
  block_argmin(bv, bi, red_v, red_i, &unused, &i_min);
  const float a_min = al[i_min];

  // 2. kappa row from the cache
  for (int q = tid; q < s; q += nt) kap_row[q] = km[(size_t)i_min * s + q];
  __syncthreads();

  // 3. score every candidate
  bv = INFINITY;
  bi = INT_MAX;
  for (int q = tid; q < s; q += nt) {
    const float aq = al[q];
    const float denom = a_min + aq;
    int off;
    float du, dv;
    lookup_coords(merge_m(a_min, aq), clip01(kap_row[q]), g0, g1, &off, &du, &dv);
    const bool valid = q < cnt && aq * a_min > 0.0f && q != i_min;
    const float w = valid ? denom * denom * corner_mix(wd_table, off, g1, du, dv) : WD_INVALID;
    if (better(w, q, bv, bi)) { bv = w; bi = q; }
  }
  // 4. best partner, or the removal fallback
  float wd_min;
  int j_star;
  block_argmin(bv, bi, red_v, red_i, &wd_min, &j_star);
  const bool has_partner = wd_min < NO_PARTNER;

  // 5. merge math (every thread computes the same scalars)
  const float a_j = al[j_star];
  const float a_last = al[last];
  const float k_ij = kap_row[j_star];
  float h;
  {
    int off;
    float du, dv;
    lookup_coords(merge_m(a_min, a_j), clip01(k_ij), g0, g1, &off, &du, &dv);
    h = corner_mix(h_table, off, g1, du, dv);
  }
  const float u = 1.0f - h;
  const float lk_m = safe_log(clip01(k_ij));
  const float a_z = a_min * expf((u * u) * lk_m) + a_j * expf((h * h) * lk_m);
  const float lk_ij = safe_log(k_ij);
  const float hu = h * u;
  for (int q = tid; q < s; q += nt) {
    row_j[q] = km[(size_t)j_star * s + q];
    row_last[q] = km[(size_t)last * s + q];
  }
  __syncthreads();
  // z's cache row entry at slot q (the log-space combine, clamped at 0)
  auto z_row = [&](int q) {
    const float lz = h * safe_log(kap_row[q]) + u * safe_log(row_j[q]) - hu * lk_ij;
    return expf(fminf(lz, 0.0f));
  };
  const float z_last = z_row(last);
  const int lo = min(i_min, j_star), hi = max(i_min, j_star);
  const int t1 = has_partner ? lo : i_min;
  auto r1 = [&](int q) {   // the row written to t1
    if (has_partner) return q == lo ? 1.0f : (q == hi ? z_last : z_row(q));
    return q == i_min ? 1.0f : row_last[q];
  };
  auto r_move = [&](int q) {   // the row written to t2 = hi (merge only)
    return q == lo ? z_last : (q == hi ? 1.0f : row_last[q]);
  };

  // 6. two rows, then the two columns
  for (int q = tid; q < s; q += nt) {
    km[(size_t)t1 * s + q] = r1(q);
    if (has_partner) km[(size_t)hi * s + q] = r_move(q);
  }
  __syncthreads();
  for (int q = tid; q < s; q += nt) {
    km[(size_t)q * s + t1] = r1(q);
    if (has_partner) km[(size_t)q * s + hi] = r_move(q);
  }

  // 7. SV rows (each thread reads, then writes, its own features) and alpha
  for (int e = tid; e < d; e += nt) {
    const TS xi = sv[(size_t)i_min * d + e];
    const TS xj = sv[(size_t)j_star * d + e];
    const TS vl = sv[(size_t)last * d + e];
    const float z = h * to_f32(xi) + u * to_f32(xj);
    sv[(size_t)t1 * d + e] = has_partner ? from_f32<TS>(z) : vl;
    if (has_partner) sv[(size_t)hi * d + e] = vl;
  }
  if (tid == 0) {
    al[t1] = has_partner ? a_z : a_last;
    if (has_partner) al[hi] = a_last;
    al[last] = 0.0f;
    if (decision != nullptr) {
      decision[0] = i_min;
      decision[1] = j_star;
      decision[2] = has_partner ? 1 : 0;
    }
  }
}

}  // namespace

// One whole Lookup-WD merge event on one class's slice of the stacked state,
// run by the class's cluster of K blocks (cluster.cuh): the body of
// merge_event.cu's kernels (one event round, and a step's masked rounds in
// one launch) and of train_step.cu's merge rounds, so all three run the same
// event.  On the slice (sv (S, D), the kernel cache km (S, S)) and the
// block's copy al of alpha (S,), with cnt active slots:
//   1. i_min = the active (slot < cnt) argmin of |alpha|, first on ties: each
//      block over its slot range, then one cluster argmin;
//   2. each block stages its range of the kappa row km[i_min] (and of row
//      last);
//   3. and scores its candidates from the WD_norm table:
//        wd_j = (a_min + alpha_j)^2 * bilinear(m_j, kap_j), 3.4e38 unless j is
//        active, of a_min's sign and not i_min;
//   4. j_star = argmin wd, first on ties (one cluster argmin); no partner
//      (wd >= 1e30) means removal; k(x_i, x_j) is read from j_star's owner;
//   5. every block computes the same h (h table at j_star), a_z = a_min
//      k^((1-h)^2) + a_j k^(h^2), and stages its range of row j_star; z's
//      cache row is the log-space combine of rows i_min and j_star
//      (core.kernel_cache); each block writes its features of the SV rows
//      t1, t2 (step 7) with those loads;
//   6. each block writes its range of two cache rows, then (after the
//      cluster barrier) of the same two columns: slot t1 = lo (merge) or
//      i_min (removal) takes z's row (or the old last's), slot t2 = hi takes
//      the old last's row.  The two entries (lo, hi) and (hi, lo), which
//      rows and columns both set to z's kernel value at ``last``, are
//      written once, by last's owner, after the barrier;
//   7. z = h x_i + (1-h) x_j in fp32 into SV row t1 (or the old last's row
//      on removal), the old last's into t2; every block applies the same
//      alpha update to its copy (al[t1], al[t2], al[last] = 0), which the
//      caller writes back.
// Every block of the cluster calls it with the same arguments (cnt is the
// same everywhere); the caller owns cnt -= 1 and a block barrier before the
// next event reads al.  The arithmetic follows the plain version
// (repro_torch.kernels.ref.merge_event) operation by operation; files that
// include this are compiled with -fmad=false and use expf/logf without fast
// math, and the argmins are exact, so the decisions and every written bit are
// the plain version's, for any K.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "block_argmin.cuh"
#include "cluster.cuh"
#include "lookup.cuh"

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

// rows: 3 * pt.cs floats of shared memory (this block's range of the three
// cache rows the event reads, so the updates never read what they have just
// written; the kappa range is read by the other blocks too).  decision, when
// not null, receives (i_min, j_star, merged) from rank 0.  Each thread stages,
// scores and writes the same slots q = lo + tid + k * blockDim.x throughout.
template <typename TS>
__device__ void merge_event_body(const Part& pt, TS* sv, float* al, float* km, int cnt,
                                 const float* __restrict__ h_table,
                                 const float* __restrict__ wd_table, int g0, int g1, int s,
                                 int d, float* rows, Reduce& rd, int& ph, int* decision) {
  float* kap_row = rows;               // km[i_min], this block's range
  float* row_j = rows + pt.cs;         // km[j_star]
  float* row_last = rows + 2 * pt.cs;  // km[last]
  const int last = cnt - 1;
  const int tid = threadIdx.x, nt = blockDim.x;

  // 1. fixed partner
  float bv = INFINITY;
  int bi = INT_MAX;
  for (int q = pt.lo + tid; q < pt.hi; q += nt) {
    const float v = q < cnt ? fabsf(al[q]) : INFINITY;
    if (better(v, q, bv, bi)) { bv = v; bi = q; }
  }
  float unused;
  int i_min;
  cluster_argmin(pt, true, rd, ph, bv, bi, &unused, &i_min);
  const float a_min = al[i_min];

  // 2-3. stage the kappa range (and row last's, loaded alongside) and score
  // every candidate of it
  bv = INFINITY;
  bi = INT_MAX;
  for (int q = pt.lo + tid; q < pt.hi; q += nt) {
    const float kq = ld_state(km + (size_t)i_min * s + q);
    row_last[q - pt.lo] = ld_state(km + (size_t)last * s + q);
    kap_row[q - pt.lo] = kq;
    const float aq = al[q];
    const float denom = a_min + aq;
    int off;
    float du, dv;
    lookup_coords(merge_m(a_min, aq), clip01(kq), g0, g1, &off, &du, &dv);
    const bool valid = q < cnt && aq * a_min > 0.0f && q != i_min;
    const float w = valid ? denom * denom * corner_mix(wd_table, off, g1, du, dv) : WD_INVALID;
    if (better(w, q, bv, bi)) { bv = w; bi = q; }
  }
  // 4. best partner, or the removal fallback
  float wd_min;
  int j_star;
  cluster_argmin(pt, true, rd, ph, bv, bi, &wd_min, &j_star);
  const bool has_partner = wd_min < NO_PARTNER;

  // 5. merge math (every thread of every block computes the same scalars)
  const float a_j = al[j_star];
  const float a_last = al[last];
  const float k_ij = slot_entry(pt, kap_row, 0, j_star);
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
  const int lo = min(i_min, j_star), hi = max(i_min, j_star);
  const int t1 = has_partner ? lo : i_min;
  // row j_star's range, and 7. the SV rows (each thread reads, then writes,
  // its own features), their loads in flight together
  const int n_loc = pt.hi - pt.lo, nf = pt.f_hi - pt.f_lo;
  for (int x = tid; x < max(n_loc, nf); x += nt) {
    float rj = 0.0f;
    TS xi = TS(), xj = TS(), vl = TS();
    const int e = pt.f_lo + x;
    if (x < n_loc) rj = ld_state(km + (size_t)j_star * s + pt.lo + x);
    if (x < nf) {
      xi = ld_state(sv + (size_t)i_min * d + e);
      xj = ld_state(sv + (size_t)j_star * d + e);
      vl = ld_state(sv + (size_t)last * d + e);
    }
    if (x < n_loc) row_j[x] = rj;
    if (x < nf) {
      const float z = h * to_f32(xi) + u * to_f32(xj);
      sv[(size_t)t1 * d + e] = has_partner ? from_f32<TS>(z) : vl;
      if (has_partner) sv[(size_t)hi * d + e] = vl;
    }
  }
  // z's cache row entry at local slot l (the log-space combine, clamped at 0)
  auto z_row = [&](int l) {
    const float lz = h * safe_log(kap_row[l]) + u * safe_log(row_j[l]) - hu * lk_ij;
    return expf(fminf(lz, 0.0f));
  };

  // 6. two rows, then the two columns (entries (lo, hi) and (hi, lo) last)
  for (int q = pt.lo + tid; q < pt.hi; q += nt) {
    const int l = q - pt.lo;
    if (has_partner) {
      if (q != hi) km[(size_t)t1 * s + q] = q == lo ? 1.0f : z_row(l);
      if (q != lo) km[(size_t)hi * s + q] = q == hi ? 1.0f : row_last[l];
    } else {
      km[(size_t)t1 * s + q] = q == i_min ? 1.0f : row_last[l];
    }
  }
  part_sync(pt);
  for (int q = pt.lo + tid; q < pt.hi; q += nt) {
    const int l = q - pt.lo;
    if (has_partner) {
      if (q != hi) km[(size_t)q * s + t1] = q == lo ? 1.0f : z_row(l);
      if (q != lo) km[(size_t)q * s + hi] = q == hi ? 1.0f : row_last[l];
      if (q == last) {
        const float z_last = z_row(l);
        km[(size_t)lo * s + hi] = z_last;
        km[(size_t)hi * s + lo] = z_last;
      }
    } else {
      km[(size_t)q * s + t1] = q == i_min ? 1.0f : row_last[l];
    }
  }

  // 7. alpha
  if (tid == 0) {   // every thread read a_j and a_last before the barrier above
    al[t1] = has_partner ? a_z : a_last;
    if (has_partner) al[hi] = a_last;
    al[last] = 0.0f;
    if (decision != nullptr && pt.rank == 0) {
      decision[0] = i_min;
      decision[1] = j_star;
      decision[2] = has_partner ? 1 : 0;
    }
  }
}

}  // namespace

// The scoring and greedy disjoint pair choice of one multi-merge event on one
// class: steps 3 and 4 of core.budget._multi_merge_once (plain version
// kernels.ref.multi_merge_choose).  Run by the class's cluster in
// train_step.cu's multi-merge rounds (each block scores its own slot range;
// each pick is one cluster argmin) and by one block (K = 1) in
// merge_multi.cu's multi_merge_choose_kernel, so the fused step and the
// composed engine choose with the same code.  Files that include this are
// compiled with -fmad=false, so the scores round as the plain version's do.
#pragma once

#include <cuda_runtime.h>

#include <climits>
#include <cmath>

#include "block_argmin.cuh"
#include "lookup.cuh"

namespace {

// One event's fixed partners and choice.  The per-pair lists live in
// dynamic shared memory, sized by P (carve_pairs); the struct, in static
// shared memory, holds their addresses and the counters.  The caller fills
// a[k] (the slot of the k-th smallest active |alpha|) and a_min[k] (its
// alpha).
struct PairChoice {
  int *a, *b, *taken;   // taken: up to 2 P slots
  float* a_min;
  bool *merged, *executed, *consumed;
  int n_taken, n_exec;
};

// Bytes of PairChoice's lists for P pairs: five 4-byte words and three
// bools a pair, rounded up to 16 so that what follows stays aligned.
__host__ __device__ constexpr size_t pair_choice_bytes(int p) {
  return ((size_t)p * (5 * 4 + 3) + 15) / 16 * 16;
}

// Points ch's lists into ``base`` (pair_choice_bytes(p) bytes of shared
// memory).  One thread calls it, before a barrier and any use.
__device__ void carve_pairs(PairChoice& ch, char* base, int p) {
  int* w = reinterpret_cast<int*>(base);
  ch.a = w;
  ch.b = w + p;
  ch.taken = w + 2 * p;
  ch.a_min = reinterpret_cast<float*>(w + 4 * p);
  bool* f = reinterpret_cast<bool*>(w + 5 * p);
  ch.merged = f;
  ch.executed = f + p;
  ch.consumed = f + 2 * p;
}

// 3. The Lookup-WD score of each fixed partner k against every slot q of
// this block's range into wd[k * cs + q - lo]: +inf unless q is active
// (q < cnt), of the partner's sign and not the partner's own slot.
// kap_rows[k * cs + q - lo] = k(x_{a_k}, x_q); al: the class's alpha (s,).
__device__ void score_pairs(const Part& pt, const float* kap_rows, const float* al, int cnt,
                            int p, const PairChoice& ch, const float* __restrict__ wd_table,
                            int g0, int g1, float* wd) {
  const int n_loc = pt.hi - pt.lo;
  for (int e = threadIdx.x; e < p * n_loc; e += blockDim.x) {
    const int k = e / n_loc, l = e - k * n_loc, q = pt.lo + l, x = k * pt.cs + l;
    const float a_min = ch.a_min[k], aq = al[q];
    const float denom = a_min + aq;
    int off;
    float du, dv;
    lookup_coords(merge_m(a_min, aq), clip01(kap_rows[x]), g0, g1, &off, &du, &dv);
    const bool valid = q < cnt && a_min * aq > 0.0f && q != ch.a[k];
    wd[x] = valid ? denom * denom * corner_mix(wd_table, off, g1, du, dv) : INFINITY;
  }
}

// 4. Greedy disjoint choice in |alpha| order over the scores wd (p ranges
// of cs, as score_pairs writes them): pair k executes unless its fixed slot
// was taken as an earlier partner or the excess (count - budget) is
// covered, and merges with its best untaken candidate (first on ties, one
// cluster argmin), or falls back to removal when none scores below
// NO_PARTNER.  Every thread of every block calls it; on return ch.b,
// merged, executed and n_exec hold the choice, the same in every block (each
// block does the bookkeeping on its thread 0 from the same reductions).
__device__ void greedy_choice(const Part& pt, const float* wd, int p, int excess, PairChoice& ch,
                              Reduce& rd, int& ph) {
  if (threadIdx.x == 0) {
    ch.n_taken = 0;
    ch.n_exec = 0;
    for (int k = 0; k < p; ++k) ch.consumed[k] = false;
  }
  __syncthreads();
  for (int k = 0; k < p; ++k) {
    const int n_taken = ch.n_taken;
    float bv = INFINITY;
    int bi = INT_MAX;
    for (int q = pt.lo + threadIdx.x; q < pt.hi; q += blockDim.x) {
      bool taken = false;
      for (int r = 0; r < n_taken; ++r) taken |= ch.taken[r] == q;
      const float v = taken ? INFINITY : wd[k * pt.cs + q - pt.lo];
      if (better(v, q, bv, bi)) { bv = v; bi = q; }
    }
    float mn;
    int j;
    cluster_argmin(pt, true, rd, ph, bv, bi, &mn, &j);
    if (threadIdx.x == 0) {
      const bool ex = !ch.consumed[k] && ch.n_exec < excess;
      const bool mg = ex && mn < NO_PARTNER;
      ch.b[k] = j;
      ch.merged[k] = mg;
      ch.executed[k] = ex;
      if (mg) ch.taken[ch.n_taken++] = j;
      if (ex) ch.taken[ch.n_taken++] = ch.a[k];
      if (mg)
        for (int r = k + 1; r < p; ++r) ch.consumed[r] |= ch.a[r] == j;
      ch.n_exec += ex ? 1 : 0;
    }
    __syncthreads();
  }
}

}  // namespace

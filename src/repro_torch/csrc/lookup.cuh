// Bilinear lookup in a G0 x G1 table at unit-square coordinates (m, kap), as
// repro.core.lookup.bilinear_lookup computes it term by term: corner (i0, j0)
// clipped to G-2 so the edges interpolate inside the last cell, the top and
// bottom rows mixed along kap, then the two mixed along m; and the merge
// problem's coordinates (kernels.ref.merge_coords).  Shared by every scoring
// kernel (merge_lookup.cu, merge_multi.cu, merge_event_body.cuh,
// train_step.cu); every file that includes it is compiled with -fmad=false,
// so the card rounds as the plain PyTorch version does.
#pragma once

#include <cuda_runtime.h>

namespace {

// The score of a candidate that may not merge (the plain versions use +inf);
// any score at or above NO_PARTNER means "no partner" (kernels.ref.NO_PARTNER).
constexpr float WD_INVALID = 3.4e38f;
constexpr float NO_PARTNER = 1e30f;

__device__ __forceinline__ float clip01(float x) { return fminf(fmaxf(x, 0.0f), 1.0f); }

// m = a_min / (a_min + alpha) clipped to [0, 1], a zero denominator read as 1
// (kernels.ref.merge_coords).
__device__ __forceinline__ float merge_m(float a_min, float alpha) {
  const float denom = a_min + alpha;
  return clip01(a_min / (denom == 0.0f ? 1.0f : denom));
}

// Corner offset and weights of the lookup at (m, kap), both in [0, 1].
__device__ __forceinline__ void lookup_coords(float m, float kap, int g0, int g1, int* off,
                                              float* du, float* dv) {
  const float u = m * (float)(g0 - 1);
  const float v = kap * (float)(g1 - 1);
  const int i0 = min(max((int)floorf(u), 0), g0 - 2);
  const int j0 = min(max((int)floorf(v), 0), g1 - 2);
  *du = u - (float)i0;
  *dv = v - (float)j0;
  *off = i0 * g1 + j0;
}

// The four corners at ``off`` (read-only path) mixed with weights (du, dv).
__device__ __forceinline__ float corner_mix(const float* __restrict__ table, int off, int g1,
                                            float du, float dv) {
  const float t00 = __ldg(table + off), t01 = __ldg(table + off + 1);
  const float t10 = __ldg(table + off + g1), t11 = __ldg(table + off + g1 + 1);
  const float top = t00 * (1.0f - dv) + t01 * dv;
  const float bot = t10 * (1.0f - dv) + t11 * dv;
  return top * (1.0f - du) + bot * du;
}

}  // namespace

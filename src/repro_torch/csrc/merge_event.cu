// Budget-maintenance events on every over-budget class, in place: one
// event round (merge_event) or a step's masked rounds (merge_event_rounds).
//
// Replaces the TPU kernel src/repro/kernels/merge_event.py::merge_event_pallas
// (bodies _merge_event_kernel, _merge_event_body).  Each class c is one
// thread-block cluster of K blocks (cluster.cuh) running merge_event_body
// (merge_event_body.cuh, shared with the fused train step) on its slice of
// the stacked state (sv_x (S, D), alpha (S,), the kernel cache kmat (S, S)):
// the argmin-|alpha| fixed partner, its cached kappa row, Lookup-WD scores,
// the best same-sign partner or the removal fallback, and the two-row +
// two-column cache update, each block over its own range of slots and
// features and with its own copy of alpha in shared memory.
//   * merge_event: one event on each class whose over flag is set; a class
//     whose flag is clear is not touched at all.  When a decisions buffer is
//     given, an executing class also writes (i_min, j_star, merged) to its
//     row of it.
//   * merge_event_rounds: up to ``rounds`` events on each class, each one
//     run while count > budget (the masked rounds of
//     core.budget.event_rounds_, as train_step.cu runs them), with count
//     and n_events (+1 an event) updated in place; a class at or under its
//     budget is not touched.  One launch takes the place of a step's
//     ``rounds`` merge_event launches and the five small ops around each.
//
// What bounds it on the H100: one event reads three cache rows, three SV
// rows and alpha, and writes two rows and two columns of the cache and two
// SV rows: ~20 KB per class at S = 508, D = 780, against a 1 MB cache that
// stays in device memory and is never copied.  The work is a chain of two
// cluster argmins and a barrier, with a few microseconds of latency; there
// are too few bytes for bandwidth to matter.  On the training path the host
// was the bound (six launches a round): merge_event_rounds keeps the round
// loop on the card.  Shared memory holds alpha and this block's range of the
// three rows the event reads (kappa row, row j_star, row last), so the
// updates never read what they have just written.  The TPU kernel's one-hot
// matmul gathers and hat-basis lookup are TPU idioms and are not carried
// over.
//
// The arithmetic follows the plain versions (repro_torch.kernels.ref
// .merge_event, .merge_event_rounds) operation by operation; the file is
// compiled with -fmad=false and uses expf/logf without fast math, so the
// decisions and every written bit are the plain versions', for any K.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "cluster.cuh"
#include "merge_event_body.cuh"

namespace {

constexpr int THREADS = 256;

// Dynamic shared memory of one block with clusters of k: alpha and the
// block's range of three cache rows.
size_t smem_bytes(int s, int k) {
  return ((size_t)s + 3 * (size_t)((s + k - 1) / k)) * sizeof(float);
}

// The block's copy of the class's alpha.
__device__ void load_alpha(const float* alpha, float* al, int s) {
  for (int q = threadIdx.x; q < s; q += blockDim.x) al[q] = ld_state(alpha + q);
  __syncthreads();
}

template <typename TS>
__global__ void __launch_bounds__(THREADS) merge_event_kernel(
    TS* sv_x, float* alpha, float* kmat, const int* __restrict__ count,
    const unsigned char* __restrict__ over, const float* __restrict__ h_table,
    const float* __restrict__ wd_table, int g0, int g1, int s, int d, int k,
    int* __restrict__ decisions) {
  const int c = blockIdx.x / k;
  if (!over[c]) return;   // the whole cluster: bitwise untouched
  extern __shared__ float smem[];
  __shared__ Reduce rd;
  const Part pt = make_part(k, s, d);
  float* al = smem;
  float* a = alpha + (size_t)c * s;
  load_alpha(a, al, s);
  int ph = 0;
  merge_event_body(pt, sv_x + (size_t)c * s * d, al, kmat + (size_t)c * s * s, count[c],
                   h_table, wd_table, g0, g1, s, d, smem + s, rd, ph,
                   decisions == nullptr ? nullptr : decisions + 3 * c);
  __syncthreads();
  for (int q = pt.lo + threadIdx.x; q < pt.hi; q += blockDim.x) a[q] = al[q];
  part_sync(pt);   // no block leaves while another may read its shared memory
}

template <typename TS>
__global__ void __launch_bounds__(THREADS) merge_event_rounds_kernel(
    TS* sv_x, float* alpha, float* kmat, int* count, int* n_events,
    const float* __restrict__ h_table, const float* __restrict__ wd_table, int g0, int g1,
    int s, int d, int rounds, int budget, int k) {
  const int c = blockIdx.x / k;
  int cnt = count[c];
  if (cnt <= budget) return;   // the whole cluster: bitwise untouched
  extern __shared__ float smem[];
  __shared__ Reduce rd;
  const Part pt = make_part(k, s, d);
  float* al = smem;
  float* a = alpha + (size_t)c * s;
  TS* sv = sv_x + (size_t)c * s * d;
  float* km = kmat + (size_t)c * s * s;
  load_alpha(a, al, s);
  int ph = 0;
  int ne = n_events[c];
  for (int r = 0; r < rounds && cnt > budget; ++r) {
    merge_event_body(pt, sv, al, km, cnt, h_table, wd_table, g0, g1, s, d, smem + s, rd, ph,
                     static_cast<int*>(nullptr));
    cnt -= 1;
    ne += 1;
    __syncthreads();
  }
  for (int q = pt.lo + threadIdx.x; q < pt.hi; q += blockDim.x) a[q] = al[q];
  part_sync(pt);   // every block has read count and n_events; none leaves early
  if (pt.rank == 0 && threadIdx.x == 0) {
    count[c] = cnt;
    n_events[c] = ne;
  }
}

template <typename K, typename... Args>
int cluster_launch(K* kernel, int c, int k, size_t smem, void* stream, Args... args) {
  cudaError_t e = cluster_prepare(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(c, k, THREADS, smem, stream, &attr);
  e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// sv_x: (C, s, d) fp32 (sv_bf16 = 0) or bf16 (sv_bf16 = 1); alpha: (C, s) fp32;
// kmat: (C, s, s) fp32; count: (C,) int32; over: (C,) bytes (0/1); h_table,
// wd_table: (g0, g1) fp32; k: blocks a class.  sv_x, alpha and kmat are
// updated in place.  decisions: (C, 3) int32 or null.  Returns the launch's
// error, or cudaGetLastError() after it.
extern "C" int merge_event_launch(void* sv_x, int sv_bf16, void* alpha, void* kmat,
                                  const void* count, const void* over, const void* h_table,
                                  const void* wd_table, int g0, int g1, int c, int s, int d,
                                  int k, void* decisions, void* stream) {
  if (k < 1 || k > 16) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(s, k);
  auto launch = [&](auto* sv, auto kernel) {
    return cluster_launch(kernel, c, k, smem, stream, sv, static_cast<float*>(alpha),
                          static_cast<float*>(kmat), static_cast<const int*>(count),
                          static_cast<const unsigned char*>(over),
                          static_cast<const float*>(h_table), static_cast<const float*>(wd_table),
                          g0, g1, s, d, k, static_cast<int*>(decisions));
  };
  if (sv_bf16)
    return launch(static_cast<__nv_bfloat16*>(sv_x), merge_event_kernel<__nv_bfloat16>);
  return launch(static_cast<float*>(sv_x), merge_event_kernel<float>);
}

// As merge_event_launch, for up to ``rounds`` masked events a class: count
// and n_events ((C,) int32) are read and written in place.
extern "C" int merge_event_rounds_launch(void* sv_x, int sv_bf16, void* alpha, void* kmat,
                                         void* count, void* n_events, const void* h_table,
                                         const void* wd_table, int g0, int g1, int c, int s,
                                         int d, int rounds, int budget, int k, void* stream) {
  if (k < 1 || k > 16 || rounds < 1) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(s, k);
  auto launch = [&](auto* sv, auto kernel) {
    return cluster_launch(kernel, c, k, smem, stream, sv, static_cast<float*>(alpha),
                          static_cast<float*>(kmat), static_cast<int*>(count),
                          static_cast<int*>(n_events), static_cast<const float*>(h_table),
                          static_cast<const float*>(wd_table), g0, g1, s, d, rounds, budget, k);
  };
  if (sv_bf16)
    return launch(static_cast<__nv_bfloat16*>(sv_x), merge_event_rounds_kernel<__nv_bfloat16>);
  return launch(static_cast<float*>(sv_x), merge_event_rounds_kernel<float>);
}

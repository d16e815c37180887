// One whole budget-maintenance event per over-budget class, in place.
//
// Replaces the TPU kernel src/repro/kernels/merge_event.py::merge_event_pallas
// (bodies _merge_event_kernel, _merge_event_body).  For each class c with
// over[c] set, one block runs merge_event_body (merge_event_body.cuh, shared
// with the fused train step) on its slice of the stacked state (sv_x (S, D),
// alpha (S,), the kernel cache kmat (S, S)): the argmin-|alpha| fixed partner,
// its cached kappa row, Lookup-WD scores, the best same-sign partner or the
// removal fallback, and the two-row + two-column cache update.  A class whose
// over flag is clear is not touched at all.  When a decisions buffer is
// given, an executing class also writes (i_min, j_star, merged) to its row of
// it.
//
// What bounds it on the H100: one event reads three cache rows, three SV rows
// and alpha, and writes two rows and two columns of the cache and two SV
// rows: ~20 KB per class at S = 508, D = 780, against a 1 MB cache that
// stays in device memory and is never copied.  The work is a chain of two
// block reductions with a few microseconds of latency; there are too few
// bytes for bandwidth to matter.  One block per class: at C = 10 only 10 of
// the 132 SMs have work, which is what holds this kernel back (a later PR can
// split a class's scoring over several blocks).  Shared memory holds the
// three rows the event reads (kappa row, row j_star, row last), so the
// updates never read what they have just written.  The TPU kernel's one-hot
// matmul gathers and hat-basis lookup are TPU idioms and are not carried over.
//
// The arithmetic follows the plain version (repro_torch.kernels.ref.merge_event)
// operation by operation; the file is compiled with -fmad=false and uses
// expf/logf without fast math, so the decisions are the plain version's.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "merge_event_body.cuh"

namespace {

constexpr int THREADS = 256;

template <typename TS>
__global__ void merge_event_kernel(TS* sv_x, float* alpha, float* kmat,
                                   const int* __restrict__ count,
                                   const unsigned char* __restrict__ over,
                                   const float* __restrict__ h_table,
                                   const float* __restrict__ wd_table, int g0, int g1, int s,
                                   int d, int* __restrict__ decisions) {
  const int c = blockIdx.x;
  if (!over[c]) return;   // bitwise untouched
  extern __shared__ float rows[];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  merge_event_body(sv_x + (size_t)c * s * d, alpha + (size_t)c * s, kmat + (size_t)c * s * s,
                   count[c], h_table, wd_table, g0, g1, s, d, rows, red_v, red_i,
                   decisions == nullptr ? nullptr : decisions + 3 * c);
}

}  // namespace

// sv_x: (C, s, d) fp32 (sv_bf16 = 0) or bf16 (sv_bf16 = 1); alpha: (C, s) fp32;
// kmat: (C, s, s) fp32; count: (C,) int32; over: (C,) bytes (0/1); h_table,
// wd_table: (g0, g1) fp32.  sv_x, alpha and kmat are updated in place.
// decisions: (C, 3) int32 or null.  Returns cudaGetLastError() (or the error
// of raising the shared-memory limit).
extern "C" int merge_event_launch(void* sv_x, int sv_bf16, void* alpha, void* kmat,
                                  const void* count, const void* over, const void* h_table,
                                  const void* wd_table, int g0, int g1, int c, int s, int d,
                                  void* decisions, void* stream) {
  const size_t smem = 3 * (size_t)s * sizeof(float);
  auto launch = [&](auto* sv, auto kernel) {
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    kernel<<<c, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        sv, static_cast<float*>(alpha), static_cast<float*>(kmat),
        static_cast<const int*>(count), static_cast<const unsigned char*>(over),
        static_cast<const float*>(h_table), static_cast<const float*>(wd_table), g0, g1, s, d,
        static_cast<int*>(decisions));
    return (int)cudaGetLastError();
  };
  if (sv_bf16)
    return launch(static_cast<__nv_bfloat16*>(sv_x), merge_event_kernel<__nv_bfloat16>);
  return launch(static_cast<float*>(sv_x), merge_event_kernel<float>);
}

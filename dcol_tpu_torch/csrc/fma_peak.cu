// FMA-throughput probe: the attainable fused multiply-add rate of the card,
// in float or double, for the roofline of the PDIP kernel.
//
// Replaces the TPU kernel in tools/roofline.py::peak (the pl.pallas_call at
// :231): there, each lane of an (8, 128) tile runs 8 independent accumulator
// chains acc = acc * b + c in a while_loop of `inner` passes, 64 mul-adds per
// pass, and writes sum(acc).  Here one lane is one thread: operands are
// struct-of-arrays x (10, L) (rows 0-7 the accumulators' starting values, row
// 8 b, row 9 c), the output is out (L,) = sum over the 8 chains.
//
// What bounds it on the card: only the FMA pipes.  Each thread reads 10
// values and writes 1, and issues inner * 64 FMAs in between; the 8 chains
// are independent, so a warp always has an FMA ready whatever the pipe's
// latency, and registers are few (~20), so every SM holds its full 2048
// threads.  What the design does about it: the 8 accumulators stay in
// registers; the body of a pass is 64 explicit fma() calls, fully unrolled;
// `inner` is a run-time argument and the pass loop is kept rolled
// (#pragma unroll 1), so the compiler can neither fold the recurrence nor
// merge passes, and the SASS of the loop body holds exactly 64 FFMA (float)
// or DFMA (double) instructions.  fma() is one rounding per step, which is
// what the closed form a b^n + c (1 - b^n) / (1 - b) is held against.

#include <cuda_runtime.h>

#if !defined(DCOL_T)
#error "build with -DDCOL_T=float|double"
#endif

namespace {

__device__ __forceinline__ float dfma(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double dfma(double a, double b, double c) {
  return fma(a, b, c);
}

template <typename T>
__global__ void __launch_bounds__(256)
fma_chains_kernel(const T* __restrict__ x, T* __restrict__ out, int L,
                  int inner) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= L) return;
  T a0 = x[0 * (size_t)L + i], a1 = x[1 * (size_t)L + i];
  T a2 = x[2 * (size_t)L + i], a3 = x[3 * (size_t)L + i];
  T a4 = x[4 * (size_t)L + i], a5 = x[5 * (size_t)L + i];
  T a6 = x[6 * (size_t)L + i], a7 = x[7 * (size_t)L + i];
  const T b = x[8 * (size_t)L + i];
  const T c = x[9 * (size_t)L + i];
#pragma unroll 1
  for (int it = 0; it < inner; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // 8 x 8 = 64 FMAs per pass
      a0 = dfma(a0, b, c);
      a1 = dfma(a1, b, c);
      a2 = dfma(a2, b, c);
      a3 = dfma(a3, b, c);
      a4 = dfma(a4, b, c);
      a5 = dfma(a5, b, c);
      a6 = dfma(a6, b, c);
      a7 = dfma(a7, b, c);
    }
  }
  out[i] = ((a0 + a1) + (a2 + a3)) + ((a4 + a5) + (a6 + a7));
}

}  // namespace

extern "C" {

// sizeof(T), so the wrapper can check the library it loaded
int dcol_fma_type_size() { return (int)sizeof(DCOL_T); }

// x: (10, L) on the device, out: (L,); returns the launch's cudaError.
int dcol_fma_chains(const void* x, void* out, int L, int inner,
                    void* stream) {
  if (L <= 0) return 0;
  const int threads = 256;
  const int blocks = (L + threads - 1) / threads;
  fma_chains_kernel<DCOL_T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const DCOL_T*)x, (DCOL_T*)out, L, inner);
  return (int)cudaGetLastError();
}

}  // extern "C"

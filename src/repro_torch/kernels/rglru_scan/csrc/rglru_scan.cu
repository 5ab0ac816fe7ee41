// RG-LRU diagonal linear recurrence, for Hopper.
//
// Replaces the TPU kernel repro/kernels/rglru_scan/kernel.py::_kernel
// (launched by rglru_scan_fwd) and computes what ref.rglru_scan_ref
// computes: for each batch row b and channel d, from h = h0[b, d],
//     h_t = a_t * h_{t-1} + bx_t,   out[b, t, d] = h_t
// in f32 (the product rounded before the sum: -fmad=false, as the plain
// version does it), every h_t written.
//
// Bound.  a and bx read once and every h_t written once in f32: at
// recurrentgemma-2b's longest prefill (B 1, S 3300, D 2560, a and bx f32)
// that is ~101 MB, 30 us at 3.35 TB/s, against two operations per
// element, 0.25 us at 67 TFLOP/s: the bytes bound it.
//
// Design.  The TPU kernel walks S in chunks with a (1, bd) state in VMEM
// scratch carried across sequential grid steps.  Here one thread owns
// one (b, d) channel and walks the whole sequence with h in a register;
// neighbouring threads hold neighbouring channels, so every load and
// store of a step is coalesced.  The chain through h is sequential, so
// each thread first loads kUnroll steps of a and bx into registers (all
// in flight at once) and then runs them.  At B 1 that is only D = 2560
// threads in 40 blocks of 64, far below what the card can hold: this
// simple kernel is bound by the latency of its loads, not by the bytes.
// A chunked two-pass scan (each chunk's local scan, a carry pass over
// chunk ends, then a fix-up) would fill the card; that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;   // steps loaded ahead of the chain

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_fwd(const T* __restrict__ a, const T* __restrict__ bx,
               const float* __restrict__ h0, float* __restrict__ out,
               int s_len, int dim) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (d >= dim) return;
  float h = h0[static_cast<size_t>(b) * dim + d];
  const size_t base = static_cast<size_t>(b) * s_len * dim + d;
  for (int s0 = 0; s0 < s_len; s0 += kUnroll) {
    float av[kUnroll], bv[kUnroll];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const bool in = s0 + i < s_len;
      const size_t at = base + static_cast<size_t>(s0 + i) * dim;
      av[i] = in ? to_f32(a[at]) : 0.f;
      bv[i] = in ? to_f32(bx[at]) : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      if (s0 + i < s_len) {
        h = av[i] * h + bv[i];
        out[base + static_cast<size_t>(s0 + i) * dim] = h;
      }
    }
  }
}

template <typename T>
int launch(const void* a, const void* bx, const float* h0, float* out,
           int bsz, int s_len, int dim, cudaStream_t st) {
  const dim3 grid((dim + kThreads - 1) / kThreads, bsz);
  rglru_scan_fwd<T><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(a), static_cast<const T*>(bx), h0, out, s_len,
      dim);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (B, S, D) f32: every state of h_t = a_t * h_{t-1} + bx_t from
// h0 (B, D) f32; a and bx (B, S, D) contiguous, of one type: dtype 0 is
// f32, 1 is bf16.  Launches on `stream`; returns the cudaError_t of the
// launch (0 = success).
int rglru_scan_launch(const void* a, const void* bx, const void* h0,
                      void* out, int dtype, int bsz, int s_len, int dim,
                      void* stream) {
  if (bsz < 1 || bsz > 65535 || s_len < 1 || dim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* hf = static_cast<const float*>(h0);
  float* of = static_cast<float*>(out);
  if (dtype == 0) return launch<float>(a, bx, hf, of, bsz, s_len, dim, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, bx, hf, of, bsz, s_len, dim, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

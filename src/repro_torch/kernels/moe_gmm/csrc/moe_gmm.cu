// Fused grouped expert FFN over capacity-padded buffers, for Hopper.
//
// Replaces the TPU kernel repro/kernels/moe_gmm/kernel.py::_kernel
// (launched by moe_gmm_fwd) and computes what ref.moe_gmm_ref computes:
// for every expert e and capacity row c,
//   out[e, c, :] = (silu(h[e, c] @ Wg[e]) * (h[e, c] @ Wu[e])) @ Wd[e]
// with h (E, C, D), Wg/Wu (E, D, F), Wd (E, F, D).  Products, the
// activation and the down-projection sum are f32 for f32 and bf16 inputs
// alike; the output is rounded once to h's type.  The activation never
// goes to device memory, as on the TPU.  Empty capacity rows are computed
// like any other (the model's dispatch leaves them zero).
//
// Bound.  Every expert's three weight matrices are read once: 6 * E * D *
// F bytes in bf16, 1.208 GB per qwen3-moe layer (E 128, D 2048, F 768),
// 0.36 ms at 3.35 TB/s.  The operations are 6 * E * C * D * F: at a
// 4-slot decode step (C = 4) the weights' bytes bound the step by two
// orders of magnitude; at a 512-token prefill (C = 40) the bf16
// operations (48 GFLOP, 0.05 ms at 989 TFLOP/s) still sit below the
// bytes.  So the kernel is bound by reading the weights; what it must not
// do is read them once per row.
//
// Design.  The TPU kernel keeps a (block_c, D) f32 accumulator in VMEM
// (block_c 128: 1 MB at D = 2048), which no SM holds: a block has 227 KB
// of shared memory and 64 K registers.  Here a block takes a small tile of
// kBC = 8 capacity rows of one expert and walks F in chunks of 256, one F
// column per thread:
//   1. gate/up: each thread reads its column of Wg and Wu (a warp reads
//      contiguous bytes of one row of W at each d) against the tile's h
//      rows, held in shared memory as f32 (8 * D * 4 bytes: 64 KB at
//      D = 2048), and writes silu(g) * u for the 8 rows to shared memory;
//   2. down: each thread owns kDPT = 8 output columns (2048 per block) and
//      adds act[r, f] * Wd[f, col] into 8 x 8 f32 registers.
// The accumulator lives in registers, spread over the block's 256
// threads, so the tile of 8 rows by 2048 columns fits where the TPU's 128
// rows did not.  D wider than 2048 is split across blocks (grid z), each
// recomputing the activation for its columns.  Every block of one expert
// reads that expert's weights once, so the weights are read once per
// 8-row tile: once at decode (C <= 8), five times at C = 40, mostly from
// the 50 MB L2 while the tiles of one expert run side by side.  Each sum
// runs in a fixed order, so the same inputs give the same bits.
// Rounding: fmaf explicitly (the library is built with -fmad=false), silu
// as g / (1 + exp(-g)) in IEEE f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBC = 8;              // capacity rows per block
constexpr int kBF = kThreads;       // F columns per chunk, one per thread
constexpr int kDPT = 8;             // output columns per thread
constexpr int kCols = kThreads * kDPT;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_gmm_fwd(const T* __restrict__ h, const T* __restrict__ wg,
            const T* __restrict__ wu, const T* __restrict__ wd,
            T* __restrict__ out, int C, int D, int F) {
  extern __shared__ float smem[];
  float* hs = smem;                  // [kBC][D]
  float* as = hs + kBC * D;          // [kBC][kBF]

  const int e = blockIdx.y;
  const int c0 = blockIdx.x * kBC;
  const int d0 = blockIdx.z * kCols;
  const int t = threadIdx.x;
  const int rows = min(kBC, C - c0);
  const T* hb = h + (static_cast<size_t>(e) * C + c0) * D;
  const size_t wofs = static_cast<size_t>(e) * D * F;
  const T* wgb = wg + wofs;
  const T* wub = wu + wofs;
  const T* wdb = wd + wofs;

  for (int i = t; i < kBC * D; i += kThreads)
    hs[i] = i / D < rows ? to_f32(hb[i]) : 0.f;

  float acc[kBC][kDPT];
#pragma unroll
  for (int r = 0; r < kBC; ++r)
#pragma unroll
    for (int j = 0; j < kDPT; ++j) acc[r][j] = 0.f;

  for (int f0 = 0; f0 < F; f0 += kBF) {
    __syncthreads();  // h tile written; last chunk's activation reads done
    const int f = f0 + t;
    float g[kBC], u[kBC];
#pragma unroll
    for (int r = 0; r < kBC; ++r) g[r] = u[r] = 0.f;
    if (f < F) {
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float a = to_f32(wgb[static_cast<size_t>(d) * F + f]);
        const float b = to_f32(wub[static_cast<size_t>(d) * F + f]);
#pragma unroll
        for (int r = 0; r < kBC; ++r) {
          const float x = hs[r * D + d];
          g[r] = fmaf(x, a, g[r]);
          u[r] = fmaf(x, b, u[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kBC; ++r)
      as[r * kBF + t] = f < F ? g[r] / (1.f + expf(-g[r])) * u[r] : 0.f;
    __syncthreads();

    const int nf = min(kBF, F - f0);
    for (int j = 0; j < nf; ++j) {
      const T* row = wdb + static_cast<size_t>(f0 + j) * D;
      float w[kDPT];
#pragma unroll
      for (int q = 0; q < kDPT; ++q) {
        const int col = d0 + t + q * kThreads;
        w[q] = col < D ? to_f32(row[col]) : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kBC; ++r) {
        const float a = as[r * kBF + j];
#pragma unroll
        for (int q = 0; q < kDPT; ++q) acc[r][q] = fmaf(a, w[q], acc[r][q]);
      }
    }
  }

  T* ob = out + (static_cast<size_t>(e) * C + c0) * D;
#pragma unroll
  for (int r = 0; r < kBC; ++r) {
    if (r >= rows) break;
#pragma unroll
    for (int q = 0; q < kDPT; ++q) {
      const int col = d0 + t + q * kThreads;
      if (col < D) store(ob + static_cast<size_t>(r) * D + col, acc[r][q]);
    }
  }
}

template <typename T>
int launch(const void* h, const void* wg, const void* wu, const void* wd,
           void* out, int E, int C, int D, int F, cudaStream_t st) {
  const size_t bytes = sizeof(float) * (kBC * static_cast<size_t>(D) + kBC * kBF);
  cudaError_t err = cudaFuncSetAttribute(
      moe_gmm_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((C + kBC - 1) / kBC, E, (D + kCols - 1) / kCols);
  moe_gmm_fwd<T><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(wg),
      static_cast<const T*>(wu), static_cast<const T*>(wd),
      static_cast<T*>(out), C, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out (E, C, D) = silu(h @ Wg) * (h @ Wu) @ Wd per expert, all contiguous
// and of one type: dtype 0 is f32, 1 is bf16.  Launches on `stream`;
// returns the cudaError_t of the launch (0 = success).
int moe_gmm_launch(const void* h, const void* wg, const void* wu,
                   const void* wd, void* out, int dtype, int E, int C, int D,
                   int F, void* stream) {
  if (E < 1 || E > 65535 || C < 1 || D < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(h, wg, wu, wd, out, E, C, D, F, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(h, wg, wu, wd, out, E, C, D, F, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

// Backward of the grouped expert FFN over capacity-padded buffers, for
// Hopper: the eight products of the gated FFN's gradient as tiled f32
// products on the CUDA cores.
//
// Replaces no TPU kernel.  The JAX package trains through plain jnp (the
// einsum trio of models/moe.py:128-131) and differentiates it with
// jax.grad; the port's forward runs the hand-written moe_gmm.cu, which
// autograd cannot see into, so its gradient is a kernel too.  It computes
// what ref.moe_gmm_bwd_ref computes: for every expert, with h (C, D),
// Wg/Wu (D, F), Wd (F, D) and the output's gradient dout (C, D),
//     G = h Wg,  U = h Wu  (recomputed),  A = silu(G) U
//     dWd = A^T dout,   dA = dout Wd^T
//     dG = dA U silu'(G),   dU = dA silu(G)
//     dWg = h^T dG,  dWu = h^T dU,   dh = dG Wg^T + dU Wu^T
// every product and sum in f32, each gradient rounded once to the inputs'
// type.  silu(g) = g s, silu'(g) = s (1 + g (1 - s)), s = 1 / (1 + e^-g).
//
// Bound.  Eight products of 2 C D F operations an expert: 16 E C D F.  At
// qwen3-moe's training shape (E 128, C 320 for 4,096 tokens, D 2048, F
// 768) that is 1.03 TFLOP, 15.4 ms at the 67 TFLOP/s of f32 on the CUDA
// cores (1.04 ms at the tensor cores' bf16 989); the bytes (h, dout and
// dh, the three weights and their gradients, bf16) are ~2.9 GB, 0.87 ms.
// So the operations bound it; this kernel runs them on the CUDA cores in
// f32, and the tensor cores (wgmma) are the next design.
//
// Design.  Three passes, each a grid of 64 x 64 output tiles an expert,
// 256 threads a block holding 4 x 4 sums each, the summed dimension walked
// in steps of 16 staged in shared memory as f32 (every operand's type
// converted as it is staged):
//   1. moe_bwd_act: one block owns a (C, F) tile and walks D in order for
//      G, U and dA; its epilogue writes A, dG and dU to f32 (E, C, F)
//      scratch that the wrapper allocates;
//   2. moe_bwd_gemm for dWd (an (F, D) tile), dWg and dWu (a (D, F) tile
//      each): one block owns a weight-gradient tile and walks the capacity
//      rows in order;
//   3. moe_bwd_gemm for dh (a (C, D) tile): one block walks F in order for
//      dG Wg^T, then again for dU Wu^T, into the same sums.
// Every operand is read either along the summed dimension or across the
// tile (the template's XK / YK), with neighbouring threads on
// neighbouring addresses.  No atomics and a fixed order of every sum: the
// same bits every run.  Empty capacity rows (h zero) give G = U = 0, so
// dG = dU = 0 and their dh rows are zero whatever dout holds there.
// Rounding: fmaf explicitly (the library is built with -fmad=false), the
// sigmoid as 1 / (1 + expf(-g)) in IEEE f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;     // output rows and columns a block
constexpr int kStep = 16;     // summed rows staged at once
constexpr int kPad = 4;       // shared rows padded (bank spread, float4)
constexpr int kPer = 4;       // sums a thread along each tile edge
constexpr int kAcross = kTile / kPer;   // threads along each tile edge

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// One expert's operand of a product: element (r, k) at
// p[r * ld + k] when K_CONTIG (the summed index k contiguous), else at
// p[k * ld + r]; r is the output row (of X) or column (of Y).
template <typename T, bool K_CONTIG>
struct Operand {
  const T* p;
  int ld;
  __device__ __forceinline__ float at(int r, int k) const {
    return to_f32(K_CONTIG ? p[static_cast<size_t>(r) * ld + k]
                           : p[static_cast<size_t>(k) * ld + r]);
  }
};

// Stage rows r0 .. r0 + 63 of op at k0 .. k0 + 15 into s[k][r] as f32, zero
// past R and K; threads on neighbouring addresses of the source.
template <typename T, bool KC>
__device__ __forceinline__ void stage(float (*s)[kTile + kPad],
                                      const Operand<T, KC>& op, int r0,
                                      int R, int k0, int K) {
#pragma unroll
  for (int q = 0; q < kTile * kStep / kThreads; ++q) {
    const int i = threadIdx.x + q * kThreads;
    const int k = KC ? i % kStep : i / kTile;
    const int r = KC ? i / kStep : i % kTile;
    s[k][r] = r0 + r < R && k0 + k < K ? op.at(r0 + r, k0 + k) : 0.f;
  }
}

// acc[i][j] += sum over k of X(m0 + 4 ty + i, k) Y(k, n0 + 4 tx + j), k
// walked in order from 0 to K - 1.
template <typename TX, bool XK, typename TY, bool YK>
__device__ __forceinline__ void product(
    float (&acc)[kPer][kPer], const Operand<TX, XK>& x,
    const Operand<TY, YK>& y, int m0, int M, int n0, int N, int K,
    float (*xs)[kTile + kPad], float (*ys)[kTile + kPad]) {
  const int ty = threadIdx.x / kAcross, tx = threadIdx.x % kAcross;
  for (int k0 = 0; k0 < K; k0 += kStep) {
    __syncthreads();   // the last step's reads are done
    stage(xs, x, m0, M, k0, K);
    stage(ys, y, n0, N, k0, K);
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kStep; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[k][ty * kPer]);
      const float4 b = *reinterpret_cast<const float4*>(&ys[k][tx * kPer]);
      const float av[kPer] = {a.x, a.y, a.z, a.w};
      const float bv[kPer] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j)
          acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[kPer][kPer]) {
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.f;
}

// Pass 1: G, U, dA of a (C, F) tile of expert blockIdx.z; A, dG, dU out.
template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_bwd_act(const T* __restrict__ h, const T* __restrict__ wg,
            const T* __restrict__ wu, const T* __restrict__ wd,
            const T* __restrict__ dout, float* __restrict__ act,
            float* __restrict__ dg, float* __restrict__ du, int C, int D,
            int F) {
  __shared__ __align__(16) float xs[kStep][kTile + kPad];
  __shared__ __align__(16) float ys[kStep][kTile + kPad];
  const size_t e = blockIdx.z;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  const Operand<T, true> he{h + e * C * D, D}, de{dout + e * C * D, D};
  const Operand<T, false> ge{wg + e * D * F, F}, ue{wu + e * D * F, F};
  const Operand<T, true> we{wd + e * F * D, D};   // Wd^T: (d, f) at f D + d
  float g[kPer][kPer], u[kPer][kPer], da[kPer][kPer];
  zero(g);
  zero(u);
  zero(da);
  product(g, he, ge, m0, C, n0, F, D, xs, ys);
  product(u, he, ue, m0, C, n0, F, D, xs, ys);
  product(da, de, we, m0, C, n0, F, D, xs, ys);
  const int ty = threadIdx.x / kAcross, tx = threadIdx.x % kAcross;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = m0 + ty * kPer + i;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int f = n0 + tx * kPer + j;
      if (c >= C || f >= F) continue;
      const float s = 1.f / (1.f + expf(-g[i][j]));
      const float silu = g[i][j] * s;
      const size_t at = (e * C + c) * F + f;
      act[at] = silu * u[i][j];
      dg[at] = da[i][j] * u[i][j] * (s * (1.f + g[i][j] * (1.f - s)));
      du[at] = da[i][j] * silu;
    }
  }
}

// Passes 2 and 3: out (M, N) of expert blockIdx.z = X Y (+ X2 Y2), rounded
// to TO; x2.p null: one product.
template <typename TX, bool XK, typename TY, bool YK, typename TO>
__global__ void __launch_bounds__(kThreads)
moe_bwd_gemm(Operand<TX, XK> x, Operand<TY, YK> y, Operand<TX, XK> x2,
             Operand<TY, YK> y2, size_t x_batch, size_t y_batch,
             TO* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) float xs[kStep][kTile + kPad];
  __shared__ __align__(16) float ys[kStep][kTile + kPad];
  const size_t e = blockIdx.z;
  const int n0 = blockIdx.x * kTile, m0 = blockIdx.y * kTile;
  x.p += e * x_batch;
  y.p += e * y_batch;
  float acc[kPer][kPer];
  zero(acc);
  product(acc, x, y, m0, M, n0, N, K, xs, ys);
  if (x2.p != nullptr) {
    x2.p += e * x_batch;
    y2.p += e * y_batch;
    product(acc, x2, y2, m0, M, n0, N, K, xs, ys);
  }
  const int ty = threadIdx.x / kAcross, tx = threadIdx.x % kAcross;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int m = m0 + ty * kPer + i;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int n = n0 + tx * kPer + j;
      if (m < M && n < N) store(out + (e * M + m) * N + n, acc[i][j]);
    }
  }
}

dim3 grid(int M, int N, int E) {
  return dim3((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, E);
}

template <typename T>
int launch(const T* h, const T* wg, const T* wu, const T* wd, const T* dout,
           float* act, float* dg, float* du, T* dh, T* dwg, T* dwu, T* dwd,
           int E, int C, int D, int F, cudaStream_t st) {
  const size_t cf = static_cast<size_t>(C) * F;
  const size_t cd = static_cast<size_t>(C) * D;
  const size_t df = static_cast<size_t>(D) * F;
  moe_bwd_act<T><<<grid(C, F, E), kThreads, 0, st>>>(h, wg, wu, wd, dout,
                                                     act, dg, du, C, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // dWd (F, D) = A^T dout: X(f, c) = act[c F + f], Y(c, d) = dout[c D + d]
  const Operand<float, false> none_f{nullptr, 0};
  const Operand<T, false> none_t{nullptr, 0};
  moe_bwd_gemm<float, false, T, false, T><<<grid(F, D, E), kThreads, 0, st>>>(
      Operand<float, false>{act, F}, Operand<T, false>{dout, D}, none_f,
      none_t, cf, cd, dwd, F, D, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // dWg, dWu (D, F) = h^T dG, h^T dU: X(d, c) = h[c D + d], Y(c, f)
  const Operand<T, false> none_x{nullptr, 0};
  const Operand<float, false> none_y{nullptr, 0};
  moe_bwd_gemm<T, false, float, false, T><<<grid(D, F, E), kThreads, 0, st>>>(
      Operand<T, false>{h, D}, Operand<float, false>{dg, F}, none_x, none_y,
      cd, cf, dwg, D, F, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  moe_bwd_gemm<T, false, float, false, T><<<grid(D, F, E), kThreads, 0, st>>>(
      Operand<T, false>{h, D}, Operand<float, false>{du, F}, none_x, none_y,
      cd, cf, dwu, D, F, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // dh (C, D) = dG Wg^T + dU Wu^T: X(c, f) = dG[c F + f], Y(f, d) = W[d F + f]
  moe_bwd_gemm<float, true, T, true, T><<<grid(C, D, E), kThreads, 0, st>>>(
      Operand<float, true>{dg, F}, Operand<T, true>{wg, F},
      Operand<float, true>{du, F}, Operand<T, true>{wu, F}, cf, df, dh, C, D,
      F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dh (E, C, D), dwg and dwu (E, D, F), dwd (E, F, D) of the gated expert
// FFN from h, wg, wu, wd and the output's gradient dout (E, C, D), all
// contiguous and of one type: dtype 0 is f32, 1 is bf16.  scratch is f32
// of 3 E C F elements (A, dG, dU).  Launches the five kernels on `stream`;
// returns the first non-zero cudaError_t (0 = success).
int moe_gmm_bwd_launch(const void* h, const void* wg, const void* wu,
                       const void* wd, const void* dout, void* scratch,
                       void* dh, void* dwg, void* dwu, void* dwd, int dtype,
                       int E, int C, int D, int F, void* stream) {
  if (E < 1 || E > 65535 || C < 1 || D < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* act = static_cast<float*>(scratch);
  const size_t ecf = static_cast<size_t>(E) * C * F;
  float* dg = act + ecf;
  float* du = dg + ecf;
  if (dtype == 0) {
    using T = float;
    return launch<T>(static_cast<const T*>(h), static_cast<const T*>(wg),
                     static_cast<const T*>(wu), static_cast<const T*>(wd),
                     static_cast<const T*>(dout), act, dg, du,
                     static_cast<T*>(dh), static_cast<T*>(dwg),
                     static_cast<T*>(dwu), static_cast<T*>(dwd), E, C, D, F,
                     st);
  }
  if (dtype == 1) {
    using T = __nv_bfloat16;
    return launch<T>(static_cast<const T*>(h), static_cast<const T*>(wg),
                     static_cast<const T*>(wu), static_cast<const T*>(wd),
                     static_cast<const T*>(dout), act, dg, du,
                     static_cast<T*>(dh), static_cast<T*>(dwg),
                     static_cast<T*>(dwu), static_cast<T*>(dwd), E, C, D, F,
                     st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

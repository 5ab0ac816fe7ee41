// Backward of the grouped expert FFN over capacity-padded buffers, for
// Hopper: the eight products of the gated FFN's gradient, bf16 on the
// tensor cores (wgmma) with f32 sums, f32 as tiled products on the CUDA
// cores.
//
// Replaces no TPU kernel.  The JAX package trains through plain jnp (the
// einsum trio of models/moe.py:128-131) and differentiates it with
// jax.grad; the port's forward runs the hand-written moe_gmm.cu, which
// autograd cannot see into, so its gradient is a kernel too.  It computes
// what ref.moe_gmm_bwd_ref computes: for every expert, with h (C, D),
// Wg/Wu (D, F), Wd (F, D) and the output's gradient dout (C, D),
//     G = h Wg,  U = h Wu  (recomputed),  A = act(G) U
//     dWd = A^T dout,   dA = dout Wd^T
//     dG = dA U act'(G),   dU = dA act(G)
//     dWg = h^T dG,  dWu = h^T dU,   dh = dG Wg^T + dU Wu^T
// every sum in f32, each gradient rounded once to the inputs' type.  The
// activation is the config's (models/moe.py:101 of the JAX package), a
// compile-time parameter of the activation pass (ACT, kernel.ACTS):
// silu(g) = g s, silu'(g) = s (1 + g (1 - s)), s = 1 / (1 + e^-g);
// gelu(g) = g (1 + t) / 2, t = tanh(c (g + k g^3)), c = sqrt(2 / pi),
// k = 0.044715 (jax.nn.gelu's tanh form), gelu'(g) = (1 + t) / 2
// + g (1 - t^2) c (1 + 3 k g^2) / 2; relu(g) = max(g, 0), relu'(g) = 1
// where g > 0, else 0 (as jax.grad of jax.nn.relu).
//
// Bound.  Eight products of 2 C D F operations an expert: 16 E C D F.  At
// qwen3-moe's training shape (E 128, C 320 for 4,096 tokens, D 2048, F
// 768) that is 1.03 TFLOP, 1.04 ms at the tensor cores' bf16 989 TFLOP/s
// (15.4 ms at the 67 TFLOP/s of f32 on the CUDA cores); the bytes (h, dout
// and dh, the three weights and their gradients, bf16) are ~2.9 GB, 0.87
// ms.  So the operations bound it, and bf16 runs them on wgmma.
//
// bf16 design (moe_wgmma.cuh).  Three passes, each block two warpgroups
// (256 threads), each warpgroup one 64 x 64 f32 accumulator a product;
// every operand a 64 x 64 bf16 atom staged, 64 of the summed index at a
// time, through a three-stage cp.async ring and read by wgmma straight
// from its row-major rows (K-major, or MN-major through the transpose
// flags: A^T and h^T are MN-major A operands):
//   1. moe_bwd_act_wgmma: a block owns 64 capacity rows x 128 F columns
//      and walks D for G, U (h K-major, Wg/Wu MN-major) and dA (dout and
//      Wd both K-major): three accumulators a thread of 32 floats each;
//      its epilogue writes A, dG and dU, each rounded once to bf16, to
//      bf16 (3, E, C, F) scratch;
//   2. moe_bwd_wgrad_wgmma: dWd (F, D) = A^T dout, and in a second launch
//      dWg, dWu (D, F) = h^T dG, h^T dU from one staged h^T atom, every
//      operand MN-major; a block owns 128 x 64 of each output and walks
//      the capacity rows in order;
//   3. moe_bwd_dh_wgmma: dh (C, D) = dG Wg^T + dU Wu^T, dG/dU and Wg/Wu
//      K-major; a block owns 64 rows x 128 columns and walks F for dG
//      Wg^T, then again for dU Wu^T, into the same accumulator.
// Rows past C, D or F are zero-filled and never stored; where a matrix's
// rows are not a whole number of aligned 16-byte chunks (D or F not a
// multiple of 8, or a tensor off 16 bytes) its atoms are filled by element
// loads.  No atomics, no split over C: each sum runs in one order, so a
// rerun gives the same bits.  Empty capacity rows (h zero) give G = U = 0,
// so dG = dU = 0 and their dh rows are zero whatever dout holds there.
// Rounding (ROADMAP Queue 3, B6): A, dG and dU are rounded to bf16 before
// the products that read them, as the JAX package's compiled bf16 einsum
// trio rounds its intermediates (B1).
//
// f32 design: the same three passes as 64 x 64 output tiles of f32 FMA,
// 256 threads a block holding 4 x 4 sums each, the summed dimension
// walked in steps of 16 staged in shared memory (moe_bwd_act into f32
// scratch, then moe_bwd_gemm for dWd, dWg, dWu and dh, each a launch).
// Every operand is read either along the summed dimension or across the
// tile (the template's XK / YK), with neighbouring threads on
// neighbouring addresses.  Rounding: fmaf explicitly (the library is
// built with -fmad=false), the sigmoid as 1 / (1 + expf(-g)) and gelu's
// tanh as tanhf, in IEEE f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "moe_wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;     // output rows and columns a block
constexpr int kStep = 16;     // summed rows staged at once
constexpr int kPad = 4;       // shared rows padded (bank spread, float4)
constexpr int kPer = 4;       // sums a thread along each tile edge
constexpr int kAcross = kTile / kPer;   // threads along each tile edge

// One expert's operand of a product: element (r, k) at
// p[r * ld + k] when K_CONTIG (the summed index k contiguous), else at
// p[k * ld + r]; r is the output row (of X) or column (of Y).
template <typename T, bool K_CONTIG>
struct Operand {
  const T* p;
  int ld;
  __device__ __forceinline__ float at(int r, int k) const {
    return K_CONTIG ? p[static_cast<size_t>(r) * ld + k]
                    : p[static_cast<size_t>(k) * ld + r];
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

// The gate's activation (kernel.ACTS) and its derivative at g.
enum Act { kSilu = 0, kGelu = 1, kRelu = 2 };

template <int ACT>
__device__ __forceinline__ void activate(float g, float& f, float& df) {
  if constexpr (ACT == kSilu) {
    const float s = 1.f / (1.f + expf(-g));
    f = g * s;
    df = s * (1.f + g * (1.f - s));
  } else if constexpr (ACT == kGelu) {
    constexpr float kC = 0.7978845608028654f, kK = 0.044715f;
    const float t = tanhf(kC * (g + kK * (g * g * g)));
    f = 0.5f * g * (1.f + t);
    df = 0.5f * (1.f + t) +
         0.5f * g * (1.f - t * t) * kC * (1.f + 3.f * kK * (g * g));
  } else {
    f = g > 0.f ? g : 0.f;
    df = g > 0.f ? 1.f : 0.f;
  }
}

// Pass 1: G, U, dA of a (C, F) tile of expert blockIdx.z; A, dG, dU out.
template <typename T, int ACT>
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
      float a, da_dg;
      activate<ACT>(g[i][j], a, da_dg);
      const size_t at = (e * C + c) * F + f;
      act[at] = a * u[i][j];
      dg[at] = da[i][j] * u[i][j] * da_dg;
      du[at] = da[i][j] * a;
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
      if (m < M && n < N) out[(e * M + m) * N + n] = acc[i][j];
    }
  }
}

dim3 grid(int M, int N, int E) {
  return dim3((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, E);
}

// f32: the CUDA-core kernels, f32 scratch; pass 1 with activation ACT
template <int ACT>
int launch_f32(const float* h, const float* wg, const float* wu,
               const float* wd, const float* dout, float* act, float* dg,
               float* du, float* dh, float* dwg, float* dwu, float* dwd,
               int E, int C, int D, int F, cudaStream_t st) {
  using T = float;
  const size_t cf = static_cast<size_t>(C) * F;
  const size_t cd = static_cast<size_t>(C) * D;
  const size_t df = static_cast<size_t>(D) * F;
  moe_bwd_act<T, ACT><<<grid(C, F, E), kThreads, 0, st>>>(
      h, wg, wu, wd, dout, act, dg, du, C, D, F);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // dWd (F, D) = A^T dout: X(f, c) = act[c F + f], Y(c, d) = dout[c D + d]
  const Operand<T, false> none{nullptr, 0};
  moe_bwd_gemm<T, false, T, false, T><<<grid(F, D, E), kThreads, 0, st>>>(
      Operand<T, false>{act, F}, Operand<T, false>{dout, D}, none, none, cf,
      cd, dwd, F, D, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // dWg, dWu (D, F) = h^T dG, h^T dU: X(d, c) = h[c D + d], Y(c, f)
  moe_bwd_gemm<T, false, T, false, T><<<grid(D, F, E), kThreads, 0, st>>>(
      Operand<T, false>{h, D}, Operand<T, false>{dg, F}, none, none, cd, cf,
      dwg, D, F, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  moe_bwd_gemm<T, false, T, false, T><<<grid(D, F, E), kThreads, 0, st>>>(
      Operand<T, false>{h, D}, Operand<T, false>{du, F}, none, none, cd, cf,
      dwu, D, F, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // dh (C, D) = dG Wg^T + dU Wu^T: X(c, f) = dG[c F + f], Y(f, d) = W[d F + f]
  moe_bwd_gemm<T, true, T, true, T><<<grid(C, D, E), kThreads, 0, st>>>(
      Operand<T, true>{dg, F}, Operand<T, true>{wg, F},
      Operand<T, true>{du, F}, Operand<T, true>{wu, F}, cf, df, dh, C, D,
      F);
  return static_cast<int>(cudaGetLastError());
}

// ---------------- bf16: tensor cores (wgmma) ---------------------------------

constexpr int kWThreads = 2 * kWG;   // two warpgroups a block
constexpr int kStages = 3;
constexpr int kActAtoms = 8;         // h, dout, Wg x 2, Wu x 2, Wd x 2

__device__ __forceinline__ void zero(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  fence_regs(d);
}

// Elements i, i + 1 of a thread's fragment at (row, col), (row, col + 1)
// of a row-major (rows x cols) bf16 matrix, rounded once; a pair store
// where cols is even (col is).
__device__ __forceinline__ void store_pair(bf16* out, int cols, int rows,
                                           int row, int col, float x,
                                           float y) {
  if (row >= rows || col >= cols) return;
  bf16* p = out + static_cast<size_t>(row) * cols + col;
  if (cols % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
  } else {
    p[0] = __float2bfloat16_rn(x);
    if (col + 1 < cols) p[1] = __float2bfloat16_rn(y);
  }
}

// whether operand bit b of `vec` is set: 16-byte copies for it
__device__ __forceinline__ bool vec_of(int vec, int b) {
  return (vec >> b) & 1;
}

// Pass 1: G, U, dA of 64 capacity rows x 128 F columns of expert
// blockIdx.z (warpgroup w on columns 64 w ..); A, dG, dU out in bf16.
// vec bits: 0 h, 1 dout, 2 Wg, 3 Wu, 4 Wd.
template <int ACT>
__global__ void __launch_bounds__(kWThreads, 1)
moe_bwd_act_wgmma(const bf16* __restrict__ h, const bf16* __restrict__ wg,
                  const bf16* __restrict__ wu, const bf16* __restrict__ wd,
                  const bf16* __restrict__ dout, bf16* __restrict__ act,
                  bf16* __restrict__ dg, bf16* __restrict__ du, int C, int D,
                  int F, int vec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = aligned_smem(smem_raw);
  const size_t e = blockIdx.z;
  const int c0 = blockIdx.y * kAtom, f0 = blockIdx.x * 2 * kAtom;
  const int t = threadIdx.x, w = t / kWG, tw = t % kWG;
  const bf16* he = h + e * C * D;
  const bf16* oe = dout + e * C * D;
  const bf16* ge = wg + e * D * F;
  const bf16* ue = wu + e * D * F;
  const bf16* de = wd + e * F * D;
  float g[32], u[32], da[32];
  zero(g);
  zero(u);
  zero(da);
  pipeline<kStages, kActAtoms * kAtomBytes>(
      ring, (D + kAtom - 1) / kAtom,
      [&](uint32_t s, int step) {
        const int k0 = step * kAtom;
        load_atom<kWThreads>(s, he, D, C, c0, k0, vec_of(vec, 0), t);
        load_atom<kWThreads>(s + kAtomBytes, oe, D, C, c0, k0,
                             vec_of(vec, 1), t);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int fj = f0 + j * kAtom;
          load_atom<kWThreads>(s + (2 + j) * kAtomBytes, ge, F, D, k0, fj,
                               vec_of(vec, 2), t);
          load_atom<kWThreads>(s + (4 + j) * kAtomBytes, ue, F, D, k0, fj,
                               vec_of(vec, 3), t);
          load_atom<kWThreads>(s + (6 + j) * kAtomBytes, de, D, F, fj, k0,
                               vec_of(vec, 4), t);
        }
      },
      [&](uint32_t s) {
        wgmma_fence();
        mma_atoms<0, 1>(g, s, s + (2 + w) * kAtomBytes);    // h Wg
        mma_atoms<0, 1>(u, s, s + (4 + w) * kAtomBytes);    // h Wu
        mma_atoms<0, 0>(da, s + kAtomBytes, s + (6 + w) * kAtomBytes);
        wgmma_commit();
        wgmma_wait();
      });
  fence_regs(g);
  fence_regs(u);
  fence_regs(da);
  const size_t base = e * C * F;
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int c = c0 + frag_row(tw, i), f = f0 + w * kAtom + frag_col(tw, i);
    float a[2], dgv[2], duv[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float f, df;
      activate<ACT>(g[i + j], f, df);
      a[j] = f * u[i + j];
      dgv[j] = da[i + j] * u[i + j] * df;
      duv[j] = da[i + j] * f;
    }
    store_pair(act + base, F, C, c, f, a[0], a[1]);
    store_pair(dg + base, F, C, c, f, dgv[0], dgv[1]);
    store_pair(du + base, F, C, c, f, duv[0], duv[1]);
  }
}

// Pass 2: out_b (M, N) = X^T Y_b of expert blockIdx.z over its C capacity
// rows, X (C, M) and Y_b (C, N) row-major (every operand MN-major); NB
// products share the staged X.  A block owns 128 rows x 64 columns
// (warpgroup w on rows 64 w ..).  vec bits: 0 X, 1 Y_0, 2 Y_1.
template <int NB>
__global__ void __launch_bounds__(kWThreads, 2)
moe_bwd_wgrad_wgmma(const bf16* __restrict__ x, const bf16* __restrict__ y0,
                    const bf16* __restrict__ y1, bf16* __restrict__ o0,
                    bf16* __restrict__ o1, int C, int M, int N, int vec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = aligned_smem(smem_raw);
  const size_t e = blockIdx.z;
  const int m0 = blockIdx.y * 2 * kAtom, n0 = blockIdx.x * kAtom;
  const int t = threadIdx.x, w = t / kWG, tw = t % kWG;
  const bf16* xe = x + e * C * M;
  const bf16* ye[2] = {y0 + e * C * N, NB > 1 ? y1 + e * C * N : nullptr};
  bf16* oe[2] = {o0 + e * M * N, NB > 1 ? o1 + e * M * N : nullptr};
  float acc[NB][32];
#pragma unroll
  for (int b = 0; b < NB; ++b) zero(acc[b]);
  pipeline<kStages, (2 + NB) * kAtomBytes>(
      ring, (C + kAtom - 1) / kAtom,
      [&](uint32_t s, int step) {
        const int k0 = step * kAtom;
#pragma unroll
        for (int j = 0; j < 2; ++j)
          load_atom<kWThreads>(s + j * kAtomBytes, xe, M, C, k0,
                               m0 + j * kAtom, vec_of(vec, 0), t);
#pragma unroll
        for (int b = 0; b < NB; ++b)
          load_atom<kWThreads>(s + (2 + b) * kAtomBytes, ye[b], N, C, k0, n0,
                               vec_of(vec, 1 + b), t);
      },
      [&](uint32_t s) {
        wgmma_fence();
#pragma unroll
        for (int b = 0; b < NB; ++b)
          mma_atoms<1, 1>(acc[b], s + w * kAtomBytes,
                          s + (2 + b) * kAtomBytes);
        wgmma_commit();
        wgmma_wait();
      });
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    fence_regs(acc[b]);
#pragma unroll
    for (int i = 0; i < 32; i += 2)
      store_pair(oe[b], N, M, m0 + w * kAtom + frag_row(tw, i),
                 n0 + frag_col(tw, i), acc[b][i], acc[b][i + 1]);
  }
}

// Pass 3: dh (C, D) = dG Wg^T + dU Wu^T of expert blockIdx.z, F walked for
// the first product, then again for the second, into one accumulator;
// every operand K-major.  A block owns 64 rows x 128 columns (warpgroup w
// on columns 64 w ..).  vec bits: 0 dG, 1 dU, 2 Wg, 3 Wu.
__global__ void __launch_bounds__(kWThreads, 2)
moe_bwd_dh_wgmma(const bf16* __restrict__ dg, const bf16* __restrict__ du,
                 const bf16* __restrict__ wg, const bf16* __restrict__ wu,
                 bf16* __restrict__ dh, int C, int D, int F, int vec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t ring = aligned_smem(smem_raw);
  const size_t e = blockIdx.z;
  const int c0 = blockIdx.y * kAtom, d0 = blockIdx.x * 2 * kAtom;
  const int t = threadIdx.x, w = t / kWG, tw = t % kWG;
  const int nf = (F + kAtom - 1) / kAtom;
  float acc[32];
  zero(acc);
  pipeline<kStages, 3 * kAtomBytes>(
      ring, 2 * nf,
      [&](uint32_t s, int step) {
        const int second = step >= nf, k0 = (step - second * nf) * kAtom;
        const bf16* xe = (second ? du : dg) + e * C * F;
        const bf16* we = (second ? wu : wg) + e * D * F;
        load_atom<kWThreads>(s, xe, F, C, c0, k0, vec_of(vec, second), t);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          load_atom<kWThreads>(s + (1 + j) * kAtomBytes, we, F, D,
                               d0 + j * kAtom, k0, vec_of(vec, 2 + second),
                               t);
      },
      [&](uint32_t s) {
        wgmma_fence();
        mma_atoms<0, 0>(acc, s, s + (1 + w) * kAtomBytes);
        wgmma_commit();
        wgmma_wait();
      });
  fence_regs(acc);
#pragma unroll
  for (int i = 0; i < 32; i += 2)
    store_pair(dh + e * C * D, D, C, c0 + frag_row(tw, i),
               d0 + w * kAtom + frag_col(tw, i), acc[i], acc[i + 1]);
}

// One 64 x 64 x 64 product in each orientation the kernels use, through
// their loads (16-byte copies if vec, else element loads), descriptors
// and wgmma: out[0] = x y (x K-major A, y MN-major B), out[1] = x y^T
// (both K-major), out[2] = x^T y (both MN-major); x, y (64, 64) bf16, out
// (3, 64, 64) f32.
__global__ void __launch_bounds__(kWG)
wgmma_probe_products(const bf16* __restrict__ x, const bf16* __restrict__ y,
                     float* __restrict__ out, int vec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t xs = aligned_smem(smem_raw), ys = xs + kAtomBytes;
  const int t = threadIdx.x;
  load_atom<kWG>(xs, x, kAtom, kAtom, 0, 0, vec, t);
  load_atom<kWG>(ys, y, kAtom, kAtom, 0, 0, vec, t);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();
  __syncthreads();
  float acc[3][32];
#pragma unroll
  for (int p = 0; p < 3; ++p) zero(acc[p]);
  wgmma_fence();
  mma_atoms<0, 1>(acc[0], xs, ys);
  mma_atoms<0, 0>(acc[1], xs, ys);
  mma_atoms<1, 1>(acc[2], xs, ys);
  wgmma_commit();
  wgmma_wait();
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    fence_regs(acc[p]);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      out[p * kAtom * kAtom + frag_row(t, i) * kAtom + frag_col(t, i)] =
          acc[p][i];
  }
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

int vec_bit(const void* p, int ld, int bit) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0) << bit;
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

// bf16: the wgmma kernels, bf16 scratch; pass 1 with activation ACT
template <int ACT>
int launch_wgmma(const bf16* h, const bf16* wg, const bf16* wu,
                 const bf16* wd, const bf16* dout, bf16* act, bf16* dg,
                 bf16* du, bf16* dh, bf16* dwg, bf16* dwu, bf16* dwd, int E,
                 int C, int D, int F, cudaStream_t st) {
  constexpr size_t act_bytes = kStages * kActAtoms * kAtomBytes + 1024;
  constexpr size_t dwd_bytes = kStages * 3 * kAtomBytes + 1024;
  constexpr size_t dwgu_bytes = kStages * 4 * kAtomBytes + 1024;
  constexpr size_t dh_bytes = kStages * 3 * kAtomBytes + 1024;
  cudaError_t err;
  if ((err = allow_smem(moe_bwd_act_wgmma<ACT>, act_bytes)) !=
          cudaSuccess ||
      (err = allow_smem(moe_bwd_wgrad_wgmma<1>, dwd_bytes)) != cudaSuccess ||
      (err = allow_smem(moe_bwd_wgrad_wgmma<2>, dwgu_bytes)) != cudaSuccess ||
      (err = allow_smem(moe_bwd_dh_wgmma, dh_bytes)) != cudaSuccess)
    return static_cast<int>(err);
  moe_bwd_act_wgmma<ACT><<<dim3(cdiv(F, 2 * kAtom), cdiv(C, kAtom), E),
                           kWThreads, act_bytes, st>>>(
      h, wg, wu, wd, dout, act, dg, du, C, D, F,
      vec_bit(h, D, 0) | vec_bit(dout, D, 1) | vec_bit(wg, F, 2) |
          vec_bit(wu, F, 3) | vec_bit(wd, D, 4));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // dWd (F, D) = A^T dout
  moe_bwd_wgrad_wgmma<1><<<dim3(cdiv(D, kAtom), cdiv(F, 2 * kAtom), E),
                           kWThreads, dwd_bytes, st>>>(
      act, dout, nullptr, dwd, nullptr, C, F, D,
      vec_bit(act, F, 0) | vec_bit(dout, D, 1));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // dWg, dWu (D, F) = h^T dG, h^T dU
  moe_bwd_wgrad_wgmma<2><<<dim3(cdiv(F, kAtom), cdiv(D, 2 * kAtom), E),
                           kWThreads, dwgu_bytes, st>>>(
      h, dg, du, dwg, dwu, C, D, F,
      vec_bit(h, D, 0) | vec_bit(dg, F, 1) | vec_bit(du, F, 2));
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  // dh (C, D) = dG Wg^T + dU Wu^T
  moe_bwd_dh_wgmma<<<dim3(cdiv(D, 2 * kAtom), cdiv(C, kAtom), E), kWThreads,
                     dh_bytes, st>>>(
      dg, du, wg, wu, dh, C, D, F,
      vec_bit(dg, F, 0) | vec_bit(du, F, 1) | vec_bit(wg, F, 2) |
          vec_bit(wu, F, 3));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dh (E, C, D), dwg and dwu (E, D, F), dwd (E, F, D) of the gated expert
// FFN from h, wg, wu, wd and the output's gradient dout (E, C, D), all
// contiguous and of one type: dtype 0 is f32 (the CUDA cores), 1 is bf16
// (wgmma); activation 0 is silu, 1 gelu (tanh form), 2 relu.  scratch
// holds 3 E C F elements (A, dG, dU) of that type.
// Launches the kernels on `stream` (five for f32, four for bf16); returns
// the first non-zero cudaError_t (0 = success).
int moe_gmm_bwd_launch(const void* h, const void* wg, const void* wu,
                       const void* wd, const void* dout, void* scratch,
                       void* dh, void* dwg, void* dwu, void* dwd, int dtype,
                       int activation, int E, int C, int D, int F,
                       void* stream) {
  if (E < 1 || E > 65535 || C < 1 || D < 1 || F < 1 || activation < kSilu ||
      activation > kRelu)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t ecf = static_cast<size_t>(E) * C * F;
  if (dtype == 0) {
    using T = float;
    T* act = static_cast<T*>(scratch);
    const auto run = activation == kSilu   ? launch_f32<kSilu>
                     : activation == kGelu ? launch_f32<kGelu>
                                           : launch_f32<kRelu>;
    return run(static_cast<const T*>(h), static_cast<const T*>(wg),
               static_cast<const T*>(wu), static_cast<const T*>(wd),
               static_cast<const T*>(dout), act, act + ecf, act + 2 * ecf,
               static_cast<T*>(dh), static_cast<T*>(dwg),
               static_cast<T*>(dwu), static_cast<T*>(dwd), E, C, D, F, st);
  }
  if (dtype == 1) {
    using T = bf16;
    T* act = static_cast<T*>(scratch);
    const auto run = activation == kSilu   ? launch_wgmma<kSilu>
                     : activation == kGelu ? launch_wgmma<kGelu>
                                           : launch_wgmma<kRelu>;
    return run(static_cast<const T*>(h), static_cast<const T*>(wg),
               static_cast<const T*>(wu), static_cast<const T*>(wd),
               static_cast<const T*>(dout), act, act + ecf, act + 2 * ecf,
               static_cast<T*>(dh), static_cast<T*>(dwg),
               static_cast<T*>(dwu), static_cast<T*>(dwd), E, C, D, F, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wgmma products alone (bf16 x, y (64, 64); f32 out (3, 64, 64) = x y,
// x y^T, x^T y), atoms filled by 16-byte copies if vec, else by element
// loads: one block on `stream`.
int moe_wgmma_probe(const void* x, const void* y, void* out, int vec,
                    void* stream) {
  constexpr size_t bytes = 2 * kAtomBytes + 1024;
  cudaError_t err = allow_smem(wgmma_probe_products, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_probe_products<<<1, kWG, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(y),
      static_cast<float*>(out), vec);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

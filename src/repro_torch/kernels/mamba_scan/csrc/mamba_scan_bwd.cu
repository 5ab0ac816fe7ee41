// Backward of the Mamba-1 selective scan, for Hopper.
//
// Replaces no TPU kernel.  The JAX package trains through plain jnp
// (models/ssm.py:58-118, a chunked associative scan) and differentiates it
// with jax.grad; the port's forward runs the hand-written mamba_scan.cu,
// which autograd cannot see into, so its gradient is a kernel too.  It
// computes what ref.mamba_scan_bwd_ref computes: with e_t[n] = exp(dt_t
// A[d, n]) and the states h_t of the forward (h_{-1} = 0), the state's
// gradient g walked from the end,
//     g_{S-1} = dh_S + C_{S-1} dy_{S-1},   g_t = e_{t+1} g_{t+1} + C_t dy_t
// and from it, for each batch row b and channel d,
//     dx_t    = dy_t D + dt_t sum_n g_t B_t
//     ddt_t   = sum_n g_t (A e_t h_{t-1} + x_t B_t)
//     dB_t[n] = sum_d g_t dt_t x_t,    dC_t[n] = sum_d dy_t h_t
//     dA      = sum_{b,t} g_t dt_t e_t h_{t-1},    dD = sum_{b,t} dy_t x_t
// all in f32; dx rounded once to x's type, ddt, dB and dC to dt's.
//
// Bound.  Per (b, t, d) the function reads x, dt and dy and writes dx and
// ddt; per (b, t) it reads B and C and writes dB and dC.  At
// falcon-mamba-7b's training shape (B 1, S 4096, D 8192, N 16; x bf16,
// the rest f32) that is 16 B a (t, d), ~0.54 GB, 0.16 ms at 3.35 TB/s.
// The work is ~22 f32 operations a (b, t, d, n) (the states rebuilt, g's
// step, five products and their sums), 11.8 G there, 0.18 ms at 67
// TFLOP/s, and one exponential, 0.54 G, 0.13 ms on the SFU at 16 a clock
// an SM (1.98 GHz): the operations bound it.
//
// Design.  The forward keeps no state but h_S, and the walk needs h_{t-1}
// from the end.  One block owns 32 channels of one batch row, as the
// forward's does (Split: N rounded up to a power of two NP, L lanes of K =
// 2 states a channel), and runs two phases:
//   A. the forward walk of the whole sequence, writing the state before
//      each chunk of kChunk = 16 steps to an f32 (B, nc, D, N) scratch;
//   B. the chunks from the last: the chunk's inputs staged in shared
//      memory, its 16 states rebuilt in registers from the stored state
//      (17 x K floats a thread), then its steps walked from the last with
//      g carried in registers.
// So each exponential is computed three times: in phase A, to rebuild the
// chunk and in the walk (keeping the chunk's 16 x K exponentials in
// registers too spilled at N 16 and two blocks an SM).  The floor above
// is the function's, with one.  A block holds all of a channel's states, so
// dx and ddt are its own: their sums over n are K multiply-adds in the
// thread and log2 L shuffles, gathered a chunk at a time in shared memory
// and written as rows of 32 channels.  dB and dC sum over every channel:
// each step's K products a thread are added over the warp's channels by
// shuffles in a fixed order, the warps' sums in shared memory in warp
// order, and each block writes its partial sums to an f32 (B, nblk, S, N)
// scratch.  dA and dD sum over b and t: each thread adds its (d, n) over
// t in registers and writes a (B, D, N) / (B, D) partial.  A second
// kernel, mamba_scan_bwd_sum, adds the partials over the blocks and over
// b in order and rounds dB and dC.  No atomics: the same bits every run.
// Steps past S and lanes past N run on zeros (dt = dy = 0: e = 1, and
// B = C = 0), so they leave g as it is and add nothing; only the writes
// are masked.  exp(dt A) is ex2.approx.ftz as in the forward, and the
// state's update keeps the forward's rounding (-fmad=false), so phase B
// rebuilds the forward's states bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kChannels = 32;   // channels a block
constexpr int kChunk = 16;      // sequence steps a chunk
constexpr int kMaxState = 32;
constexpr int kSumThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// NP = N rounded up to a power of two, as L lanes of K states
template <int NP>
struct Split {
  static constexpr int K = NP < 2 ? NP : 2;
  static constexpr int L = NP / K;
  static constexpr int kThreads = kChannels * L;
  static constexpr int kWarps = (kThreads + 31) / 32;
  // blocks an SM: two, but one at N 32 (512 threads), where two would
  // leave 64 registers a thread for the chunk's 34 states and the rest
  static constexpr int kMinBlocks = NP < 32 ? 2 : 1;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// 2^x on the SFU; results below 2^-126 flush to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename TX, typename TP, int NP>
__global__ void __launch_bounds__(Split<NP>::kThreads, Split<NP>::kMinBlocks)
mamba_scan_bwd(const TX* __restrict__ x, const TP* __restrict__ dt,
               const TP* __restrict__ bm, const TP* __restrict__ cm,
               const float* __restrict__ a, const float* __restrict__ dskip,
               const float* __restrict__ dy,
               const float* __restrict__ dh_last,   // null: zero
               float* __restrict__ states, TX* __restrict__ dx,
               TP* __restrict__ ddt, float* __restrict__ part_b,
               float* __restrict__ part_c, float* __restrict__ part_a,
               float* __restrict__ part_d, int s_len, int dim,
               int n_state) {
  constexpr int K = Split<NP>::K, L = Split<NP>::L;
  constexpr int NT = Split<NP>::kThreads, W = Split<NP>::kWarps;
  __shared__ float xs[kChunk][kChannels], ds[kChunk][kChannels];
  __shared__ float gs[kChunk][kChannels];          // dy
  __shared__ float dxs[kChunk][kChannels], dts[kChunk][kChannels];
  __shared__ float bs[kChunk][NP], cs[kChunk][NP];
  // the warps' sums of dB and dC, [kChunk][W][NP] each (64 KB at N 32)
  extern __shared__ float4 red4[];
  float (*red_b)[W][NP] = reinterpret_cast<float (*)[W][NP]>(red4);
  float (*red_c)[W][NP] = red_b + kChunk;

  const int tid = threadIdx.x;
  const int c = tid / L;   // channel within the block
  const int j = tid % L;   // lane: states j K .. j K + K - 1
  const int warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.y;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int d0 = blk * kChannels;
  const int d = d0 + c;
  const bool live_d = d < dim;
  const size_t row0 = static_cast<size_t>(b) * s_len;
  const int n_chunks = (s_len + kChunk - 1) / kChunk;

  float av[K], a2[K], h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = j * K + k;
    av[k] = live_d && n < n_state ? a[static_cast<size_t>(d) * n_state + n]
                                  : 0.f;
    a2[k] = av[k] * kLog2e;
    h[k] = 0.f;
  }
  const float dd = live_d ? dskip[d] : 0.f;
  // the state before chunk q of this thread's states, in the scratch
  auto state_at = [&](int q, int k) -> float* {
    return states + ((static_cast<size_t>(b) * n_chunks + q) * dim + d)
                    * n_state + j * K + k;
  };
  auto live_n = [&](int k) { return live_d && j * K + k < n_state; };

  // The chunk at s0 into shared memory as f32, zero past S, D and N: x, dt
  // and B, and for phase B also C and dy.
  auto stage = [&](int s0, bool all) {
    const int steps = min(kChunk, s_len - s0);
    for (int e = tid; e < kChunk * kChannels; e += NT) {
      const int tt = e / kChannels, cc = e % kChannels;
      const bool in = tt < steps && d0 + cc < dim;
      const size_t at = (row0 + s0 + tt) * dim + d0 + cc;
      xs[tt][cc] = in ? to_f32(x[at]) : 0.f;
      ds[tt][cc] = in ? to_f32(dt[at]) : 0.f;
      if (all) gs[tt][cc] = in ? dy[at] : 0.f;
    }
    for (int e = tid; e < kChunk * NP; e += NT) {
      const int tt = e / NP, nn = e % NP;
      const bool in = tt < steps && nn < n_state;
      const size_t at = (row0 + s0 + tt) * n_state + nn;
      bs[tt][nn] = in ? to_f32(bm[at]) : 0.f;
      if (all) cs[tt][nn] = in ? to_f32(cm[at]) : 0.f;
    }
  };

  // Phase A: the forward walk, the state before every chunk kept.
  for (int q = 0; q < n_chunks; ++q) {
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (live_n(k)) *state_at(q, k) = h[k];
    __syncthreads();   // the last chunk's reads are done
    stage(q * kChunk, false);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const float dbx = ds[t][c] * xs[t][c];
#pragma unroll
      for (int k = 0; k < K; ++k)
        h[k] = ex2(ds[t][c] * a2[k]) * h[k] + dbx * bs[t][j * K + k];
    }
  }

  // Phase B: the chunks from the last, g carried from dh_S.
  float g[K], sum_a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    g[k] = dh_last != nullptr && live_n(k)
        ? dh_last[(static_cast<size_t>(b) * dim + d) * n_state + j * K + k]
        : 0.f;
    sum_a[k] = 0.f;
  }
  float sum_d = 0.f;
  for (int q = n_chunks - 1; q >= 0; --q) {
    const int s0 = q * kChunk;
    const int steps = min(kChunk, s_len - s0);
    __syncthreads();   // the last chunk's shared reads are done
    stage(s0, true);
    __syncthreads();
    // the chunk's states, rebuilt: hs[t + 1] is h_t, hs[0] the state
    // before the chunk
    float hs[kChunk + 1][K];
#pragma unroll
    for (int k = 0; k < K; ++k) hs[0][k] = live_n(k) ? *state_at(q, k) : 0.f;
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const float dbx = ds[t][c] * xs[t][c];
#pragma unroll
      for (int k = 0; k < K; ++k)
        hs[t + 1][k] = ex2(ds[t][c] * a2[k]) * hs[t][k]
                       + dbx * bs[t][j * K + k];
    }
#pragma unroll
    for (int t = kChunk - 1; t >= 0; --t) {
      const float xv = xs[t][c], dv = ds[t][c], gy = gs[t][c];
      const float dvx = dv * xv;
      float px = 0.f, pdt = 0.f, vb[K], vc[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int n = j * K + k;
        const float hp = hs[t][k];   // h_{t-1}
        const float e = ex2(dv * a2[k]);
        g[k] = g[k] + cs[t][n] * gy;
        px = __fmaf_rn(g[k], bs[t][n], px);
        pdt = __fmaf_rn(g[k], av[k] * e * hp + xv * bs[t][n], pdt);
        vb[k] = g[k] * dvx;
        vc[k] = gy * hs[t + 1][k];
        sum_a[k] = __fmaf_rn(g[k] * dv, e * hp, sum_a[k]);
        g[k] = e * g[k];
      }
      sum_d = __fmaf_rn(gy, xv, sum_d);
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
        px += __shfl_xor_sync(0xffffffffu, px, off, L);
        pdt += __shfl_xor_sync(0xffffffffu, pdt, off, L);
      }
      if (j == t % L) {
        dxs[t][c] = __fmaf_rn(px, dv, gy * dd);
        dts[t][c] = pdt;
      }
      // dB, dC: the warp's channels added, lanes L apart, pairwise
#pragma unroll
      for (int off = L; off < 32; off <<= 1)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          vb[k] += __shfl_xor_sync(0xffffffffu, vb[k], off);
          vc[k] += __shfl_xor_sync(0xffffffffu, vc[k], off);
        }
      if (lane < L)
#pragma unroll
        for (int k = 0; k < K; ++k) {
          red_b[t][warp][j * K + k] = vb[k];
          red_c[t][warp][j * K + k] = vc[k];
        }
    }
    __syncthreads();   // dxs, dts and the warps' sums complete
    for (int e = tid; e < kChunk * kChannels; e += NT) {
      const int tt = e / kChannels, cc = e % kChannels;
      if (tt < steps && d0 + cc < dim) {
        const size_t at = (row0 + s0 + tt) * dim + d0 + cc;
        store(dx + at, dxs[tt][cc]);
        store(ddt + at, dts[tt][cc]);
      }
    }
    for (int e = tid; e < kChunk * NP; e += NT) {
      const int tt = e / NP, nn = e % NP;
      if (tt >= steps || nn >= n_state) continue;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        sb += red_b[tt][w][nn];
        sc += red_c[tt][w][nn];
      }
      const size_t at =
          ((static_cast<size_t>(b) * nblk + blk) * s_len + s0 + tt) * n_state
          + nn;
      part_b[at] = sb;
      part_c[at] = sc;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k)
    if (live_n(k))
      part_a[(static_cast<size_t>(b) * dim + d) * n_state + j * K + k] =
          sum_a[k];
  if (live_d && j == 0) part_d[static_cast<size_t>(b) * dim + d] = sum_d;
}

// dB, dC (B, S, N): the blocks' partials added in block order, rounded to
// TP; dA (D, N) and dD (D,): the batch rows' partials added in order.
template <typename TP>
__global__ void __launch_bounds__(kSumThreads)
mamba_scan_bwd_sum(const float* __restrict__ part_b,
                   const float* __restrict__ part_c,
                   const float* __restrict__ part_a,
                   const float* __restrict__ part_d, TP* __restrict__ dbm,
                   TP* __restrict__ dcm, float* __restrict__ da,
                   float* __restrict__ dskip_grad, int bsz, int nblk,
                   int s_len, int dim, int n_state) {
  const size_t i = static_cast<size_t>(blockIdx.x) * kSumThreads
                   + threadIdx.x;
  const size_t sn = static_cast<size_t>(s_len) * n_state;
  if (i < bsz * sn) {
    const size_t b = i / sn, r = i - b * sn;
    float sb = 0.f, sc = 0.f;
    for (int k = 0; k < nblk; ++k) {
      const size_t at = (b * nblk + k) * sn + r;
      sb += part_b[at];
      sc += part_c[at];
    }
    store(dbm + i, sb);
    store(dcm + i, sc);
  }
  const size_t dn = static_cast<size_t>(dim) * n_state;
  if (i < dn) {
    float s = 0.f;
    for (int b = 0; b < bsz; ++b) s += part_a[b * dn + i];
    da[i] = s;
  }
  if (i < static_cast<size_t>(dim)) {
    float s = 0.f;
    for (int b = 0; b < bsz; ++b)
      s += part_d[static_cast<size_t>(b) * dim + i];
    dskip_grad[i] = s;
  }
}

struct Args {
  const void *x, *dt, *bm, *cm;
  const float *a, *dskip, *dy, *dh_last;
  float* scratch;
  void *dx, *ddt, *dbm, *dcm;
  float *da, *dd;
  int bsz, s_len, dim, n_state;
};

// The scratch's parts, in order: states (B, nc, D, N), part_b and part_c
// (B, nblk, S, N), part_a (B, D, N), part_d (B, D).
long long scratch_floats(int bsz, int s_len, int dim, int n_state) {
  const long long nc = (s_len + kChunk - 1) / kChunk;
  const long long nblk = (dim + kChannels - 1) / kChannels;
  return bsz * (nc * dim * n_state + 2 * nblk * s_len * n_state
                + static_cast<long long>(dim) * n_state + dim);
}

template <typename TX, typename TP, int NP>
int launch_np(const Args& p, cudaStream_t st) {
  const int nblk = (p.dim + kChannels - 1) / kChannels;
  const long long nc = (p.s_len + kChunk - 1) / kChunk;
  float* states = p.scratch;
  float* part_b = states + p.bsz * nc * p.dim * p.n_state;
  float* part_c = part_b + static_cast<long long>(p.bsz) * nblk * p.s_len
                  * p.n_state;
  float* part_a = part_c + static_cast<long long>(p.bsz) * nblk * p.s_len
                  * p.n_state;
  float* part_d = part_a + static_cast<long long>(p.bsz) * p.dim * p.n_state;
  const auto kernel = mamba_scan_bwd<TX, TP, NP>;
  const int smem = 2 * kChunk * Split<NP>::kWarps * NP * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3(nblk, p.bsz), Split<NP>::kThreads, smem, st>>>(
      static_cast<const TX*>(p.x), static_cast<const TP*>(p.dt),
      static_cast<const TP*>(p.bm), static_cast<const TP*>(p.cm), p.a,
      p.dskip, p.dy, p.dh_last, states, static_cast<TX*>(p.dx),
      static_cast<TP*>(p.ddt), part_b, part_c, part_a, part_d, p.s_len,
      p.dim, p.n_state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = std::max(
      static_cast<long long>(p.bsz) * p.s_len * p.n_state,
      static_cast<long long>(p.dim) * p.n_state);
  const long long blocks = (items + kSumThreads - 1) / kSumThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  mamba_scan_bwd_sum<TP><<<static_cast<unsigned>(blocks), kSumThreads, 0,
                           st>>>(
      part_b, part_c, part_a, part_d, static_cast<TP*>(p.dbm),
      static_cast<TP*>(p.dcm), p.da, p.dd, p.bsz, nblk, p.s_len, p.dim,
      p.n_state);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TP>
int launch(const Args& p, cudaStream_t st) {
  if (p.n_state <= 1) return launch_np<TX, TP, 1>(p, st);
  if (p.n_state <= 2) return launch_np<TX, TP, 2>(p, st);
  if (p.n_state <= 4) return launch_np<TX, TP, 4>(p, st);
  if (p.n_state <= 8) return launch_np<TX, TP, 8>(p, st);
  if (p.n_state <= 16) return launch_np<TX, TP, 16>(p, st);
  return launch_np<TX, TP, 32>(p, st);
}

template <typename TX>
int launch_p(const Args& p, int p_dtype, cudaStream_t st) {
  if (p_dtype == 0) return launch<TX, float>(p, st);
  if (p_dtype == 1) return launch<TX, __nv_bfloat16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Floats of the scratch that mamba_scan_bwd_launch needs.
long long mamba_scan_bwd_scratch_floats(int bsz, int s_len, int dim,
                                        int n_state) {
  return scratch_floats(bsz, s_len, dim, n_state);
}

// dx (B, S, D) in x's type, ddt (B, S, D), dbm and dcm (B, S, N) in dt's
// type, da (D, N) and dd (D,) f32, from the forward's inputs (x, dt, bm,
// cm, a, dskip as mamba_scan_launch takes them), dy (B, S, D) f32 and
// dh_last (B, D, N) f32 or null (zero), all contiguous.  x_dtype is x's
// type, p_dtype that of dt, bm and cm: 0 f32, 1 bf16.  1 <= N <= 32.
// `scratch` is f32 of mamba_scan_bwd_scratch_floats elements.  Launches
// both kernels on `stream`; returns the first non-zero cudaError_t (0 =
// success).
int mamba_scan_bwd_launch(const void* x, const void* dt, const void* bm,
                          const void* cm, const void* a, const void* dskip,
                          const void* dy, const void* dh_last, void* scratch,
                          void* dx, void* ddt, void* dbm, void* dcm, void* da,
                          void* dd, int x_dtype, int p_dtype, int bsz,
                          int s_len, int dim, int n_state, void* stream) {
  if (bsz < 1 || bsz > 65535 || s_len < 1 || dim < 1 || n_state < 1 ||
      n_state > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{x, dt, bm, cm,
               static_cast<const float*>(a), static_cast<const float*>(dskip),
               static_cast<const float*>(dy),
               static_cast<const float*>(dh_last),
               static_cast<float*>(scratch), dx, ddt, dbm, dcm,
               static_cast<float*>(da), static_cast<float*>(dd),
               bsz, s_len, dim, n_state};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch_p<float>(p, p_dtype, st);
  if (x_dtype == 1) return launch_p<__nv_bfloat16>(p, p_dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

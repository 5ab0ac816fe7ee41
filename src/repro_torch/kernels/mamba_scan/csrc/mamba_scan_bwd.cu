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
// Design.  The forward kernel keeps the state before every 16-step chunk
// (mamba_scan.cu's `states`, (B, ceil(S / 16), D, N) f32), so nothing here
// walks the forward again.  g obeys a linear recurrence, so the sequence
// is split into chunks of kChunk = 64 steps across blocks, in three
// passes, as rglru_scan.cu splits its scan:
//   mamba_scan_bwd_local  a block a (b, 64 channels, chunk >= 1): the
//                         chunk's g walked back from zero, its value out
//                         of the chunk's first step (e_{t0} g_{t0}) and
//                         the chunk's decay, the product of its e_t (free
//                         beside the exponentials, which bound this pass,
//                         and rounded as the main pass's walk is);
//   mamba_scan_bwd_carry  a thread a (b, d, n): the carries into every
//                         chunk from dh_S, serial over the S / 64 chunks,
//                         G_{c-1} = out_c + P_c G_c, 16 chunks' loads in
//                         flight together;
//   mamba_scan_bwd_main   a block a (b, 64 channels, span of kSpan = 2
//                         chunks), from the carry into the span's last
//                         chunk: its 16-step pieces from the last, each
//                         rebuilt from its saved state, then walked back
//                         with g carried through, writing dx and ddt and
//                         per-block partial sums of dB, dC (a (b, block,
//                         t, n) row), dA and dD (a (b, span, d, n) row);
//                         each piece's inputs staged in shared memory while
//                         the next piece's rows are prefetched into L2;
//   mamba_scan_bwd_sum    the partials added in a fixed order (channel
//                         blocks, then spans and batch rows), dB and dC
//                         rounded.
// At B 1 that is 128 x 32 main-pass blocks of 256 threads, against the one
// wave of 256 blocks that a block per channel tile and the whole sequence
// gives.  Exponentials: one a state and step in the local pass and one in
// the main pass's rebuild, which keeps its 16 steps' e_t in registers for
// the walk (and u_t = e_t h_{t-1}, the first product of the state's
// update, in shared memory): two, against the floor's one.
// Lanes: a thread holds K = 4 states of one channel (NP = N rounded up to
// a power of two, L = NP / K lanes a channel; N 16: 4 lanes), so the sums
// over n of dx and ddt are K multiply-adds in the thread and log2 L
// shuffles; ddt's x_t B_t term is x_t times dx's own sum.  dB and dC sum
// over channels: each step's K products a thread are added over the
// warp's channels by recursive halving (each level keeps half the values
// and takes the partner's half of the others), so a lane ends with one
// (t, n) sum, then in shared memory over the warps in warp order.  dC
// does not depend on g, so it is summed in the rebuild.
// What binds it: at N 16 the 64 registers of e_t hold the main pass at 2
// blocks of 256 threads an SM (16 warps, 128 registers a thread, no
// spill), where its walk and halving chains are latency-bound; fewer
// states a thread, e_t in shared memory or more registers at fewer warps
// measured slower (PERF.md §6 names the variants).
// No atomics and a fixed order: the same bits every run.  Steps past S
// and lanes past N run on zeros (dt = dy = 0: e = 1, and B = C = 0), so
// they leave g as it is and add nothing; only the writes are masked.
// exp(dt A) is ex2.approx.ftz as in the forward, and the state's update
// keeps the forward's rounding (product, product, sum; -fmad=false), so
// the rebuild gives the forward's states bit for bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kStep = 16;                // steps between saved states
constexpr int kChunk = 64;               // steps a chunk of the passes
constexpr int kPieces = kChunk / kStep;  // saved states a chunk
constexpr int kSpan = 2;                 // chunks a main-pass block walks
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxState = 32;
constexpr int kCarryThreads = 256;
constexpr int kCarryAhead = 16;          // chunks whose loads fly together
constexpr int kSumThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxChannels = 64;         // channels a block, at most
constexpr int kMaxK = 4;                 // states a thread, at most

// NP = N rounded up to a power of two, as L lanes of K states; a block of
// kChannels channels (64; 32 at NP 32) and kThreads threads (<= 256).
template <int NP>
struct Split {
  static constexpr int K = NP < kMaxK ? NP : kMaxK;
  static constexpr int L = NP / K;
  static constexpr int kChannels =
      kMaxChannels < 256 / L ? kMaxChannels : 256 / L;
  static constexpr int kThreads = kChannels * L;
  static constexpr int kWarps = kThreads / 32;
  // the main pass's blocks an SM, which set its registers a thread: at N
  // 16 (falcon-mamba's) 16 warps an SM, 128 registers a thread; 8 warps
  // (255 registers) at N 3-8 and 17-32, 16 at N 1-2 (K <= 2)
  static constexpr int kWarpsSM = NP == 16 || K < 4 ? 16 : 8;
  static constexpr int kMinBlocks = kWarpsSM * 32 / kThreads > 1
      ? kWarpsSM * 32 / kThreads : 1;
};

// The main pass's shared memory (dynamic), in floats.
template <int NP>
struct MainSmem {
  using S = Split<NP>;
  static constexpr int kU = kStep * S::kThreads * S::K;    // u_t
  static constexpr int kIn = kStep * S::kChannels * 4;     // dt, x, dy, dt x
  static constexpr int kBC = 2 * kStep * NP;               // B, C
  static constexpr int kOut = 2 * kStep * S::kChannels;    // dx, ddt
  static constexpr int kRed = 2 * kStep * S::kWarps * NP;  // warps' dB, dC
  static constexpr int kFloats = kU + kIn + kBC + kOut + kRed;
  static constexpr int kBytes = kFloats * 4;
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

// The line holding p into L2: a hint, no register or shared memory kept
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// K consecutive floats of shared memory (16-, 8- or 4-byte aligned)
template <int K>
__device__ __forceinline__ void load_k(const float* p, float (&v)[K]) {
  if constexpr (K == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else if constexpr (K == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  } else {
    v[0] = p[0];
  }
}
template <int K>
__device__ __forceinline__ void store_k(float* p, const float (&v)[K]) {
  if constexpr (K == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (K == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    p[0] = v[0];
  }
}

// The sum of v over lanes OFF, OFF / 2, .., STOP apart.  While more than
// one value is left, each level halves them: the lane whose OFF bit is
// set keeps the upper half and sends the lower, its partner the reverse,
// and each adds what it receives to what it keeps; then a butterfly.  On
// return v[0] is the sum of value `base` (lanes that differ in the
// butterfly's bits hold the same bits).
template <int M, int OFF, int STOP, int K>
__device__ __forceinline__ void halve(float (&v)[K], int lane, int& base) {
  if constexpr (OFF >= STOP) {
    if constexpr (M > 1) {
      constexpr int H = M / 2;
      const bool hi = lane & OFF;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float keep = hi ? v[H + i] : v[i];
        const float send = hi ? v[i] : v[H + i];
        v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
      }
      base += hi ? H : 0;
      halve<H, OFF / 2, STOP, K>(v, lane, base);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], OFF);
      halve<1, OFF / 2, STOP, K>(v, lane, base);
    }
  }
}

// v's K values summed over the warp's channels (lanes L apart) into the
// warp's row red[NP]: each state index written once, by the lanes whose
// butterfly bits are zero.
template <int K, int L>
__device__ __forceinline__ void warp_channel_sum(float (&v)[K], int lane,
                                                 float* red) {
  int base = 0;
  halve<K, 16, L, K>(v, lane, base);
  if ((lane & (32 / K - L)) == 0) red[(lane % L) * K + base] = v[0];
}

// Pass 1: chunk q >= 1 of batch row b, channels of block x: g walked back
// over the chunk from zero; its value out of the chunk's first step into
// `out` and the product of the chunk's e_t into `decay`, (B, nc, D, N).
template <typename TP, int NP>
__global__ void __launch_bounds__(Split<NP>::kThreads)
mamba_scan_bwd_local(const TP* __restrict__ dt, const TP* __restrict__ cm,
                     const float* __restrict__ a,
                     const float* __restrict__ dy, float* __restrict__ out,
                     float* __restrict__ decay, int s_len, int dim,
                     int n_state) {
  using S = Split<NP>;
  constexpr int K = S::K, L = S::L, NT = S::kThreads, CB = S::kChannels;
  __shared__ float2 dg[kChunk][CB];   // (dt, dy)
  __shared__ __align__(16) float cs[kChunk][NP];

  const int tid = threadIdx.x;
  const int c = tid / L, j = tid % L;
  const int q = blockIdx.y + 1, b = blockIdx.z;
  const int nc = (s_len + kChunk - 1) / kChunk;
  const int d0 = blockIdx.x * CB, d = d0 + c;
  const int s0 = q * kChunk, steps = min(kChunk, s_len - s0);
  const size_t row0 = static_cast<size_t>(b) * s_len + s0;

  for (int e = tid; e < kChunk * CB; e += NT) {
    const int tt = e / CB, cc = e % CB;
    const bool in = tt < steps && d0 + cc < dim;
    const size_t at = (row0 + tt) * dim + d0 + cc;
    dg[tt][cc] = in ? make_float2(to_f32(dt[at]), dy[at])
                    : make_float2(0.f, 0.f);
  }
  for (int e = tid; e < kChunk * NP; e += NT) {
    const int tt = e / NP, nn = e % NP;
    cs[tt][nn] = tt < steps && nn < n_state
        ? to_f32(cm[(row0 + tt) * n_state + nn]) : 0.f;
  }
  float a2[K], g[K], p[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = j * K + k;
    a2[k] = d < dim && n < n_state
        ? a[static_cast<size_t>(d) * n_state + n] * kLog2e : 0.f;
    g[k] = 0.f;
    p[k] = 1.f;
  }
  __syncthreads();
#pragma unroll 16
  for (int t = kChunk - 1; t >= 0; --t) {
    const float2 v = dg[t][c];
    float cv[K];
    load_k<K>(&cs[t][j * K], cv);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float e = ex2(v.x * a2[k]);
      g[k] = e * __fmaf_rn(cv[k], v.y, g[k]);
      p[k] = p[k] * e;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = j * K + k;
    if (d < dim && n < n_state) {
      const size_t at = ((static_cast<size_t>(b) * nc + q) * dim + d)
                        * n_state + n;
      out[at] = g[k];
      decay[at] = p[k];
    }
  }
}

// Pass 2: a thread a (b, d, n): the carry into each chunk, from dh_S (null:
// zero) at the last, G_{q-1} = out_q + P_q G_q; written over out_q.  The
// loads of kCarryAhead chunks are issued before their carries.
__global__ void __launch_bounds__(kCarryThreads)
mamba_scan_bwd_carry(float* __restrict__ out, const float* __restrict__ decay,
                     const float* __restrict__ dh_last, int nc, int dn) {
  const int i = blockIdx.x * kCarryThreads + threadIdx.x;
  const int b = blockIdx.y;
  if (i >= dn) return;
  const size_t base = static_cast<size_t>(b) * nc * dn + i;
  float g = dh_last != nullptr ? dh_last[static_cast<size_t>(b) * dn + i]
                               : 0.f;
  for (int q0 = nc - 1; q0 >= 1; q0 -= kCarryAhead) {
    float p[kCarryAhead], o[kCarryAhead];
#pragma unroll
    for (int u = 0; u < kCarryAhead; ++u) {
      const size_t at = base + static_cast<size_t>(q0 - u) * dn;
      p[u] = q0 - u >= 1 ? decay[at] : 0.f;
      o[u] = q0 - u >= 1 ? out[at] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kCarryAhead; ++u) {
      if (q0 - u < 1) break;
      out[base + static_cast<size_t>(q0 - u) * dn] = g;
      g = o[u] + p[u] * g;
    }
  }
  out[base] = g;
}

// Pass 3: the span of kSpan chunks y of batch row b, channels of block x,
// from the carry into its last chunk: each 16-step piece from the last,
// rebuilt from its saved state, then walked back, g carried through.
template <typename TX, typename TP, int NP>
__global__ void __launch_bounds__(Split<NP>::kThreads, Split<NP>::kMinBlocks)
mamba_scan_bwd_main(const TX* __restrict__ x, const TP* __restrict__ dt,
                    const TP* __restrict__ bm, const TP* __restrict__ cm,
                    const float* __restrict__ a,
                    const float* __restrict__ dskip,
                    const float* __restrict__ dy,
                    const float* __restrict__ states,
                    const float* __restrict__ carry, TX* __restrict__ dx,
                    TP* __restrict__ ddt, float* __restrict__ part_b,
                    float* __restrict__ part_c, float* __restrict__ part_a,
                    float* __restrict__ part_d, int s_len, int dim,
                    int n_state) {
  using S = Split<NP>;
  using M = MainSmem<NP>;
  constexpr int K = S::K, L = S::L, NT = S::kThreads, CB = S::kChannels;
  constexpr int W = S::kWarps;
  extern __shared__ float4 smem4[];
  float* us = reinterpret_cast<float*>(smem4);           // [kStep][NT][K]
  float4* in4 = reinterpret_cast<float4*>(us + M::kU);  // [kStep][CB]
  float* bs = reinterpret_cast<float*>(in4 + kStep * CB);  // [kStep][NP]
  float* cs = bs + kStep * NP;                             // [kStep][NP]
  float* dxs = cs + kStep * NP;                            // [kStep][CB]
  float* dts = dxs + kStep * CB;                           // [kStep][CB]
  float* red_b = dts + kStep * CB;                         // [kStep][W][NP]
  float* red_c = red_b + kStep * W * NP;

  const int tid = threadIdx.x;
  const int c = tid / L, j = tid % L;
  const int warp = tid / 32, lane = tid % 32;
  const int blk = blockIdx.x, nblk = gridDim.x;
  const int y = blockIdx.y, nsp = gridDim.y, b = blockIdx.z;
  const int nc = (s_len + kChunk - 1) / kChunk;
  const int ns = (s_len + kStep - 1) / kStep;
  const int q_last = min((y + 1) * kSpan, nc) - 1;   // the span's last chunk
  const int qs_lo = y * kSpan * kPieces;              // its first piece
  const int d0 = blk * CB, d = d0 + c;
  const bool live_d = d < dim;
  const float dd = live_d ? dskip[d] : 0.f;

  float a2[K], g[K], sum_a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = j * K + k;
    const bool live = live_d && n < n_state;
    a2[k] = live ? a[static_cast<size_t>(d) * n_state + n] * kLog2e : 0.f;
    g[k] = live ? carry[((static_cast<size_t>(b) * nc + q_last) * dim + d)
                        * n_state + n]
                : 0.f;
    sum_a[k] = 0.f;
  }
  float sum_d = 0.f;

  // the span's pieces from the last, g carried through
  for (int qs = (q_last + 1) * kPieces - 1; qs >= qs_lo; --qs) {
    if (qs >= ns) continue;
    const int s0 = qs * kStep, steps = min(kStep, s_len - s0);
    const size_t row0 = static_cast<size_t>(b) * s_len + s0;
    __syncthreads();   // the last piece's shared reads are done
    // The piece's inputs, staged; and, where a piece follows in the span,
    // its rows (a line a 16 channels), B and C and saved states into L2
    // while this one runs, so that its staging waits on L2 only.
    const bool ahead = qs > qs_lo;
    for (int e = tid; e < kStep * CB; e += NT) {
      const int tt = e / CB, cc = e % CB;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (tt < steps && d0 + cc < dim) {
        const size_t at = (row0 + tt) * dim + d0 + cc;
        v.x = to_f32(dt[at]);
        v.y = to_f32(x[at]);
        v.z = dy[at];
        v.w = v.x * v.y;
        if (ahead && cc % 16 == 0) {
          const size_t back = static_cast<size_t>(kStep) * dim;
          prefetch_l2(dt + at - back);
          prefetch_l2(x + at - back);
          prefetch_l2(dy + at - back);
        }
      }
      in4[e] = v;
    }
    for (int e = tid; e < kStep * NP; e += NT) {
      const int tt = e / NP, nn = e % NP;
      const bool in = tt < steps && nn < n_state;
      const size_t at = (row0 + tt) * n_state + nn;
      bs[e] = in ? to_f32(bm[at]) : 0.f;
      cs[e] = in ? to_f32(cm[at]) : 0.f;
      if (ahead && nn == 0) {
        prefetch_l2(bm + at - kStep * n_state);
        prefetch_l2(cm + at - kStep * n_state);
      }
    }
    float h[K];
    const size_t hat = ((static_cast<size_t>(b) * ns + qs) * dim + d)
                       * n_state + j * K;
#pragma unroll
    for (int k = 0; k < K; ++k)
      h[k] = live_d && j * K + k < n_state ? states[hat + k] : 0.f;
    if (ahead && live_d && j * K < n_state)
      prefetch_l2(states + hat - static_cast<size_t>(dim) * n_state);
    __syncthreads();
    // The rebuild: e_t kept in registers, u_t = e_t h_{t-1} in shared
    // memory; dC_t's products summed over the channels.
    float e[kStep][K];
#pragma unroll
    for (int t = 0; t < kStep; ++t) {
      const float4 v = in4[t * CB + c];
      float bv[K], u[K], vc[K];
      load_k<K>(&bs[t * NP + j * K], bv);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        e[t][k] = ex2(v.x * a2[k]);
        u[k] = e[t][k] * h[k];
        h[k] = u[k] + v.w * bv[k];
        vc[k] = v.z * h[k];
      }
      store_k<K>(&us[(t * NT + tid) * K], u);
      warp_channel_sum<K, L>(vc, lane, &red_c[(t * W + warp) * NP]);
    }

    // The walk back from the carried g.
#pragma unroll
    for (int t = kStep - 1; t >= 0; --t) {
      const float4 v = in4[t * CB + c];   // dt, x, dy, dt x
      float bv[K], cv[K], u[K], vb[K];
      load_k<K>(&bs[t * NP + j * K], bv);
      load_k<K>(&cs[t * NP + j * K], cv);
      load_k<K>(&us[(t * NT + tid) * K], u);
      float px = 0.f, pa = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        g[k] = __fmaf_rn(cv[k], v.z, g[k]);
        px = __fmaf_rn(g[k], bv[k], px);
        const float gu = g[k] * u[k];
        pa = __fmaf_rn(gu, a2[k], pa);   // A log2 e: scaled by ln 2 below
        sum_a[k] = __fmaf_rn(gu, v.x, sum_a[k]);
        vb[k] = g[k] * v.w;
        g[k] = e[t][k] * g[k];
      }
      sum_d = __fmaf_rn(v.z, v.y, sum_d);
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) {
        px += __shfl_xor_sync(kFull, px, off, L);
        pa += __shfl_xor_sync(kFull, pa, off, L);
      }
      if (j == t % L) {
        dxs[t * CB + c] = __fmaf_rn(px, v.x, v.z * dd);
        dts[t * CB + c] = __fmaf_rn(v.y, px, pa * kLn2);
      }
      warp_channel_sum<K, L>(vb, lane, &red_b[(t * W + warp) * NP]);
    }
    __syncthreads();   // dxs, dts and the warps' sums complete

    for (int e2 = tid; e2 < kStep * CB; e2 += NT) {
      const int tt = e2 / CB, cc = e2 % CB;
      if (tt < steps && d0 + cc < dim) {
        const size_t at = (row0 + tt) * dim + d0 + cc;
        store(dx + at, dxs[e2]);
        store(ddt + at, dts[e2]);
      }
    }
    for (int e2 = tid; e2 < kStep * NP; e2 += NT) {
      const int tt = e2 / NP, nn = e2 % NP;
      if (tt >= steps || nn >= n_state) continue;
      float sb = 0.f, sc = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) {
        sb += red_b[(tt * W + w) * NP + nn];
        sc += red_c[(tt * W + w) * NP + nn];
      }
      const size_t at =
          ((static_cast<size_t>(b) * nblk + blk) * s_len + s0 + tt) * n_state
          + nn;
      part_b[at] = sb;
      part_c[at] = sc;
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = j * K + k;
    if (live_d && n < n_state)
      part_a[((static_cast<size_t>(b) * nsp + y) * dim + d) * n_state + n] =
          sum_a[k];
  }
  if (live_d && j == 0)
    part_d[(static_cast<size_t>(b) * nsp + y) * dim + d] = sum_d;
}

// dB, dC (B, S, N): the channel blocks' partials added in block order,
// rounded to TP; dA (D, N) and dD (D,): the (batch row, span) partials
// added in order.
template <typename TP>
__global__ void __launch_bounds__(kSumThreads)
mamba_scan_bwd_sum(const float* __restrict__ part_b,
                   const float* __restrict__ part_c,
                   const float* __restrict__ part_a,
                   const float* __restrict__ part_d, TP* __restrict__ dbm,
                   TP* __restrict__ dcm, float* __restrict__ da,
                   float* __restrict__ dskip_grad, int bsz, int nblk,
                   int nsp, int s_len, int dim, int n_state) {
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
  const int rows = bsz * nsp;   // (batch row, span) partials
  if (i < dn) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r) s += part_a[r * dn + i];
    da[i] = s;
  }
  if (i < static_cast<size_t>(dim)) {
    float s = 0.f;
    for (int r = 0; r < rows; ++r)
      s += part_d[static_cast<size_t>(r) * dim + i];
    dskip_grad[i] = s;
  }
}

struct Args {
  const void *x, *dt, *bm, *cm;
  const float *a, *dskip, *dy, *dh_last, *states;
  float* scratch;
  void *dx, *ddt, *dbm, *dcm;
  float *da, *dd;
  int bsz, s_len, dim, n_state;
};

// The scratch's parts, in order: the local pass's out and decay (the
// carries written over out), (B, nc, D, N) each; part_b and part_c (B,
// nblk, S, N); part_a (B, nsp, D, N) and part_d (B, nsp, D), nsp <= nc.
struct Scratch {
  long long nc, nblk, chunk_dn, part_bc;
  Scratch(int bsz, int s_len, int dim, int n_state, int channels) {
    nc = (s_len + kChunk - 1) / kChunk;
    nblk = (dim + channels - 1) / channels;
    chunk_dn = static_cast<long long>(bsz) * nc * dim * n_state;
    part_bc = static_cast<long long>(bsz) * nblk * s_len * n_state;
  }
  long long floats(int bsz, int dim) const {
    return 3 * chunk_dn + 2 * part_bc + static_cast<long long>(bsz) * nc * dim;
  }
};

int channels(int n_state) {
  if (n_state <= 16) return Split<16>::kChannels;   // 64 up to NP 16
  return Split<32>::kChannels;
}

// Blocks an SM of each pass (local, carry, main, sum) for dtypes TX, TP.
template <typename TX, typename TP, int NP>
int occupancy_np(int* blocks) {
  using S = Split<NP>;
  const auto main_pass = mamba_scan_bwd_main<TX, TP, NP>;
  cudaError_t err = cudaFuncSetAttribute(
      main_pass, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MainSmem<NP>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* fns[4] = {
      reinterpret_cast<const void*>(mamba_scan_bwd_local<TP, NP>),
      reinterpret_cast<const void*>(mamba_scan_bwd_carry),
      reinterpret_cast<const void*>(main_pass),
      reinterpret_cast<const void*>(mamba_scan_bwd_sum<TP>)};
  const int threads[4] = {S::kThreads, kCarryThreads, S::kThreads,
                          kSumThreads};
  const int smem[4] = {0, 0, MainSmem<NP>::kBytes, 0};
  for (int i = 0; i < 4; ++i) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks[i], fns[i],
                                                        threads[i], smem[i]);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

template <typename TX, typename TP, int NP>
int launch_np(const Args& p, cudaStream_t st) {
  using S = Split<NP>;
  const Scratch sc(p.bsz, p.s_len, p.dim, p.n_state, S::kChannels);
  float* out = p.scratch;
  float* decay = out + sc.chunk_dn;
  float* part_a = decay + sc.chunk_dn;
  float* part_b = part_a + sc.chunk_dn;
  float* part_c = part_b + sc.part_bc;
  float* part_d = part_c + sc.part_bc;
  const int nc = static_cast<int>(sc.nc), nblk = static_cast<int>(sc.nblk);
  const int dn = p.dim * p.n_state;
  if (nc > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (nc > 1) {
    mamba_scan_bwd_local<TP, NP><<<dim3(nblk, nc - 1, p.bsz), S::kThreads, 0,
                                   st>>>(
        static_cast<const TP*>(p.dt), static_cast<const TP*>(p.cm), p.a, p.dy,
        out, decay, p.s_len, p.dim, p.n_state);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mamba_scan_bwd_carry<<<dim3((dn + kCarryThreads - 1) / kCarryThreads,
                              p.bsz), kCarryThreads, 0, st>>>(
      out, decay, p.dh_last, nc, dn);   // the carries over `out`
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto main_pass = mamba_scan_bwd_main<TX, TP, NP>;
  err = cudaFuncSetAttribute(main_pass,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             MainSmem<NP>::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nsp = (nc + kSpan - 1) / kSpan;
  main_pass<<<dim3(nblk, nsp, p.bsz), S::kThreads, MainSmem<NP>::kBytes,
              st>>>(
      static_cast<const TX*>(p.x), static_cast<const TP*>(p.dt),
      static_cast<const TP*>(p.bm), static_cast<const TP*>(p.cm), p.a,
      p.dskip, p.dy, p.states, out, static_cast<TX*>(p.dx),
      static_cast<TP*>(p.ddt), part_b, part_c, part_a, part_d, p.s_len,
      p.dim, p.n_state);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = std::max(
      static_cast<long long>(p.bsz) * p.s_len * p.n_state,
      static_cast<long long>(dn));
  const long long blocks = (items + kSumThreads - 1) / kSumThreads;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  mamba_scan_bwd_sum<TP><<<static_cast<unsigned>(blocks), kSumThreads, 0,
                           st>>>(
      part_b, part_c, part_a, part_d, static_cast<TP*>(p.dbm),
      static_cast<TP*>(p.dcm), p.da, p.dd, p.bsz, nblk, nsp, p.s_len, p.dim,
      p.n_state);
  return static_cast<int>(cudaGetLastError());
}

// F(NP) for NP = N rounded up to a power of two
#define MAMBA_BY_NP(n_state, F)     \
  if ((n_state) <= 1) return F(1);  \
  if ((n_state) <= 2) return F(2);  \
  if ((n_state) <= 4) return F(4);  \
  if ((n_state) <= 8) return F(8);  \
  if ((n_state) <= 16) return F(16); \
  return F(32)

template <typename TX, typename TP>
int launch(const Args& p, cudaStream_t st) {
#define MAMBA_LAUNCH(NP) launch_np<TX, TP, NP>(p, st)
  MAMBA_BY_NP(p.n_state, MAMBA_LAUNCH);
#undef MAMBA_LAUNCH
}

template <typename TX, typename TP>
int occupancy(int n_state, int* blocks) {
#define MAMBA_OCC(NP) occupancy_np<TX, TP, NP>(blocks)
  MAMBA_BY_NP(n_state, MAMBA_OCC);
#undef MAMBA_OCC
}

template <typename TX>
int launch_p(const Args& p, int p_dtype, cudaStream_t st) {
  if (p_dtype == 0) return launch<TX, float>(p, st);
  if (p_dtype == 1) return launch<TX, __nv_bfloat16>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename TX>
int occupancy_p(int p_dtype, int n_state, int* blocks) {
  if (p_dtype == 0) return occupancy<TX, float>(n_state, blocks);
  if (p_dtype == 1) return occupancy<TX, __nv_bfloat16>(n_state, blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// Floats of the scratch that mamba_scan_bwd_launch needs.
long long mamba_scan_bwd_scratch_floats(int bsz, int s_len, int dim,
                                        int n_state) {
  return Scratch(bsz, s_len, dim, n_state, channels(n_state))
      .floats(bsz, dim);
}

// The tiling, into tiling[4]: the steps between the forward's saved states
// that the backward reads, the steps of a chunk, the chunks a main-pass
// block walks and the channels a block at this N (1 <= N <= 32).
void mamba_scan_bwd_tiling(int n_state, int* tiling) {
  tiling[0] = kStep;
  tiling[1] = kChunk;
  tiling[2] = kSpan;
  tiling[3] = channels(n_state);
}

// Resident blocks an SM of the passes mamba_scan_bwd_launch runs for
// these types and N, into blocks[4]: local, carry, main, sum
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor).  Returns the first
// non-zero cudaError_t (0 = success).
int mamba_scan_bwd_occupancy(int x_dtype, int p_dtype, int n_state,
                             int* blocks) {
  if (n_state < 1 || n_state > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  if (x_dtype == 0) return occupancy_p<float>(p_dtype, n_state, blocks);
  if (x_dtype == 1)
    return occupancy_p<__nv_bfloat16>(p_dtype, n_state, blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dx (B, S, D) in x's type, ddt (B, S, D), dbm and dcm (B, S, N) in dt's
// type, da (D, N) and dd (D,) f32, from the forward's inputs (x, dt, bm,
// cm, a, dskip as mamba_scan_launch takes them), its chunk states (B,
// ceil(S / 16), D, N) f32 (mamba_scan_launch's `states`), dy (B, S, D) f32
// and dh_last (B, D, N) f32 or null (zero), all contiguous.  x_dtype is
// x's type, p_dtype that of dt, bm and cm: 0 f32, 1 bf16.  1 <= N <= 32.
// `scratch` is f32 of mamba_scan_bwd_scratch_floats elements.  Launches
// the passes on `stream`; returns the first non-zero cudaError_t (0 =
// success).
int mamba_scan_bwd_launch(const void* x, const void* dt, const void* bm,
                          const void* cm, const void* a, const void* dskip,
                          const void* states, const void* dy,
                          const void* dh_last, void* scratch, void* dx,
                          void* ddt, void* dbm, void* dcm, void* da, void* dd,
                          int x_dtype, int p_dtype, int bsz, int s_len,
                          int dim, int n_state, void* stream) {
  if (bsz < 1 || bsz > 65535 || s_len < 1 || dim < 1 || n_state < 1 ||
      n_state > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args p{x, dt, bm, cm,
               static_cast<const float*>(a), static_cast<const float*>(dskip),
               static_cast<const float*>(dy),
               static_cast<const float*>(dh_last),
               static_cast<const float*>(states),
               static_cast<float*>(scratch), dx, ddt, dbm, dcm,
               static_cast<float*>(da), static_cast<float*>(dd),
               bsz, s_len, dim, n_state};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0) return launch_p<float>(p, p_dtype, st);
  if (x_dtype == 1) return launch_p<__nv_bfloat16>(p, p_dtype, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

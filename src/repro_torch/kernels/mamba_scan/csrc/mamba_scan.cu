// Mamba-1 selective scan, for Hopper.
//
// Replaces the TPU kernel repro/kernels/mamba_scan/kernel.py::_kernel
// (launched by mamba_scan_fwd) and computes what ref.mamba_scan_ref
// computes: for each batch row b and channel d, from h = 0,
//     h[n] = exp(dt_t * A[d, n]) * h[n] + (dt_t * x_t) * B_t[n]
//     y_t  = sum_n C_t[n] * h[n] + D[d] * x_t
// all in f32 whatever the input types.  Unlike the TPU kernel it also
// writes the final state h_S (B, D, N): the state the kernel carries
// anyway and decode continues from (the JAX model's mamba_mix returns it
// from its own scan, ssm.py:117-118).  The function is otherwise the
// same.
//
// Chunk states, on request.  Given a non-null `states` (B, ceil(S / 16),
// D, N) f32, the launch runs the kernel's kSave instantiation, which also
// writes the state before each chunk of kChunk = 16 steps (h_{-1} = 0
// before the first): the state it holds in registers there anyway.  The
// backward (mamba_scan_bwd.cu) rebuilds each chunk's states from them
// instead of walking the forward again, so MambaScanFn asks for them only
// when autograd records.  Serving passes null and runs the kernel without
// the stores, unchanged.  The stores are 4 B a state every 16 steps (134
// MB at falcon-mamba's training shape, B 1, S 4096, D 8192, N 16); y and
// h_S are the same bits either way.
//
// Bound.  Per (b, t, d) the kernel reads x and dt once and writes y
// once, and per (b, t) it reads B and C; A, D and h_S are small.  At
// falcon-mamba-7b's prefill (B 1, S 512, D 8192, N 16, x bf16, the rest
// f32) that is ~42 MB, 12.9 us at 3.35 TB/s.  The floor that binds is
// the exponentials: one a (b, t, d, n), 67.1 M there, and the SFU gives
// 16 a clock an SM, 16-18 us at 1.98-1.75 GHz.  The other operations
// (~6 a state and step) take about as long again in instruction slots.
//
// Design.  The TPU kernel walks S in chunks over a (bd, N) state kept in
// VMEM scratch across sequential grid steps.  Here blocks run in no
// order and nothing carries between them, so each block owns whole
// channels and walks the whole sequence itself; the state never leaves
// registers and every exponential is computed once.  (A split along S
// with a carry, as rglru_scan.cu has, would compute each exponential
// twice, for the chunk's end state and again from its carry, and double
// that floor.)
// - Several states a thread: NP = N rounded up to a power of two is split
//   over L lanes of K states (K = 2, L = NP / 2; N 16: 8 lanes of 2), so
//   y's sum over n is K fused multiply-adds in the thread and log2 L
//   shuffles (3 at N 16), in a fixed order; all lanes end with the same
//   sum.  The plain version's einsum sums in its own order, so the sum is
//   held to it by tolerance; h's update keeps the plain version's
//   rounding (product, product, sum: -fmad=false).  At B 1 the threads
//   are few (D N / K), and latency, not throughput, decides: at
//   falcon-mamba's shape 4 lanes of 4 states and 2 lanes of 8 both
//   measured slower on the H100 than 8 lanes of 2 (PERF.md §6).
// - A block is 32 channels (32 L threads).  It stages kChunk steps of x,
//   dt (its channels) and of B, C in shared memory as f32, and runs the
//   chunk's steps unrolled: the exponentials and dt x B of a step do not
//   depend on h, so they run under earlier steps' chains, and the only
//   dependent work a step is h's multiply and add.
// - The next chunk's loads are started into registers before the current
//   chunk's steps and stored to the other half of a double buffer after
//   them, one barrier a chunk.  (cp.async copies 4, 8 or 16 bytes, and a
//   row of bf16 x at a ragged D starts on 2 bytes; the register route
//   takes every type and alignment.)
// - y is gathered in shared memory a chunk at a time and written as rows
//   of 32 channels, by the lane that holds step t mod L.
// - exp(dt A) is ex2.approx.ftz(dt * (A log2 e)), with A log2 e formed
//   once a state: one SFU operation and one multiply an exponential.  Its
//   error (2 ulp, and results below 2^-126 flushed to 0) stays far inside
//   the f32 1e-4 and bf16 2e-2 tolerances against the plain version.
// Steps past S and lanes past N run on zeros (dt = 0: exp(0) = 1, and
// B = C = 0), so they leave h as it is and add nothing to y; only the
// writes are masked.  No atomics: the same bits every run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 32;   // channels a block
constexpr int kChunk = 16;      // sequence steps staged a chunk
constexpr int kMaxState = 32;
constexpr float kLog2e = 1.4426950408889634f;

// NP = N rounded up to a power of two, as L lanes of K states
template <int NP>
struct Split {
  static constexpr int K = NP < 2 ? NP : 2;
  static constexpr int L = NP / K;
  static constexpr int kThreads = kChannels * L;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}

// 2^x on the SFU; results below 2^-126 flush to zero
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two blocks an SM (falcon-mamba's 256 blocks on 132 SMs): without the
// minimum ptxas cut registers for occupancy and spilled at N 16.
template <typename TX, typename TP, int NP, bool kSave>
__global__ void __launch_bounds__(Split<NP>::kThreads, 2)
mamba_scan_fwd(const TX* __restrict__ x, const TP* __restrict__ dt,
               const TP* __restrict__ bm, const TP* __restrict__ cm,
               const float* __restrict__ a, const float* __restrict__ dskip,
               float* __restrict__ y, float* __restrict__ h_last,
               float* __restrict__ states,   // kSave: the chunk states
               int s_len, int dim, int n_state) {
  constexpr int K = Split<NP>::K, L = Split<NP>::L;
  constexpr int NT = Split<NP>::kThreads;
  constexpr int kXD = kChunk * kChannels / NT;      // x, dt a thread stages
  constexpr int kBC = (kChunk * NP + NT - 1) / NT;  // B, C a thread stages
  __shared__ float xs[2][kChunk][kChannels], ds[2][kChunk][kChannels];
  __shared__ float ys[2][kChunk][kChannels];
  __shared__ float bs[2][kChunk][NP], cs[2][kChunk][NP];
  // kSave: the state before the chunk, drained with its y
  __shared__ float hs[kSave ? 2 : 1][kChannels][NP];

  const int tid = threadIdx.x;
  const int c = tid / L;   // channel within the block
  const int j = tid % L;   // lane: states j K .. j K + K - 1
  const int b = blockIdx.y;
  const int d0 = blockIdx.x * kChannels;
  const int d = d0 + c;
  const size_t row0 = static_cast<size_t>(b) * s_len;

  float a2[K], h[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = j * K + k;
    a2[k] = d < dim && n < n_state
                ? a[static_cast<size_t>(d) * n_state + n] * kLog2e : 0.f;
    h[k] = 0.f;
  }
  const float dd = d < dim ? dskip[d] : 0.f;

  // The chunk at s0 into registers, zero past S, D and N.
  TX rx[kXD];
  TP rd[kXD], rb[kBC], rc[kBC];
  auto fetch = [&](int s0) {
    const int steps = min(kChunk, s_len - s0);
#pragma unroll
    for (int i = 0; i < kXD; ++i) {
      const int e = tid + i * NT, tt = e / kChannels, cc = e % kChannels;
      const bool in = tt < steps && d0 + cc < dim;
      const size_t at = (row0 + s0 + tt) * dim + d0 + cc;
      rx[i] = in ? x[at] : zero<TX>();
      rd[i] = in ? dt[at] : zero<TP>();
    }
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int e = tid + i * NT, tt = e / NP, nn = e % NP;
      const bool in = e < kChunk * NP && tt < steps && nn < n_state;
      const size_t at = (row0 + s0 + tt) * n_state + nn;
      rb[i] = in ? bm[at] : zero<TP>();
      rc[i] = in ? cm[at] : zero<TP>();
    }
  };
  // ... and from registers into half `buf` of the staging buffers, as f32.
  auto stage = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kXD; ++i) {
      const int e = tid + i * NT, tt = e / kChannels, cc = e % kChannels;
      xs[buf][tt][cc] = to_f32(rx[i]);
      ds[buf][tt][cc] = to_f32(rd[i]);
    }
#pragma unroll
    for (int i = 0; i < kBC; ++i) {
      const int e = tid + i * NT;
      if (e < kChunk * NP) {
        bs[buf][e / NP][e % NP] = to_f32(rb[i]);
        cs[buf][e / NP][e % NP] = to_f32(rc[i]);
      }
    }
  };
  // The chunk's steps, y into ys[buf].
  auto run = [&](int buf) {
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const float xv = xs[buf][t][c], dv = ds[buf][t][c];
      const float dbx = dv * xv;
      float p = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float da = ex2(dv * a2[k]);
        h[k] = da * h[k] + dbx * bs[buf][t][j * K + k];
        p = __fmaf_rn(h[k], cs[buf][t][j * K + k], p);
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off, L);
      if (j == t % L) ys[buf][t][c] = p + xv * dd;
    }
  };
  // ys[buf] out as rows of the block's channels.
  auto drain = [&](int buf, int s0) {
    const int steps = min(kChunk, s_len - s0);
#pragma unroll
    for (int i = 0; i < kXD; ++i) {
      const int e = tid + i * NT, tt = e / kChannels, cc = e % kChannels;
      if (tt < steps && d0 + cc < dim)
        y[(row0 + s0 + tt) * dim + d0 + cc] = ys[buf][tt][cc];
    }
  };

  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  // kSave: h before chunk q into hs[buf], then from there into the chunk
  // states as rows of the block's channels
  auto keep = [&](int buf) {
#pragma unroll
    for (int k = 0; k < K; ++k) hs[buf][c][j * K + k] = h[k];
  };
  auto save = [&](int buf, int q) {
    float* row = states + (static_cast<size_t>(b) * n_chunks + q) * dim
                 * n_state;
    for (int e = tid; e < kChannels * NP; e += NT) {
      const int cc = e / NP, nn = e % NP;
      if (d0 + cc < dim && nn < n_state)
        row[static_cast<size_t>(d0 + cc) * n_state + nn] = hs[buf][cc][nn];
    }
  };
  fetch(0);
  stage(0);
  __syncthreads();
  for (int q = 0; q < n_chunks; ++q) {
    const int buf = q & 1;
    const bool more = q + 1 < n_chunks;
    if constexpr (kSave) keep(buf);
    if (more) fetch((q + 1) * kChunk);
    run(buf);
    if (more) stage(buf ^ 1);
    __syncthreads();   // ys[buf] complete; the other half staged
    drain(buf, q * kChunk);
    if constexpr (kSave) save(buf, q);
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int n = j * K + k;
    if (d < dim && n < n_state)
      h_last[(static_cast<size_t>(b) * dim + d) * n_state + n] = h[k];
  }
}

template <typename TX, typename TP, int NP>
int launch_np(const void* x, const void* dt, const void* bm, const void* cm,
              const float* a, const float* dskip, float* y, float* h_last,
              float* states, int bsz, int s_len, int dim, int n_state,
              cudaStream_t st) {
  const dim3 grid((dim + kChannels - 1) / kChannels, bsz);
  const auto kernel = states != nullptr ? mamba_scan_fwd<TX, TP, NP, true>
                                        : mamba_scan_fwd<TX, TP, NP, false>;
  kernel<<<grid, Split<NP>::kThreads, 0, st>>>(
      static_cast<const TX*>(x), static_cast<const TP*>(dt),
      static_cast<const TP*>(bm), static_cast<const TP*>(cm), a, dskip, y,
      h_last, states, s_len, dim, n_state);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX, typename TP>
int launch(const void* x, const void* dt, const void* bm, const void* cm,
           const float* a, const float* dskip, float* y, float* h_last,
           float* states, int bsz, int s_len, int dim, int n_state,
           cudaStream_t st) {
#define MAMBA_LAUNCH(NP)                                                   \
  return launch_np<TX, TP, NP>(x, dt, bm, cm, a, dskip, y, h_last, states, \
                               bsz, s_len, dim, n_state, st)
  if (n_state <= 1) MAMBA_LAUNCH(1);
  if (n_state <= 2) MAMBA_LAUNCH(2);
  if (n_state <= 4) MAMBA_LAUNCH(4);
  if (n_state <= 8) MAMBA_LAUNCH(8);
  if (n_state <= 16) MAMBA_LAUNCH(16);
  MAMBA_LAUNCH(32);
#undef MAMBA_LAUNCH
}

template <typename TX>
int launch_p(const void* x, const void* dt, const void* bm, const void* cm,
             const float* a, const float* dskip, float* y, float* h_last,
             float* states, int p_dtype, int bsz, int s_len, int dim,
             int n_state, cudaStream_t st) {
  if (p_dtype == 0)
    return launch<TX, float>(x, dt, bm, cm, a, dskip, y, h_last, states, bsz,
                             s_len, dim, n_state, st);
  if (p_dtype == 1)
    return launch<TX, __nv_bfloat16>(x, dt, bm, cm, a, dskip, y, h_last,
                                     states, bsz, s_len, dim, n_state, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// y (B, S, D) f32 and h_last (B, D, N) f32 from x (B, S, D), dt (B, S, D),
// bm and cm (B, S, N), a (D, N) f32 and dskip (D,) f32, all contiguous;
// and, where `states` is not null, the state before each 16-step chunk
// into it, (B, ceil(S / 16), D, N) f32.  x_dtype is x's type, p_dtype
// that of dt, bm and cm: 0 f32, 1 bf16.  1 <= N <= 32.  Launches on
// `stream`; returns the cudaError_t of the launch (0 = success).
int mamba_scan_launch(const void* x, const void* dt, const void* bm,
                      const void* cm, const void* a, const void* dskip,
                      void* y, void* h_last, void* states, int x_dtype,
                      int p_dtype, int bsz, int s_len, int dim, int n_state,
                      void* stream) {
  if (bsz < 1 || bsz > 65535 || s_len < 1 || dim < 1 || n_state < 1 ||
      n_state > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* df = static_cast<const float*>(dskip);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_last);
  float* sf = static_cast<float*>(states);
  if (x_dtype == 0)
    return launch_p<float>(x, dt, bm, cm, af, df, yf, hf, sf, p_dtype, bsz,
                           s_len, dim, n_state, st);
  if (x_dtype == 1)
    return launch_p<__nv_bfloat16>(x, dt, bm, cm, af, df, yf, hf, sf,
                                   p_dtype, bsz, s_len, dim, n_state, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

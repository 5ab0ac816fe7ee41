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
// Bound.  Per (b, t, d) the kernel reads x and dt once and writes y
// once, and per (b, t) it reads B and C; A, D and h_S are small.  At
// falcon-mamba-7b's prefill (B 1, S 512, D 8192, N 16, x bf16, the rest
// f32) that is ~42 MB, 12.5 us at 3.35 TB/s, against ~7 N + 3 = 115 f32
// operations per (b, t, d), 7.2 us at 67 TFLOP/s: the bytes bound it.
// The recurrence is sequential in t, so this simple kernel is bound in
// practice by the latency of each step's dependent chain, not by either.
//
// Design.  The TPU kernel walks S in chunks over a (bd, N) state kept in
// VMEM scratch across sequential grid steps.  Here blocks run in no
// order and nothing carries between them, so each block owns whole
// channels and walks the whole sequence itself: one thread per state
// element (b, d, n), NP = N rounded up to a power of two lanes per
// channel (at most a warp), 256 / NP channels per block, h[n] in a
// register for the whole sequence.  y's sum over n is a butterfly of
// warp shuffles within the channel's NP lanes, in a fixed order.  Each
// pass stages kChunk steps of x and dt (the block's channels, read
// coalesced) and of B and C in shared memory as f32.  At N = 16 and
// D = 8192 that is 131,072 threads in 512 blocks, so every SM holds a
// few blocks and one block's staging hides behind another's steps.
// expf, not __expf, with -fmad=false as everywhere in the port: the
// plain version rounds the product and the sum apart.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;      // sequence steps staged per pass
constexpr int kMaxState = 32;   // lanes of one warp

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename TX, typename TP>
__global__ void __launch_bounds__(kThreads)
mamba_scan_fwd(const TX* __restrict__ x, const TP* __restrict__ dt,
               const TP* __restrict__ bm, const TP* __restrict__ cm,
               const float* __restrict__ a, const float* __restrict__ dskip,
               float* __restrict__ y, float* __restrict__ h_last, int s_len,
               int dim, int n_state, int np_log2) {
  extern __shared__ float smem[];
  const int np = 1 << np_log2;          // lanes per channel
  const int ch = kThreads >> np_log2;   // channels per block
  float* xs = smem;                     // [kChunk][ch]
  float* ds = xs + kChunk * ch;         // [kChunk][ch]
  float* bs = ds + kChunk * ch;         // [kChunk][np]
  float* cs = bs + kChunk * np;         // [kChunk][np]

  const int b = blockIdx.y;
  const int d0 = blockIdx.x * ch;
  const int t = threadIdx.x;
  const int c = t >> np_log2;           // channel within the block
  const int n = t & (np - 1);           // state element of the channel
  const int d = d0 + c;
  const bool live = d < dim && n < n_state;
  // a padded lane (n >= N) keeps h = 0: A = 0 gives exp(0) = 1, B = C = 0
  const float an = live ? a[static_cast<size_t>(d) * n_state + n] : 0.f;
  const float dd = d < dim ? dskip[d] : 0.f;
  const size_t row0 = static_cast<size_t>(b) * s_len;
  float h = 0.f;

  for (int s0 = 0; s0 < s_len; s0 += kChunk) {
    const int steps = min(kChunk, s_len - s0);
    __syncthreads();  // the last pass's reads are done
    for (int i = t; i < kChunk * ch; i += kThreads) {
      const int tt = i / ch, cc = i - tt * ch;
      const bool in = tt < steps && d0 + cc < dim;
      const size_t at = (row0 + s0 + tt) * dim + d0 + cc;
      xs[i] = in ? to_f32(x[at]) : 0.f;
      ds[i] = in ? to_f32(dt[at]) : 0.f;
    }
    for (int i = t; i < kChunk * np; i += kThreads) {
      const int tt = i >> np_log2, nn = i & (np - 1);
      const bool in = tt < steps && nn < n_state;
      const size_t at = (row0 + s0 + tt) * n_state + nn;
      bs[i] = in ? to_f32(bm[at]) : 0.f;
      cs[i] = in ? to_f32(cm[at]) : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < steps; ++tt) {
      const float xv = xs[tt * ch + c];
      const float dv = ds[tt * ch + c];
      const float da = expf(dv * an);
      const float dbx = (dv * xv) * bs[tt * np + n];
      h = da * h + dbx;
      float p = h * cs[tt * np + n];
      for (int off = np >> 1; off > 0; off >>= 1)
        p += __shfl_xor_sync(0xffffffffu, p, off, np);
      if (n == 0 && d < dim)
        y[(row0 + s0 + tt) * dim + d] = p + xv * dd;
    }
  }
  if (live)
    h_last[(static_cast<size_t>(b) * dim + d) * n_state + n] = h;
}

template <typename TX, typename TP>
int launch(const void* x, const void* dt, const void* bm, const void* cm,
           const float* a, const float* dskip, float* y, float* h_last,
           int bsz, int s_len, int dim, int n_state, cudaStream_t st) {
  int np_log2 = 0;
  while ((1 << np_log2) < n_state) ++np_log2;
  const int np = 1 << np_log2;
  const int ch = kThreads / np;
  const size_t bytes = sizeof(float) * kChunk * (2 * ch + 2 * np);
  const dim3 grid((dim + ch - 1) / ch, bsz);
  mamba_scan_fwd<TX, TP><<<grid, kThreads, bytes, st>>>(
      static_cast<const TX*>(x), static_cast<const TP*>(dt),
      static_cast<const TP*>(bm), static_cast<const TP*>(cm), a, dskip, y,
      h_last, s_len, dim, n_state, np_log2);
  return static_cast<int>(cudaGetLastError());
}

template <typename TX>
int launch_p(const void* x, const void* dt, const void* bm, const void* cm,
             const float* a, const float* dskip, float* y, float* h_last,
             int p_dtype, int bsz, int s_len, int dim, int n_state,
             cudaStream_t st) {
  if (p_dtype == 0)
    return launch<TX, float>(x, dt, bm, cm, a, dskip, y, h_last, bsz, s_len,
                             dim, n_state, st);
  if (p_dtype == 1)
    return launch<TX, __nv_bfloat16>(x, dt, bm, cm, a, dskip, y, h_last, bsz,
                                     s_len, dim, n_state, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// y (B, S, D) f32 and h_last (B, D, N) f32 from x (B, S, D), dt (B, S, D),
// bm and cm (B, S, N), a (D, N) f32 and dskip (D,) f32, all contiguous.
// x_dtype is x's type, p_dtype that of dt, bm and cm: 0 f32, 1 bf16.
// 1 <= N <= 32.  Launches on `stream`; returns the cudaError_t of the
// launch (0 = success).
int mamba_scan_launch(const void* x, const void* dt, const void* bm,
                      const void* cm, const void* a, const void* dskip,
                      void* y, void* h_last, int x_dtype, int p_dtype,
                      int bsz, int s_len, int dim, int n_state,
                      void* stream) {
  if (bsz < 1 || bsz > 65535 || s_len < 1 || dim < 1 || n_state < 1 ||
      n_state > kMaxState)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* df = static_cast<const float*>(dskip);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h_last);
  if (x_dtype == 0)
    return launch_p<float>(x, dt, bm, cm, af, df, yf, hf, p_dtype, bsz,
                           s_len, dim, n_state, st);
  if (x_dtype == 1)
    return launch_p<__nv_bfloat16>(x, dt, bm, cm, af, df, yf, hf, p_dtype,
                                   bsz, s_len, dim, n_state, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

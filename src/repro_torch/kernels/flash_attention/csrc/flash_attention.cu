// Forward flash attention (GQA, causal, sliding window), for Hopper.
//
// Replaces the TPU kernel repro/kernels/flash_attention/kernel.py::_kernel
// (launched by flash_attention_fwd) and computes what
// ref.flash_attention_ref computes: for each folded head bh, query i of
// q (BH, Sq, hd) attends the keys of kv head bh / group, with query
// positions right-aligned (q_offset = Sk - Sq), an optional causal mask
// (k <= q) and an optional window (q - k < window).  Masked scores are the
// finite -1e30 of the TPU kernel, not -inf, so a row that is masked
// everywhere gives the mean of V over all Sk keys, as the plain version
// does.  Scores, the online softmax and the output accumulator are f32
// for f32 and bf16 inputs alike; the output is rounded once to the
// input's type.
//
// Ragged lengths: the TPU wrapper picks block sizes that divide Sq and
// Sk.  Here the tiles are fixed and the kernel masks the ragged edge
// itself: a query row past Sq is computed on zeros and never stored; a
// key past Sk does not exist (its probability is an exact 0, not the
// -1e30 of a masked key).
//
// Bound.  The work is 4 * BH * hd * (live score entries) operations (QK^T
// and PV), half the square under a causal mask, and the bytes are q, k, v
// read once and o written once.  At the qwen3-moe prefill shapes (Hq 32,
// Hkv 4, hd 128, S 512-2048) the operations dominate: 989 TFLOP/s of bf16
// tensor-core rate against 3.35 TB/s puts the line at ~295 operations a
// byte, and attention over S keys does ~S/2 per byte.  This first kernel
// is simple rather than fast: it runs on the CUDA cores in f32 (67 TFLOP/s
// peak), so it cannot come near the tensor-core bound; wgmma tiles with
// TMA loads are later work (ROADMAP).
//
// Design.  One block of 128 threads per (32-query tile, folded head), a
// loop over 64-key tiles inside the block in place of the TPU's
// sequential kv grid axis (blocks run in no order, so nothing is carried
// between them).  Four threads own one query row: each computes 16 of the
// tile's 64 scores and a quarter of the row's hd output dims (dims c,
// c+4, ...), keeps its running max, partial denominator and output in
// registers, and the four meet by warp shuffles.  Q, K, V tiles are
// converted to f32 in shared memory (rows padded by one float so the
// dot-product reads do not collide on banks): ~90 KB at hd = 128 and
// 172,544 B at hd = 256 (recurrentgemma-2b), under the 227 KB opt-in,
// where each thread carries 64 f32 output accumulators.  Key
// tiles that no row of the query tile can see (wholly above the causal
// diagonal, or wholly behind the window) are skipped: a masked key adds an
// exact 0 once a row has seen a live key, so skipping is exact for every
// row that has one.  A causal tile with a row at a negative position (Sq
// > Sk) has a row with no live key, and walks every key tile so that row
// gets the plain version's mean of V.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;          // query rows per block
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 128;    // four threads per query row
constexpr int kPerThread = kBK / 4;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int sq, int sk,
          int group, int causal, int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                       // [kBQ][HD + 1]
  float* ks = qs + kBQ * (HD + 1);        // [kBK][HD + 1]
  float* vs = ks + kBK * (HD + 1);        // [kBK][HD]
  float* ps = vs + kBK * HD;              // [kBQ][kBK + 1]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int t = threadIdx.x;
  const int r = t >> 2;                   // query row within the tile
  const int c = t & 3;                    // which quarter of the row
  const int off = sk - sq;                // query i sits at position i + off
  const T* qb = q + static_cast<size_t>(bh) * sq * HD;
  const T* kb = k + static_cast<size_t>(bh / group) * sk * HD;
  const T* vb = v + static_cast<size_t>(bh / group) * sk * HD;

  for (int i = t; i < kBQ * HD; i += kThreads) {
    const int rr = i / HD, d = i % HD;
    qs[rr * (HD + 1) + d] =
        q0 + rr < sq ? to_f32(qb[static_cast<size_t>(q0 + rr) * HD + d]) : 0.f;
  }

  // keys any row of this tile can see
  const int pos_lo = q0 + off;
  const int pos_hi = min(q0 + kBQ, sq) - 1 + off;
  int k_begin = 0, k_end = sk;
  if (!(causal && pos_lo < 0)) {
    if (causal) k_end = min(sk, pos_hi + 1);
    if (window > 0) k_begin = max(0, pos_lo - window + 1);
  }
  k_begin = (k_begin / kBK) * kBK;

  const int qpos = q0 + r + off;
  float m = kNegInf, l = 0.f;
  float acc[HD / 4];
#pragma unroll
  for (int i = 0; i < HD / 4; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // q tile written; last tile's K/V reads done
    for (int i = t; i < kBK * HD; i += kThreads) {
      const int j = i / HD, d = i % HD;
      const bool in = k0 + j < sk;
      const size_t at = static_cast<size_t>(k0 + j) * HD + d;
      ks[j * (HD + 1) + d] = in ? to_f32(kb[at]) : 0.f;
      vs[j * HD + d] = in ? to_f32(vb[at]) : 0.f;
    }
    __syncthreads();

    float s[kPerThread];
#pragma unroll
    for (int jj = 0; jj < kPerThread; ++jj) s[jj] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = qs[r * (HD + 1) + d];
#pragma unroll
      for (int jj = 0; jj < kPerThread; ++jj)
        s[jj] = fmaf(qd, ks[(c + 4 * jj) * (HD + 1) + d], s[jj]);
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kPerThread; ++jj) {
      const int key = k0 + c + 4 * jj;
      bool live = true;
      if (causal) live = live && key <= qpos;
      if (window > 0) live = live && (qpos - key) < window;
      s[jj] = key >= sk ? -INFINITY : (live ? s[jj] * scale : kNegInf);
      tile_max = fmaxf(tile_max, s[jj]);
    }
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 1));
    tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, 2));
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kPerThread; ++jj) {
      const float p = expf(s[jj] - m_new);
      ps[r * (kBK + 1) + c + 4 * jj] = p;
      psum += p;
    }
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the row's four threads share one warp
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) acc[i] *= corr;
    const int nk = min(kBK, sk - k0);
    for (int j = 0; j < nk; ++j) {
      const float p = ps[r * (kBK + 1) + j];
#pragma unroll
      for (int i = 0; i < HD / 4; ++i)
        acc[i] = fmaf(p, vs[j * HD + c + 4 * i], acc[i]);
    }
  }

  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (q0 + r < sq) {
    const float inv_l = 1.f / fmaxf(l, 1e-30f);
    T* ob = o + (static_cast<size_t>(bh) * sq + q0 + r) * HD;
#pragma unroll
    for (int i = 0; i < HD / 4; ++i) store(ob + c + 4 * i, acc[i] * inv_l);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int bhq,
           int sq, int sk, int group, int causal, int window, float scale,
           cudaStream_t st) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBQ - 1) / kBQ, bhq);
  flash_fwd<T, HD><<<grid, kThreads, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, group, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o, int bhq,
              int sq, int sk, int hd, int group, int causal, int window,
              float scale, cudaStream_t st) {
  switch (hd) {
    case 16: return launch<T, 16>(q, k, v, o, bhq, sq, sk, group, causal, window, scale, st);
    case 32: return launch<T, 32>(q, k, v, o, bhq, sq, sk, group, causal, window, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, bhq, sq, sk, group, causal, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, bhq, sq, sk, group, causal, window, scale, st);
    case 256: return launch<T, 256>(q, k, v, o, bhq, sq, sk, group, causal, window, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// o (BHq, Sq, hd) = attention of q (BHq, Sq, hd) over k, v (BHq / group,
// Sk, hd), all contiguous and of one type: dtype 0 is f32, 1 is bf16.
// hd is 16, 32, 64, 128 or 256.  Launches on `stream`; returns the
// cudaError_t of the launch (0 = success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int dtype, int bhq, int sq, int sk,
                           int hd, int group, int causal, int window,
                           float scale, void* stream) {
  if (bhq < 1 || bhq > 65535 || sq < 1 || sk < 1 || group < 1 ||
      bhq % group)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_hd<float>(q, k, v, o, bhq, sq, sk, hd, group, causal,
                            window, scale, st);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, o, bhq, sq, sk, hd, group,
                                    causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

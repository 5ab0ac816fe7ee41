// Backward flash attention (GQA, causal, sliding window, non-causal), for
// Hopper.
//
// The JAX package has no backward kernel: it trains through plain jnp,
// and jax.grad differentiates its chunked softmax attention
// (repro/models/attention.py:85, chunked_attention).  The port's forward
// is the hand-written kernel of flash_attention.cu, so its gradient is a
// kernel too: this file computes the gradient of exactly the function
// that kernel (and ref.flash_attention_ref) computes.  Query positions are
// right-aligned (query i sits at i + Sk - Sq), an optional causal mask
// (k <= q) and window (q - k < window) hold, and masked scores are the
// finite -1e30: a masked entry has probability exp(-1e30 - lse) = 0 in a
// row with a live key, and carries no gradient into q or k (its score is
// a constant).  A row at a negative position under the causal mask
// (Sq > Sk) has no live key: the forward gives it the mean of V, so its
// probabilities are 1 / Sk, its dV share is dO / Sk and its dQ is 0.
//
// FlashAttention-2's scheme, on the CUDA cores, f32 throughout (inputs
// f32 or bf16, converted on load; grads returned in the input's type):
//   flash_bwd_dsum  D = rowsum(dO * O), one warp a row;
//   flash_bwd_dkdv  a block owns one KV head's key tile and walks the
//                   group's query heads and, for each, the query tiles
//                   that can see the tile: S = Q K^T and dP = dO V^T,
//                   P = exp(scale S - lse), dS = P (dP - D), then
//                   dV += P^T dO and dK += dS^T Q in registers;
//   flash_bwd_dq    a block owns one query tile of one head and walks the
//                   key tiles it can see (the forward's range): S, dP, dS
//                   again, dQ += dS K.
// lse is the forward's per-row logsumexp (flash_attention.cu writes it
// when asked).  Every sum has one owner and a fixed order: no atomics, so
// a second call gives the same bits (a restart from a checkpoint repeats
// a run bit for bit).
//
// Tiles (BwdTiling): 64 query rows x 64 keys up to hd 128, 32 x 32 at hd
// 256, 256 threads as a 16 x 16 grid.  Q, K, V, dO tiles are f32 in shared
// memory with rows padded by 4 floats (16-byte loads along hd, conflict
// free across 8 consecutive rows); each thread computes a 4 x 4 (2 x 2 at
// hd 256) block of S and dP, strided by 16 rows and columns, with 16-byte
// loads along hd, and holds its rows of dK and dV (or dQ) with 4
// consecutive head dims a load.  Shared memory: 111 KB at hd 64 (two
// blocks an SM), 177 KB at hd 128, 146 KB at hd 256 for flash_bwd_dkdv.
//
// Bound.  Five products of 2 Sq Sk hd operations a head (S, dP, dV, dK,
// dQ; half the square under a causal mask) over 67 TFLOP/s of f32 CUDA
// cores, or 989 TFLOP/s of bf16 tensor cores for the bf16 rows; this
// two-pass scheme computes seven (S and dP twice).  At smollm-360m's
// training shape (B 8, Hq 15, Hkv 5, hd 64, S 4096, causal, bf16) that is
// 0.644 TFLOP, 0.65 ms at the bf16 tensor-core rate; on the CUDA cores the
// floor of the seven products is 13.5 ms.  Measured there: 34.5 ms
// (PERF.md; SDPA's backward takes 1.7 ms).  The tensor cores (wgmma), TMA
// and a single fused pass are later speed work (ROADMAP).
// ptxas (CUDA 12.8, -O3 -fmad=false): 77-184 registers; 4 bytes of spill
// in flash_bwd_dkdv<*, 64>, 20 in flash_bwd_dq<*, 128>.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // a 16 x 16 grid

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

template <int HD>
struct BwdTiling {
  static constexpr int kBQ = HD > 128 ? 32 : 64;   // query rows a tile
  static constexpr int kBK = HD > 128 ? 32 : 64;   // keys a tile
  static constexpr int kPitch = HD + 4;            // Q, K, V, dO rows (floats)
  static constexpr int kPPitch = kBK + 16;         // P, dS rows [query][key]
  static constexpr int kTPitch = kBQ + 4;          // dS^T rows [key][query]
  static constexpr int kVec = HD >= 64 ? 4 : HD / 16;   // head dims a load
};

// out[0..N) = p[0..N), one load of 4 N bytes (p aligned to it)
template <int N>
__device__ __forceinline__ void load_vec(float* out, const float* p) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x, out[1] = v.y;
  } else {
    out[0] = p[0];
  }
}

// Rows row0.. of a (rows, HD) matrix in global memory into an f32 tile of
// `n` rows (pitch HD + 4); rows at or past `rows_valid` are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int row0,
                                          int rows_valid, int n, int t) {
  constexpr int P = HD + 4;
  for (int i = t; i < n * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    dst[r * P + d] = row0 + r < rows_valid
                         ? to_f32(src[static_cast<size_t>(row0 + r) * HD + d])
                         : 0.f;
  }
}

// acc[a][b] = sum_d A[ty + 16 a][d] * B[tx + 16 b][d]: A and B f32 tiles
// of pitch HD + 4, 16-byte loads along d.
template <int HD, int RA, int CB>
__device__ __forceinline__ void tile_dot(float (&acc)[RA][CB],
                                         const float* A, const float* B,
                                         int ty, int tx) {
  constexpr int P = HD + 4;
#pragma unroll
  for (int a = 0; a < RA; ++a)
#pragma unroll
    for (int b = 0; b < CB; ++b) acc[a][b] = 0.f;
#pragma unroll 2
  for (int d = 0; d < HD; d += 4) {
    float av[RA][4], bv[CB][4];
#pragma unroll
    for (int a = 0; a < RA; ++a) load_vec<4>(av[a], A + (ty + 16 * a) * P + d);
#pragma unroll
    for (int b = 0; b < CB; ++b) load_vec<4>(bv[b], B + (tx + 16 * b) * P + d);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < CB; ++b)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[a][b] = fmaf(av[a][e], bv[b][e], acc[a][b]);
  }
}

// Probability and score gradient of one (query row, key) entry: p and
// ds = p (dp - D) for a live entry, p = 0 and ds = 0 for a masked one or
// one past Sq or Sk; a row at a negative position under the causal mask
// (masked everywhere) has p = 1 / Sk and ds = 0.
__device__ __forceinline__ void entry_grad(float s, float dp, float lse,
                                           float dsum, int row, int key,
                                           int off, int sq, int sk,
                                           int causal, int window,
                                           float scale, float* p, float* ds) {
  *p = 0.f;
  *ds = 0.f;
  if (row >= sq || key >= sk) return;
  const int pos = row + off;
  if (causal && pos < 0) {
    *p = 1.f / static_cast<float>(sk);
    return;
  }
  if ((causal && key > pos) || (window > 0 && pos - key >= window)) return;
  *p = expf(s * scale - lse);
  *ds = *p * (dp - dsum);
}

// ---------------- D = rowsum(dO * O) ----------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dsum(const T* __restrict__ o, const T* __restrict__ dout,
               float* __restrict__ dsum, int rows, int hd) {
  const int row = blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = static_cast<size_t>(row) * hd;
  float acc = 0.f;
  for (int d = lane; d < hd; d += 32)
    acc = fmaf(to_f32(o[base + d]), to_f32(dout[base + d]), acc);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, x);
  if (lane == 0) dsum[row] = acc;
}

// ---------------- dK, dV -----------------------------------------------------

template <int HD>
constexpr size_t smem_bytes_dkdv() {
  using Tl = BwdTiling<HD>;
  return sizeof(float) * (2 * Tl::kBK * Tl::kPitch + 2 * Tl::kBQ * Tl::kPitch +
                          2 * Tl::kBQ * Tl::kPPitch + 2 * Tl::kBQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               T* __restrict__ dk, T* __restrict__ dv, int sq, int sk,
               int group, int causal, int window, float scale) {
  using Tl = BwdTiling<HD>;
  constexpr int BQ = Tl::kBQ, BK = Tl::kBK, P = Tl::kPitch, PP = Tl::kPPitch;
  constexpr int RA = BQ / 16, CB = BK / 16;   // S block a thread
  constexpr int RJ = BK / 16;                 // keys a thread holds
  constexpr int V = Tl::kVec, NC = HD / (16 * V);   // head dims: NC loads of V
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);   // [BK][P]
  float* vs = ks + BK * P;                        // [BK][P]
  float* qs = vs + BK * P;                        // [BQ][P]
  float* dos = qs + BQ * P;                       // [BQ][P]
  float* ps = dos + BQ * P;                       // [BQ][PP]
  float* dss = ps + BQ * PP;                      // [BQ][PP]
  float* lse_s = dss + BQ * PP;                   // [BQ]
  float* dsum_s = lse_s + BQ;                     // [BQ]

  const int bkv = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int off = sk - sq;   // query i sits at position i + off

  load_rows<T, HD>(ks, k + static_cast<size_t>(bkv) * sk * HD, k0, sk, BK, t);
  load_rows<T, HD>(vs, v + static_cast<size_t>(bkv) * sk * HD, k0, sk, BK, t);

  // query rows that can reach this key tile: under the causal mask those
  // at or past its first key (all, when a row sits at a negative position:
  // it sees every key); within the window those before its last key +
  // window
  const int k_last = min(k0 + BK, sk) - 1;
  int i_begin = causal && off >= 0 ? max(0, k0 - off) : 0;
  const int i_end = window > 0 ? min(sq, k_last + window - off) : sq;
  i_begin = (i_begin / BQ) * BQ;

  float acc_dk[RJ][NC * V], acc_dv[RJ][NC * V];
#pragma unroll
  for (int r = 0; r < RJ; ++r)
#pragma unroll
    for (int c = 0; c < NC * V; ++c) acc_dk[r][c] = acc_dv[r][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int bh = bkv * group + g;
    const T* qb = q + static_cast<size_t>(bh) * sq * HD;
    const T* dob = dout + static_cast<size_t>(bh) * sq * HD;
    for (int q0 = i_begin; q0 < i_end; q0 += BQ) {
      __syncthreads();   // the last tile's reads are done
      load_rows<T, HD>(qs, qb, q0, sq, BQ, t);
      load_rows<T, HD>(dos, dob, q0, sq, BQ, t);
      for (int i = t; i < BQ; i += kThreads) {
        const bool in = q0 + i < sq;
        const size_t at = static_cast<size_t>(bh) * sq + q0 + i;
        lse_s[i] = in ? lse[at] : 0.f;
        dsum_s[i] = in ? dsum[at] : 0.f;
      }
      __syncthreads();

      float s[RA][CB], dp[RA][CB];
      tile_dot<HD>(s, qs, ks, ty, tx);
      tile_dot<HD>(dp, dos, vs, ty, tx);
#pragma unroll
      for (int a = 0; a < RA; ++a)
#pragma unroll
        for (int b = 0; b < CB; ++b) {
          const int i = ty + 16 * a, j = tx + 16 * b;
          entry_grad(s[a][b], dp[a][b], lse_s[i], dsum_s[i], q0 + i, k0 + j,
                     off, sq, sk, causal, window, scale, &ps[i * PP + j],
                     &dss[i * PP + j]);
        }
      __syncthreads();

      // dV += P^T dO, dK += dS^T Q over the tile's rows
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        float p[RJ], ds[RJ];
        load_vec<RJ>(p, ps + i * PP + RJ * ty);
        load_vec<RJ>(ds, dss + i * PP + RJ * ty);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          float dov[V], qv[V];
          load_vec<V>(dov, dos + i * P + V * tx + 16 * V * c);
          load_vec<V>(qv, qs + i * P + V * tx + 16 * V * c);
#pragma unroll
          for (int r = 0; r < RJ; ++r)
#pragma unroll
            for (int e = 0; e < V; ++e) {
              acc_dv[r][c * V + e] = fmaf(p[r], dov[e], acc_dv[r][c * V + e]);
              acc_dk[r][c * V + e] = fmaf(ds[r], qv[e], acc_dk[r][c * V + e]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RJ; ++r) {
    const int key = k0 + RJ * ty + r;
    if (key >= sk) continue;
    const size_t at = (static_cast<size_t>(bkv) * sk + key) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < V; ++e) {
        const int d = V * tx + 16 * V * c + e;
        dk[at + d] = from_f32<T>(acc_dk[r][c * V + e] * scale);
        dv[at + d] = from_f32<T>(acc_dv[r][c * V + e]);
      }
  }
}

// ---------------- dQ ---------------------------------------------------------

template <int HD>
constexpr size_t smem_bytes_dq() {
  using Tl = BwdTiling<HD>;
  return sizeof(float) * (2 * Tl::kBQ * Tl::kPitch + 2 * Tl::kBK * Tl::kPitch +
                          Tl::kBK * Tl::kTPitch + 2 * Tl::kBQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ dsum,
             T* __restrict__ dq, int sq, int sk, int group, int causal,
             int window, float scale) {
  using Tl = BwdTiling<HD>;
  constexpr int BQ = Tl::kBQ, BK = Tl::kBK, P = Tl::kPitch, TP = Tl::kTPitch;
  constexpr int RA = BQ / 16, CB = BK / 16;
  constexpr int RQ = BQ / 16;                 // query rows a thread holds
  constexpr int V = Tl::kVec, NC = HD / (16 * V);
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [BQ][P]
  float* dos = qs + BQ * P;                       // [BQ][P]
  float* ks = dos + BQ * P;                       // [BK][P]
  float* vs = ks + BK * P;                        // [BK][P]
  float* dst = vs + BK * P;                       // [BK][TP], dS transposed
  float* lse_s = dst + BK * TP;                   // [BQ]
  float* dsum_s = lse_s + BQ;                     // [BQ]

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;   // long causal rows first
  const int t = threadIdx.x, ty = t / 16, tx = t % 16;
  const int off = sk - sq;
  const T* kb = k + static_cast<size_t>(bh / group) * sk * HD;
  const T* vb = v + static_cast<size_t>(bh / group) * sk * HD;

  load_rows<T, HD>(qs, q + static_cast<size_t>(bh) * sq * HD, q0, sq, BQ, t);
  load_rows<T, HD>(dos, dout + static_cast<size_t>(bh) * sq * HD, q0, sq, BQ,
                   t);
  for (int i = t; i < BQ; i += kThreads) {
    const bool in = q0 + i < sq;
    const size_t at = static_cast<size_t>(bh) * sq + q0 + i;
    lse_s[i] = in ? lse[at] : 0.f;
    dsum_s[i] = in ? dsum[at] : 0.f;
  }

  // keys any row of this tile can see (as the forward walks them)
  const int pos_lo = q0 + off;
  const int pos_hi = min(q0 + BQ, sq) - 1 + off;
  int k_begin = 0, k_end = sk;
  if (!(causal && pos_lo < 0)) {
    if (causal) k_end = min(sk, pos_hi + 1);
    if (window > 0) k_begin = max(0, pos_lo - window + 1);
  }
  k_begin = (k_begin / BK) * BK;

  float acc[RQ][NC * V];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int c = 0; c < NC * V; ++c) acc[r][c] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();   // the last tile's reads are done
    load_rows<T, HD>(ks, kb, k0, sk, BK, t);
    load_rows<T, HD>(vs, vb, k0, sk, BK, t);
    __syncthreads();

    float s[RA][CB], dp[RA][CB];
    tile_dot<HD>(s, qs, ks, ty, tx);
    tile_dot<HD>(dp, dos, vs, ty, tx);
#pragma unroll
    for (int a = 0; a < RA; ++a)
#pragma unroll
      for (int b = 0; b < CB; ++b) {
        const int i = ty + 16 * a, j = tx + 16 * b;
        float p;
        entry_grad(s[a][b], dp[a][b], lse_s[i], dsum_s[i], q0 + i, k0 + j,
                   off, sq, sk, causal, window, scale, &p, &dst[j * TP + i]);
      }
    __syncthreads();

    // dQ += dS K over the tile's keys
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float ds[RQ];
      load_vec<RQ>(ds, dst + j * TP + RQ * ty);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float kv[V];
        load_vec<V>(kv, ks + j * P + V * tx + 16 * V * c);
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
          for (int e = 0; e < V; ++e)
            acc[r][c * V + e] = fmaf(ds[r], kv[e], acc[r][c * V + e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int row = q0 + RQ * ty + r;
    if (row >= sq) continue;
    const size_t at = (static_cast<size_t>(bh) * sq + row) * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < V; ++e)
        dq[at + V * tx + 16 * V * c + e] =
            from_f32<T>(acc[r][c * V + e] * scale);
  }
}

template <typename T, int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* dsum, void* dq,
               void* dk, void* dv, int bhq, int sq, int sk, int group,
               int causal, int window, float scale, cudaStream_t st) {
  using Tl = BwdTiling<HD>;
  constexpr size_t kv_bytes = smem_bytes_dkdv<HD>();
  constexpr size_t q_bytes = smem_bytes_dq<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int rows = bhq * sq;
  constexpr int kWarps = kThreads / 32;
  flash_bwd_dsum<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const T*>(o), dot, dsum, rows, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 kv_grid((sk + Tl::kBK - 1) / Tl::kBK, bhq / group);
  flash_bwd_dkdv<T, HD><<<kv_grid, kThreads, kv_bytes, st>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv),
      sq, sk, group, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 q_grid((sq + Tl::kBQ - 1) / Tl::kBQ, bhq);
  flash_bwd_dq<T, HD><<<q_grid, kThreads, q_bytes, st>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<T*>(dq), sq, sk, group, causal,
      window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int by_head_dim(int hd, const void* q, const void* k, const void* v,
                const void* o, const void* dout, const float* lse, float* dsum,
                void* dq, void* dk, void* dv, int bhq, int sq, int sk,
                int group, int causal, int window, float scale,
                cudaStream_t st) {
#define FLASH_BWD_CASE(HD)                                                   \
  case HD:                                                                   \
    return launch_bwd<T, HD>(q, k, v, o, dout, lse, dsum, dq, dk, dv, bhq,   \
                             sq, sk, group, causal, window, scale, st);
  switch (hd) {
    FLASH_BWD_CASE(16)
    FLASH_BWD_CASE(32)
    FLASH_BWD_CASE(64)
    FLASH_BWD_CASE(128)
    FLASH_BWD_CASE(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_BWD_CASE
}

}  // namespace

extern "C" {

// dq (BHq, Sq, hd), dk and dv (BHq / group, Sk, hd): the gradients of
// o = attention(q, k, v) (flash_attention_launch's function) given dout,
// o and the forward's lse (BHq, Sq, f32).  q, k, v, o, dout, dq, dk, dv
// contiguous and of one type: dtype 0 f32, 1 bf16.  dsum is f32 scratch
// of BHq * Sq.  hd is 16, 32, 64, 128 or 256.  Three kernels on `stream`;
// returns the first non-zero cudaError_t of their launches (0 = success).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* dsum, void* dq,
                               void* dk, void* dv, int dtype, int bhq, int sq,
                               int sk, int hd, int group, int causal,
                               int window, float scale, void* stream) {
  if (bhq < 1 || bhq > 65535 || sq < 1 || sk < 1 || group < 1 ||
      bhq % group)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  if (dtype == 0)
    return by_head_dim<float>(hd, q, k, v, o, dout, l, ds, dq, dk, dv, bhq,
                              sq, sk, group, causal, window, scale, st);
  if (dtype == 1)
    return by_head_dim<bf16>(hd, q, k, v, o, dout, l, ds, dq, dk, dv, bhq,
                             sq, sk, group, causal, window, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

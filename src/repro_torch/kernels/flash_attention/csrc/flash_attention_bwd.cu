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
// FlashAttention-2's scheme in three kernels on `stream`, with no atomics:
//   flash_bwd_dsum  D = rowsum(dO * O), one warp a row;
//   dK/dV pass      a block owns one KV head's 64-key tile and walks the
//                   group's query heads in order and, in each, the query
//                   tiles that can see the tile: S = Q K^T and dP = dO V^T,
//                   P = exp(scale S - lse), dS = P (dP - D), then
//                   dV += P^T dO and dK += dS^T Q in registers;
//   dQ pass         a block owns one query tile of one head and walks the
//                   key tiles it can see (the forward's range), long causal
//                   tiles first: S, dP, dS again, dQ += dS K.
// lse is the forward's per-row logsumexp (flash_attention.cu writes it
// when asked).  Every sum has one owner and a fixed order, so a second
// call gives the same bits (a restart from a checkpoint repeats a run bit
// for bit).  The passes stay two: a single pass would sum dQ across key
// tiles with atomics (no fixed order), or in per-key-tile partials (64
// key tiles x 126 MB of f32 dQ at smollm's training shape, ~8 GB).
//
// Bound.  Five products of 2 Sq Sk hd operations a head (S, dP, dV, dK,
// dQ; half the square under a causal mask) over 989 TFLOP/s of bf16
// tensor cores, or 67 TFLOP/s of f32 CUDA cores; the two passes compute
// seven (S and dP twice).  At smollm-360m's training shape (B 8, Hq 15,
// Hkv 5, hd 64, S 4096, causal, bf16) the five are 0.644 TFLOP: 0.65 ms
// (0.91 ms for the seven).  The bytes (q, k, v, o, dO, lse read once;
// dq, dk, dv written once) take 0.10 ms at 3.35 TB/s.
//
// bf16, hd 16-256: the tensor cores, flash_bwd_dkdv_wgmma<HD> and
// flash_bwd_dq_wgmma<HD>, built from the forward's pieces
// (flash_wgmma.cuh): 64 x HD tiles in swizzled shared memory filled by
// cp.async, read K-major or MN-major by the wgmma descriptors, so no
// operand is copied transposed.
//   dK/dV: the K and V tiles stay in shared memory for the whole walk; Q,
//     dO and the rows' lse and D come through a two-stage ring (the next
//     step's copies go out while S^T is computed, as the forward's K/V).
//     Per step: S^T = K Q^T (both K-major, m64n64k16); P^T on that
//     fragment in registers, packed to bf16 as the A operand of
//     dV += P^T dO (dO read MN-major), issued with dP^T = V dO^T;
//     dS^T = P^T (dP^T - D), packed the same way, for dK += dS^T Q (Q read
//     MN-major).  Up to hd 128 one warpgroup (128 threads) a block; at hd
//     128 dK and dV take 64 f32 a thread each, dP^T 32, the packed P^T or
//     dS^T 16; S^T's 32 are free once P^T is packed, before dP^T is
//     issued.  At hd 256 dK plus dV would take 256 registers a thread of
//     one warpgroup, so a block is two (DkdvWarpgroups): each owns 128 of
//     the 256 columns of dK and dV (64 + 64 f32 a thread, as at hd 128),
//     reads its half of the dO and Q tiles (whole column blocks: a
//     Tile<128> 16 KB in), and computes S^T and dP^T over all 256 columns
//     itself: 6.3 M multiply-adds a step where 4.2 M are needed.  Two
//     other splits were measured at recurrentgemma's training shape
//     (PERF.md, PR 28; git keeps them at e52f4eb): each warpgroup half of
//     S^T's and dP^T's depth, the halves added through shared memory
//     (2 x 16 KB, three barriers a step), made the pass 5-6 % slower at
//     255 registers and 8 bytes of spill; warpgroup 0 computing S^T and
//     P^T, warpgroup 1 dP^T, traded through shared memory (24 KB, one
//     barrier), made it 7-8 % faster with the same bits (4 % of the
//     kernel), for a trade protocol this design does without.  The pass
//     waits for each step's products in turn, so a third less tensor work
//     buys little.
//     One block an SM at hd 256 (194 KB of shared memory), so where key
//     tiles x KV heads are few each KV head's group of query heads is cut
//     into `splits` parts (kernel.py, bwd_kv_splits: the least that gives
//     264 blocks, two an SM of 132), each a block of its own writing f32
//     dK and dV sums; flash_bwd_kv_reduce adds them in part order and
//     rounds once (recurrentgemma B 1, Hkv 1, S 4096: 5 parts, 320 blocks,
//     42 MB of parts).  The key tile varies slowest over the grid there,
//     so the key tiles that see the most query tiles start first.
//   dQ: one warpgroup; Q and dO loaded once, K and V through a two-stage
//     ring; S = Q K^T and dP = dO V^T in one wgmma batch, dS packed for
//     dQ += dS K (K read MN-major).  At hd 256 dQ takes 128 f32 a thread,
//     S and dP 32 each (the forward's design at hd 256).
// Masking is on the fragment in registers, per entry as entry_grad does
// it, only in tiles that cross the diagonal, the window's edge, Sq or Sk;
// a causal row at a negative position has p = 1 / Sk and ds = 0.  dK (times
// scale), dV and dQ (times scale) are rounded once to bf16.
// One rounding is new (ROADMAP Queue 3, B4): P and dS go to bf16 before
// the products they feed, as in every tensor-core flash backward and as
// the forward rounds P (B3); dS is computed from the rounded P, in both
// passes alike.  S, dP, D, lse and every sum stay f32.  Against autograd
// through the plain version this stays within 2e-2 of each gradient's
// largest value (tests/test_torch_flash_attention.py holds the arithmetic
// to jax.vjp of chunked_attention on the CPU).
// Shared memory: dK/dV 6 tiles of 64 x HD bf16 + 1 KB of lse and D + 1 KB
// alignment (98 KB at hd 128, 50 KB at hd 64, 194 KB at hd 256); dQ 6
// tiles + 1 KB (193 KB at hd 256).
// ptxas (CUDA 12.8, -O3 -fmad=false) for hd 16, 32, 64, 128, 256:
// flash_bwd_dkdv_wgmma 102, 122, 160, 229, 234 registers,
// flash_bwd_dq_wgmma 124, 138, 154, 186, 246, no spill (chip_smoke.py's
// build phase prints them and fails on a spill).  Measured (H100 SXM,
// PERF.md): at smollm's training shape 3.0 ms (dK/dV 1.58, dQ 1.33, D
// 0.09), each pass near 30 % of its products' tensor-core time, SDPA's
// backward 1.7 ms; at
// recurrentgemma's (B 1, Hq 10, Hkv 1, hd 256, S 4096, window 2048) 0.92
// ms (dK/dV 0.43, dQ 0.45, D 0.02, the sum of parts 0.014) against a
// 0.163 ms bound, SDPA's backward 2.26 ms and the CUDA-core kernels' 18.9.
// Each step waits for each of its products in turn; TMA loads from a
// producer warp and the next step's S^T issued before this step's dK is
// waited for are the next speed work (ROADMAP).
//
// f32 (every hd): the CUDA cores, flash_bwd_dkdv<T, HD> and
// flash_bwd_dq<T, HD> (T = float only since bf16 runs on the tensor
// cores at every hd), f32 throughout; TF32 could not meet the f32
// tolerance (2e-5).  Tiles
// (BwdTiling): 64 query rows x 64 keys up to hd 128, 32 x 32 at hd 256,
// 256 threads as a 16 x 16 grid.
// Q, K, V, dO tiles are f32 in shared memory with rows padded by 4 floats
// (16-byte loads along hd, conflict free across 8 consecutive rows); each
// thread computes a 4 x 4 (2 x 2 at hd 256) block of S and dP, strided by
// 16 rows and columns, and holds its rows of dK and dV (or dQ) with 4
// consecutive head dims a load.  Shared memory: 111 KB at hd 64 (two
// blocks an SM), 177 KB at hd 128, 146 KB at hd 256 for flash_bwd_dkdv.
// ptxas (CUDA 12.8, -O3 -fmad=false): 77-184 registers; 4 bytes of
// spill in flash_bwd_dkdv<float, 64>, 20 in flash_bwd_dq<float, 128>.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_wgmma.cuh"

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

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

// D = rowsum(dO * O) over `rows` rows of hd, one warp a row
template <typename T>
cudaError_t launch_dsum(const void* o, const T* dout, float* dsum, int rows,
                        int hd, cudaStream_t st) {
  constexpr int kWarps = kThreads / 32;
  flash_bwd_dsum<T><<<(rows + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      static_cast<const T*>(o), dout, dsum, rows, hd);
  return cudaGetLastError();
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
  err = launch_dsum<T>(o, dot, dsum, bhq * sq, HD, st);
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

// ---------------- bf16: tensor cores (wgmma) ---------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// 4 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

// Element `hi` (0 or 1) of a bf16x2 pair, as f32
__device__ __forceinline__ float unpack_bf16(uint32_t a, int hi) {
  return __uint_as_float(hi ? a & 0xffff0000u : a << 16);
}

// x rounded to bf16 (to nearest even, as pack_bf16x2 rounds), as f32
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// p of one entry of a tile that crosses the mask, Sq or Sk, as entry_grad
// gives it, from its score s and its row's lse in log2 units; *live is
// false where ds is 0 (a masked entry, one past Sq or Sk, and a causal
// row at a negative position, whose p is 1 / Sk).
__device__ __forceinline__ float masked_p(float s, float lse2, int row,
                                          int key, int off, int sq, int sk,
                                          int causal, int window,
                                          float scale2, bool* live) {
  *live = false;
  if (row >= sq || key >= sk) return 0.f;
  const int pos = row + off;
  if (causal && pos < 0) return 1.f / static_cast<float>(sk);
  if ((causal && key > pos) || (window > 0 && pos - key >= window)) return 0.f;
  *live = true;
  return exp2f(fmaf(s, scale2, -lse2));
}

__device__ __forceinline__ void put2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Rows row0 + r0 and row0 + r0 + 8 of a 64 x NC f32 fragment, times mul,
// into rows of HD at out (the fragment's NC columns from out; rows at or
// past `rows` are not stored), the columns as the fragment holds them
// (cq = 2 (lane mod 4)): rounded to bf16, or as f32.
template <int HD, int NC = HD, typename T = bf16>
__device__ __forceinline__ void store_rows(T* out, const float* acc,
                                           int row0, int r0, int cq,
                                           int rows, float mul) {
  constexpr int N = NC < 64 ? NC : 64;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + r0 + 8 * h;
    if (row >= rows) continue;
    T* ob = out + static_cast<size_t>(row) * HD;
#pragma unroll
    for (int j = 0; j < NC / N; ++j)
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        const float* x = acc + j * (N / 2) + 4 * i + 2 * h;
        put2(ob + j * N + 8 * i + cq, x[0] * mul, x[1] * mul);
      }
  }
}

// Warpgroups of a dK/dV block: one up to hd 128; two at hd 256, each
// owning half of dK's and dV's columns (64 + 64 f32 a thread, as one
// warpgroup holds at hd 128) and computing S^T and dP^T in full.
template <int HD>
struct DkdvWarpgroups {
  static constexpr int kN = HD > 128 ? 2 : 1;
  static constexpr int kCols = HD / kN;       // dK, dV columns a warpgroup
  static constexpr int kThreads = kN * kWG;
};

template <int HD>
constexpr size_t smem_bytes_dkdv_wgmma() {
  // K, V, 2 x (Q, dO); 2 x (lse, D) of 64 f32; alignment
  return 6 * Tile<HD>::kBytes + 2 * 2 * kRows * sizeof(float) + 1024;
}

// dK, dV of one 64-key tile of one KV head: the query heads of one of
// the group's `splits` parts in order and, in each, the query tiles that
// can see the tile, through a two-stage ring of (Q, dO, lse, D).  With
// one part dK and dV are stored as bf16; with more each part's f32 sums
// go to `partial` (splits, 2, BHkv, Sk, HD) for flash_bwd_kv_reduce.
// Fragment rows are keys k0 + r0, + 8; columns queries q0 + 8i + cq + 0, 1.
template <int HD>
__global__ void __launch_bounds__(DkdvWarpgroups<HD>::kThreads, 1)
flash_bwd_dkdv_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dsum, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, float* __restrict__ partial,
                     int sq, int sk, int group, int splits, int causal,
                     int window, float scale) {
  using W = DkdvWarpgroups<HD>;
  constexpr int kNT = W::kThreads, kCols = W::kCols;
  constexpr bool kTwo = W::kN > 1;
  extern __shared__ uint8_t smem_raw[];
  constexpr int kTile = Tile<HD>::kBytes;
  // a warpgroup's kCols columns of a tile: whole column blocks, laid out
  // as a 64 x kCols tile (Tile<128> at hd 256)
  constexpr int kPart = kRows * kCols * 2;
  const uint32_t ks = aligned_smem(smem_raw);
  const uint32_t vs = ks + kTile;
  const uint32_t ring = vs + kTile;   // stage s: Q at + 2s, dO at + 2s + 1
  const uint32_t stats = ring + 4 * kTile;   // stage s: lse, D at + 128 s
  const float* stats_f = reinterpret_cast<const float*>(
      smem_raw + (stats - smem_addr(smem_raw)));

  // the block's key tile, KV head and part of the group: up to hd 128
  // (one part) the key tile varies fastest; at hd 256 slowest, so that the
  // key tiles with the most query tiles start first
  const int kt = kTwo ? blockIdx.y : blockIdx.x;
  const int hs = kTwo ? blockIdx.x : blockIdx.y;
  const int parts = kTwo ? splits : 1;
  const int bkv = hs / parts, split = hs % parts;
  // the first group % parts parts take one head more
  const int per = group / parts, extra = group % parts;
  const int g0 = split * per + min(split, extra);
  const int heads = per + (split < extra ? 1 : 0);
  const int k0 = kt * kRows;
  const int t = threadIdx.x;
  const int wg = t / kWG;                       // columns kCols wg ..
  const int lane = t & 31;
  const int r0 = 16 * ((t % kWG) >> 5) + (lane >> 2);   // keys k0 + r0, + 8
  const int cq = 2 * (lane & 3);                // queries 8i + cq + 0, 1
  const int off = sk - sq;

  // query tiles that can reach this key tile (as flash_bwd_dkdv)
  const int k_last = min(k0 + kRows, sk) - 1;
  int i_begin = causal && off >= 0 ? max(0, k0 - off) : 0;
  const int i_end = window > 0 ? min(sq, k_last + window - off) : sq;
  i_begin = (i_begin / kRows) * kRows;
  const int tiles =
      i_end > i_begin ? (i_end - i_begin + kRows - 1) / kRows : 0;
  const int steps = heads * tiles;   // (query head, query tile) pairs

  // step n's Q and dO tiles into stage s, with its rows' lse (threads
  // 0-63) and D (64-127); rows past Sq are zeros
  auto load_step = [&](int n, int s) {
    const size_t head =
        static_cast<size_t>(bkv) * group + g0 + n / tiles;
    const int q0 = i_begin + (n % tiles) * kRows;
    load_tile<HD, kNT>(ring + 2 * s * kTile, q + head * sq * HD, q0, sq, t);
    load_tile<HD, kNT>(ring + (2 * s + 1) * kTile, dout + head * sq * HD,
                       q0, sq, t);
    if (!kTwo || t < kWG) {
      const int row = q0 + (t & (kRows - 1));
      const float* src = (t < kRows ? lse : dsum) + head * sq + row;
      cp_async4(stats + 4 * (2 * kRows * s + t), row < sq ? src : lse,
                row < sq ? 4 : 0);
    }
  };
  if (steps > 0) {   // else no query sees the tile: dK = dV = 0
    load_tile<HD, kNT>(ks, k + static_cast<size_t>(bkv) * sk * HD, k0, sk,
                       t);
    load_tile<HD, kNT>(vs, v + static_cast<size_t>(bkv) * sk * HD, k0, sk,
                       t);
    load_step(0, 0);
    cp_async_commit();
  }

  const float scale2 = scale * kLog2e;
  float dk_acc[kCols / 2], dv_acc[kCols / 2], s[32], dp[32];
  uint32_t a[16];
#pragma unroll
  for (int i = 0; i < kCols / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  int stage = 0;
  for (int n = 0; n < steps; ++n, stage ^= 1) {
    const int q0 = i_begin + (n % tiles) * kRows;
    cp_async_wait();
    fence_proxy_async();
    // everyone's copies of this step landed, and everyone is done with
    // the last step, whose stage the copies below refill
    __syncthreads();
    const uint32_t qs = ring + 2 * stage * kTile, dos = qs + kTile;
    const float* lse_s = stats_f + 2 * kRows * stage;
    const float* d_s = lse_s + kRows;
    start_ss<HD>(s, ks, qs);   // S^T = K Q^T
    if (n + 1 < steps) {
      load_step(n + 1, stage ^ 1);
      cp_async_commit();
    }
    wgmma_wait();
    fence_regs<32>(s);
    // mask only where the tile crosses the diagonal, the window's edge, Sq
    // or Sk (uniform over the block)
    const bool masked =
        q0 + kRows > sq || k0 + kRows > sk ||
        (causal && k0 + kRows - 1 > q0 + off) ||
        (window > 0 && q0 + kRows - 1 + off - k0 >= window);
    uint32_t live = ~0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + cq + (i & 1);
      const float lse2 = lse_s[col] * kLog2e;
      if (masked) {
        bool on;
        s[i] = masked_p(s[i], lse2, q0 + col, k0 + r0 + 8 * ((i >> 1) & 1),
                        off, sq, sk, causal, window, scale2, &on);
        if (!on) live &= ~(1u << i);
      } else {
        s[i] = exp2f(fmaf(s[i], scale2, -lse2));
      }
    }
    pack_p(a, s);                     // P^T, rounded to bf16
    start_ss<HD>(dp, vs, dos);        // dP^T = V dO^T
    start_rs<kCols>(dv_acc, a, dos + wg * kPart);   // dV += P^T dO
    wgmma_wait();
    fence_regs<32>(dp);
    fence_regs<kCols / 2>(dv_acc);
    // dS^T = P^T (dP^T - D), from the rounded P^T
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = 8 * (i >> 2) + cq + (i & 1);
      dp[i] = (live >> i) & 1u
                  ? unpack_bf16(a[i >> 1], i & 1) * (dp[i] - d_s[col])
                  : 0.f;
    }
    pack_p(a, dp);                    // dS^T, rounded to bf16
    start_rs<kCols>(dk_acc, a, qs + wg * kPart);    // dK += dS^T Q
    wgmma_wait();
    fence_regs<kCols / 2>(dk_acc);
  }

  const size_t at = static_cast<size_t>(bkv) * sk * HD + wg * kCols;
  if (kTwo && partial) {
    const size_t plane =
        static_cast<size_t>(gridDim.x / parts) * sk * HD;   // BHkv Sk HD
    float* pk = partial + 2 * split * plane + at;
    store_rows<HD, kCols>(pk, dk_acc, k0, r0, cq, sk, 1.f);
    store_rows<HD, kCols>(pk + plane, dv_acc, k0, r0, cq, sk, 1.f);
  } else {
    store_rows<HD, kCols>(dk + at, dk_acc, k0, r0, cq, sk, scale);
    store_rows<HD, kCols>(dv + at, dv_acc, k0, r0, cq, sk, 1.f);
  }
}

// dK and dV from the parts' f32 sums, partial (splits, 2, n): added in
// part order, dK times scale, each rounded once to bf16; four elements a
// thread (n is a multiple of 4), blockIdx.y 0 for dK, 1 for dV.
__global__ void __launch_bounds__(kThreads)
flash_bwd_kv_reduce(const float* __restrict__ partial, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, size_t n, int splits,
                    float scale) {
  const size_t i =
      4 * (static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x);
  if (i >= n) return;
  const int which = blockIdx.y;
  float4 acc = *reinterpret_cast<const float4*>(partial + which * n + i);
  for (int p = 1; p < splits; ++p) {
    const float4 x = *reinterpret_cast<const float4*>(
        partial + (2 * static_cast<size_t>(p) + which) * n + i);
    acc.x += x.x, acc.y += x.y, acc.z += x.z, acc.w += x.w;
  }
  const float mul = which ? 1.f : scale;
  bf16* out = (which ? dv : dk) + i;
  put2(out, acc.x * mul, acc.y * mul);
  put2(out + 2, acc.z * mul, acc.w * mul);
}

template <int HD>
constexpr size_t smem_bytes_dq_wgmma() {
  return 6 * Tile<HD>::kBytes + 1024;   // Q, dO, 2 x (K, V), alignment
}

// dQ of one 64-query tile of one head: the key tiles the forward walks,
// long causal tiles first, K and V through a two-stage ring.  Fragment
// rows are queries q0 + r0, + 8; columns keys k0 + 8i + cq + 0, 1.
template <int HD>
__global__ void __launch_bounds__(kWG, 1)
flash_bwd_dq_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ dsum, bf16* __restrict__ dq,
                   int sq, int sk, int group, int causal, int window,
                   float scale) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kTile = Tile<HD>::kBytes;
  const uint32_t qs = aligned_smem(smem_raw);
  const uint32_t dos = qs + kTile;
  const uint32_t ring = dos + kTile;   // stage s: K at + 2s, V at + 2s + 1

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int r0 = 16 * (t >> 5) + (lane >> 2);   // queries q0 + r0, + 8
  const int cq = 2 * (lane & 3);                // keys 8i + cq + 0, 1
  const int off = sk - sq;
  const bf16* kb = k + static_cast<size_t>(bh / group) * sk * HD;
  const bf16* vb = v + static_cast<size_t>(bh / group) * sk * HD;

  // keys any row of this tile can see (as the forward walks them)
  const int pos_lo = q0 + off;
  const int pos_hi = min(q0 + kRows, sq) - 1 + off;
  int k_begin = 0, k_end = sk;
  if (!(causal && pos_lo < 0)) {
    if (causal) k_end = min(sk, pos_hi + 1);
    if (window > 0) k_begin = max(0, pos_lo - window + 1);
  }
  k_begin = (k_begin / kRows) * kRows;

  const size_t head = static_cast<size_t>(bh) * sq;
  load_tile<HD>(qs, q + head * HD, q0, sq, t);
  load_tile<HD>(dos, dout + head * HD, q0, sq, t);
  load_tile<HD>(ring, kb, k_begin, sk, t);
  load_tile<HD>(ring + kTile, vb, k_begin, sk, t);
  cp_async_commit();

  // lse (log2 units) and D of rows r0, r0 + 8
  float lse2[2], dd[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + r0 + 8 * h;
    lse2[h] = row < sq ? lse[head + row] * kLog2e : 0.f;
    dd[h] = row < sq ? dsum[head + row] : 0.f;
  }

  const float scale2 = scale * kLog2e;
  float acc[HD / 2], s[32], dp[32];
  uint32_t a[16];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  int stage = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kRows, stage ^= 1) {
    cp_async_wait();
    fence_proxy_async();
    __syncthreads();
    const uint32_t ks = ring + 2 * stage * kTile, vs = ks + kTile;
    start_ss<HD>(s, qs, ks);     // S = Q K^T
    start_ss<HD>(dp, dos, vs);   // dP = dO V^T
    if (k0 + kRows < k_end) {
      const uint32_t next = ring + 2 * (stage ^ 1) * kTile;
      load_tile<HD>(next, kb, k0 + kRows, sk, t);
      load_tile<HD>(next + kTile, vb, k0 + kRows, sk, t);
      cp_async_commit();
    }
    wgmma_wait();
    fence_regs<32>(s);
    fence_regs<32>(dp);
    // as the forward masks (rows past Sq are zeros and never stored)
    const bool masked =
        k0 + kRows > sk || (causal && k0 + kRows - 1 > pos_lo) ||
        (window > 0 && q0 + kRows - 1 + off - k0 >= window);
    uint32_t live = ~0u;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int h = (i >> 1) & 1;
      if (masked) {
        bool on;
        s[i] = masked_p(s[i], lse2[h], q0 + r0 + 8 * h,
                        k0 + 8 * (i >> 2) + cq + (i & 1), off, sq, sk,
                        causal, window, scale2, &on);
        if (!on) live &= ~(1u << i);
      } else {
        s[i] = exp2f(fmaf(s[i], scale2, -lse2[h]));
      }
    }
    // dS = P (dP - D) from P rounded to bf16, as the dK/dV pass has it
#pragma unroll
    for (int i = 0; i < 32; ++i)
      dp[i] = (live >> i) & 1u
                  ? round_bf16(s[i]) * (dp[i] - dd[(i >> 1) & 1])
                  : 0.f;
    pack_p(a, dp);                  // dS, rounded to bf16
    start_rs<HD>(acc, a, ks);       // dQ += dS K
    wgmma_wait();
    fence_regs<HD / 2>(acc);
  }

  store_rows<HD>(dq + head * HD, acc, q0, r0, cq, sq, scale);
}

template <int HD>
int launch_bwd_wgmma(const void* q, const void* k, const void* v,
                     const void* o, const void* dout, const float* lse,
                     float* dsum, float* partial, void* dq, void* dk,
                     void* dv, int bhq, int sq, int sk, int group,
                     int splits, int causal, int window, float scale,
                     cudaStream_t st) {
  using W = DkdvWarpgroups<HD>;
  constexpr size_t kv_bytes = smem_bytes_dkdv_wgmma<HD>();
  constexpr size_t q_bytes = smem_bytes_dq_wgmma<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  bf16* dkt = static_cast<bf16*>(dk);
  bf16* dvt = static_cast<bf16*>(dv);
  err = launch_dsum<bf16>(o, dot, dsum, bhq * sq, HD, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (sk + kRows - 1) / kRows, parts = bhq / group * splits;
  const dim3 kv_grid = W::kN > 1 ? dim3(parts, tiles) : dim3(tiles, parts);
  flash_bwd_dkdv_wgmma<HD><<<kv_grid, W::kThreads, kv_bytes, st>>>(
      qt, kt, vt, dot, lse, dsum, dkt, dvt, splits > 1 ? partial : nullptr,
      sq, sk, group, splits, causal, window, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (splits > 1) {
    const size_t n = static_cast<size_t>(bhq / group) * sk * HD;
    const dim3 grid(static_cast<unsigned>((n / 4 + kThreads - 1) / kThreads),
                    2);
    flash_bwd_kv_reduce<<<grid, kThreads, 0, st>>>(partial, dkt, dvt, n,
                                                   splits, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 q_grid((sq + kRows - 1) / kRows, bhq);
  flash_bwd_dq_wgmma<HD><<<q_grid, kWG, q_bytes, st>>>(
      qt, kt, vt, dot, lse, dsum, static_cast<bf16*>(dq), sq, sk, group,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// bf16 on the tensor cores; f32 on the CUDA cores
template <typename T, int HD>
int launch_any(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* dsum,
               float* partial, void* dq, void* dk, void* dv, int bhq, int sq,
               int sk, int group, int splits, int causal, int window,
               float scale, cudaStream_t st) {
  if constexpr (std::is_same<T, bf16>::value)
    return launch_bwd_wgmma<HD>(q, k, v, o, dout, lse, dsum, partial, dq, dk,
                                dv, bhq, sq, sk, group, splits, causal,
                                window, scale, st);
  else
    return launch_bwd<T, HD>(q, k, v, o, dout, lse, dsum, dq, dk, dv, bhq,
                             sq, sk, group, causal, window, scale, st);
}

template <typename T>
int by_head_dim(int hd, const void* q, const void* k, const void* v,
                const void* o, const void* dout, const float* lse, float* dsum,
                float* partial, void* dq, void* dk, void* dv, int bhq, int sq,
                int sk, int group, int splits, int causal, int window,
                float scale, cudaStream_t st) {
#define FLASH_BWD_CASE(HD)                                                   \
  case HD:                                                                   \
    return launch_any<T, HD>(q, k, v, o, dout, lse, dsum, partial, dq, dk,   \
                             dv, bhq, sq, sk, group, splits, causal, window, \
                             scale, st);
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
// of BHq * Sq.  hd is 16, 32, 64, 128 or 256.  `splits` parts of each
// group of query heads walk a key tile in separate blocks: 1, or, for
// bf16 at hd 256 only, up to `group`, with `partial` f32 scratch of
// splits * 2 * (BHq / group) * Sk * hd.  Three kernels on `stream`, four
// with parts; returns the first non-zero cudaError_t of their launches
// (0 = success).
int flash_attention_bwd_launch(const void* q, const void* k, const void* v,
                               const void* o, const void* dout,
                               const void* lse, void* dsum, void* partial,
                               void* dq, void* dk, void* dv, int dtype,
                               int bhq, int sq, int sk, int hd, int group,
                               int splits, int causal, int window,
                               float scale, void* stream) {
  if (bhq < 1 || bhq > 65535 || sq < 1 || sk < 1 || group < 1 ||
      bhq % group || splits < 1 || splits > group ||
      (splits > 1 && (dtype != 1 || hd != 256 || partial == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* ds = static_cast<float*>(dsum);
  float* part = static_cast<float*>(partial);
  if (dtype == 0)
    return by_head_dim<float>(hd, q, k, v, o, dout, l, ds, part, dq, dk, dv,
                              bhq, sq, sk, group, splits, causal, window,
                              scale, st);
  if (dtype == 1)
    return by_head_dim<bf16>(hd, q, k, v, o, dout, l, ds, part, dq, dk, dv,
                             bhq, sq, sk, group, splits, causal, window,
                             scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

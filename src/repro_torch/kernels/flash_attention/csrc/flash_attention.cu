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
// does.  Scores, the online softmax (max, denominator, rescale) and the
// output accumulator are f32 for f32 and bf16 inputs alike; the output is
// rounded once to the input's type.  No atomics: a second call gives the
// same bits.
//
// Ragged lengths: the TPU wrapper picks block sizes that divide Sq and
// Sk.  Here the tiles are fixed and the kernel masks the ragged edge
// itself: a query row past Sq is computed on zeros and never stored; a
// key past Sk does not exist (its probability is an exact 0, not the
// -1e30 of a masked key).  Key tiles that no row of the query tile can see
// (wholly above the causal diagonal, or wholly behind the window) are
// skipped: a masked key adds an exact 0 once a row has seen a live key
// (the rescale factor of what came before is then exactly 0), so skipping
// is exact for every row that has one.  A causal tile with a row at a
// negative position (Sq > Sk) has a row with no live key, and walks every
// key tile so that row gets the plain version's mean of V.
//
// Bound.  The work is 4 * BH * hd * (live score entries) operations (QK^T
// and PV), half the square under a causal mask, and the bytes are q, k, v
// read once and o written once.  989 TFLOP/s of bf16 tensor-core rate
// against 3.35 TB/s puts the line at ~295 operations a byte.  At the main
// path's bf16 shapes (H100 SXM data-sheet rates):
//   qwen3-moe prefill, Hq 32, Hkv 4, hd 128, causal:
//     S 128   0.135 GFLOP, 2.36 MB  -> 0.000704 ms (bytes)
//     S 512   2.15 GFLOP,  9.44 MB  -> 0.00282 ms (bytes)
//     S 2048  34.4 GFLOP,  37.7 MB  -> 0.0348 ms (operations)
//   recurrentgemma-2b local attention, Hq 10, Hkv 1, hd 256, window 2048:
//     S 1900  18.5 GFLOP,  21.4 MB  -> 0.0187 ms (operations)
//     S 3300  47.7 GFLOP,  37.2 MB  -> 0.0483 ms (operations)
//
// Two paths, split by type.
//
// bf16: tensor cores through wgmma (sm_90a), flash_fwd_wgmma<HD>, built
// from the tiles, copies, descriptors and products of flash_wgmma.cuh,
// which the backward (flash_attention_bwd.cu) shares.  One block of one
// warpgroup (128 threads) per (64-query tile, folded head);
// query tiles are walked last-first so the long causal tiles start first.
// Q is loaded once; K and V go through a two-stage ring in shared memory:
// the next tile's 16-byte cp.async copies are started while the tensor
// cores compute this tile's S, and one barrier a tile (after waiting for
// them) both publishes them and frees the stage they refill next.  Rows
// past Sq or Sk are zero-filled by the src-size form of cp.async and never
// read.  The copies write straight into the layout the wgmma descriptors
// name: per 64-row tile, column blocks of min(hd, 64) elements, rows of
// W = min(2 hd, 128) bytes, 16-byte chunks swizzled (chunk ^= (address >>
// 7) mod W/16: the 128/64/32-byte swizzle modes), so no transpose copy.
// Per 64-key tile:
//   S = Q K^T   wgmma m64n64k16, Q and K from shared memory, both K-major,
//               hd/16 instructions into 32 f32 per thread;
//   mask and online softmax on that fragment in registers: a thread holds
//               two rows (r, r+8) of its warp's 16, row max and sum are
//               reductions over the four lanes of a quad (xor 1, 2); exp2
//               of scores pre-scaled by log2(e) / sqrt(hd);
//   O += P V    wgmma m64nNk16 (N = min(hd, 64), hd/N per k16 step), A = P
//               from registers: the f32 score fragment packed in pairs to
//               bf16x2 is the A fragment (a0..a3 = d[8kk + 0,1 | 2,3 | 4,5
//               | 6,7]), no shuffle; B = V read MN-major (transpose-B).
// Each wgmma group is fenced, committed and waited for before its
// registers are touched.  Shared memory: (1 + 2 x 2) tiles of 64 x hd
// bf16, plus 1 KB for alignment: 160 KB at hd 256 (one block an SM), 80 KB
// at hd 128 (two).  Registers: O is hd/2 f32 a thread (128 at hd 256), S
// 32, P 16; the descriptors are kept from being hoisted out of the key
// loop, where 2 x hd/16 of them would hold 64-bit registers (hd 256
// spilled).
// ptxas for flash_fwd_wgmma<16, 32, 64, 128, 256> (CUDA 12.8, -O3
// -fmad=false): 90, 96, 124, 162, 220 registers, no spill (chip_smoke.py's
// build phase prints and checks it).
// Measured variants that were not faster (PERF.md): S of tile t+1
// started before the softmax of tile t; two warpgroups sharing each K, V
// tile (128 query rows, half the copies, but the two run in step, so
// neither's softmax overlaps the other's products); a third stage.  The
// cost that is left grows with the bytes copied and is paid where the
// copies are started, not waited for: TMA loads from a producer warp, with
// two consumer warpgroups taking turns on the tensor cores, are the next
// step (ROADMAP).
//
// One rounding is new (ROADMAP Queue 3, B3): P goes to bf16 before the
// P V product, as in every tensor-core flash kernel; the TPU kernel keeps
// p in f32 (repro/kernels/flash_attention/kernel.py:58-64).  Q K^T has no
// new rounding (bf16 x bf16 products are exact in f32).  The softmax's
// denominator sums the unrounded f32 p.  Against the plain version on bf16
// inputs this costs about one bf16 step of the output
// (tests/test_torch_flash_attention.py holds it within 2e-2).
//
// f32: the CUDA cores, flash_fwd_f32<HD>, unchanged from the first port up
// to hd 256.  The f32 tolerance (2e-5) rules out TF32 tensor cores.  One
// block of 128 threads per (32-query tile, folded head), four threads a
// query row, each computing 16 of a 64-key tile's scores and a quarter of
// the row's output dims; Q, K, V converted tiles in shared memory (rows
// padded by one float against bank conflicts): 169 KB at hd 256.
//
// Both kernels write each row's f32 logsumexp of its scaled, masked scores
// when given an lse pointer (training: the backward in
// flash_attention_bwd.cu reads it), from the running max and sum they hold
// anyway; a null pointer leaves the serving launch as it was.
//
// Head dims above 256 (hd 512 and 1024, F1 and F2 in ROADMAP Queue 3) run
// only here, bf16 inputs widened to f32 around the call by the wrapper, so
// they keep p in f32 as the TPU kernel does.  The same code on smaller
// tilings (F32Tiling), each halving the query rows and keys and doubling
// the threads a row (one warp holds whole rows): hd 512 takes 16 query
// rows a block, 32-key tiles and eight threads a row (166 KB of shared
// memory), hd 1024 8 rows, 16-key tiles and 16 threads a row (q 32 KB, k
// 64 KB, v 64 KB: 161 KB); each thread holds hd / threads-a-row = 64
// accumulators, as at hd 256.  No config has such a head dim; it is held
// to the plain version, not made fast.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------- f32: CUDA cores ------------------------------------------

// The f32 kernel's tiling at head dim HD: query rows a block, keys a tile
// and threads a query row (a power of two, so a row lies in one warp);
// halved, halved and doubled at hd 512, again at hd 1024.
template <int HD>
struct F32Tiling {
  static constexpr int kWide = HD > 512 ? 2 : (HD > 256 ? 1 : 0);
  static constexpr int kBQ = 32 >> kWide;
  static constexpr int kBK = 64 >> kWide;
  static constexpr int kTPR = 4 << kWide;
  static constexpr int kThreads = kBQ * kTPR;   // 128
  static constexpr int kPerThread = kBK / kTPR;  // scores of a tile a thread
  static constexpr int kDims = HD / kTPR;        // output dims a thread
};

template <int HD>
constexpr size_t smem_bytes_f32() {
  constexpr int kBQ = F32Tiling<HD>::kBQ, kBK = F32Tiling<HD>::kBK;
  return sizeof(float) *
         (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1));
}

template <int HD>
__global__ void __launch_bounds__(F32Tiling<HD>::kThreads)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int sq, int sk, int group, int causal,
              int window, float scale) {
  constexpr int kBQ = F32Tiling<HD>::kBQ, kBK = F32Tiling<HD>::kBK;
  constexpr int kTPR = F32Tiling<HD>::kTPR;
  constexpr int kThreads = F32Tiling<HD>::kThreads;
  constexpr int kPerThread = F32Tiling<HD>::kPerThread;
  constexpr int kDims = F32Tiling<HD>::kDims;
  extern __shared__ float smem[];
  float* qs = smem;                       // [kBQ][HD + 1]
  float* ks = qs + kBQ * (HD + 1);        // [kBK][HD + 1]
  float* vs = ks + kBK * (HD + 1);        // [kBK][HD]
  float* ps = vs + kBK * HD;              // [kBQ][kBK + 1]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int t = threadIdx.x;
  const int r = t / kTPR;                 // query row within the tile
  const int c = t % kTPR;                 // which of the row's threads
  const int off = sk - sq;                // query i sits at position i + off
  const float* qb = q + static_cast<size_t>(bh) * sq * HD;
  const float* kb = k + static_cast<size_t>(bh / group) * sk * HD;
  const float* vb = v + static_cast<size_t>(bh / group) * sk * HD;

  for (int i = t; i < kBQ * HD; i += kThreads) {
    const int rr = i / HD, d = i % HD;
    qs[rr * (HD + 1) + d] =
        q0 + rr < sq ? qb[static_cast<size_t>(q0 + rr) * HD + d] : 0.f;
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
  float acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) acc[i] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    __syncthreads();  // q tile written; last tile's K/V reads done
    for (int i = t; i < kBK * HD; i += kThreads) {
      const int j = i / HD, d = i % HD;
      const bool in = k0 + j < sk;
      const size_t at = static_cast<size_t>(k0 + j) * HD + d;
      ks[j * (HD + 1) + d] = in ? kb[at] : 0.f;
      vs[j * HD + d] = in ? vb[at] : 0.f;
    }
    __syncthreads();

    float s[kPerThread];
#pragma unroll
    for (int jj = 0; jj < kPerThread; ++jj) s[jj] = 0.f;
    for (int d = 0; d < HD; ++d) {
      const float qd = qs[r * (HD + 1) + d];
#pragma unroll
      for (int jj = 0; jj < kPerThread; ++jj)
        s[jj] = fmaf(qd, ks[(c + kTPR * jj) * (HD + 1) + d], s[jj]);
    }
    float tile_max = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kPerThread; ++jj) {
      const int key = k0 + c + kTPR * jj;
      bool live = true;
      if (causal) live = live && key <= qpos;
      if (window > 0) live = live && (qpos - key) < window;
      s[jj] = key >= sk ? -INFINITY : (live ? s[jj] * scale : kNegInf);
      tile_max = fmaxf(tile_max, s[jj]);
    }
#pragma unroll
    for (int x = 1; x < kTPR; x <<= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, x));
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < kPerThread; ++jj) {
      const float p = expf(s[jj] - m_new);
      ps[r * (kBK + 1) + c + kTPR * jj] = p;
      psum += p;
    }
    l = l * corr + psum;
    m = m_new;
    __syncwarp();  // the row's threads share one warp
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[i] *= corr;
    const int nk = min(kBK, sk - k0);
    for (int j = 0; j < nk; ++j) {
      const float p = ps[r * (kBK + 1) + j];
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        acc[i] = fmaf(p, vs[j * HD + c + kTPR * i], acc[i]);
    }
  }

#pragma unroll
  for (int x = 1; x < kTPR; x <<= 1) l += __shfl_xor_sync(0xffffffffu, l, x);
  if (q0 + r < sq) {
    const float inv_l = 1.f / fmaxf(l, 1e-30f);
    float* ob = o + (static_cast<size_t>(bh) * sq + q0 + r) * HD;
#pragma unroll
    for (int i = 0; i < kDims; ++i) ob[c + kTPR * i] = acc[i] * inv_l;
    // m is uniform over the row's threads; a row masked everywhere has
    // m = -1e30, and -1e30 + log(l) rounds to -1e30, as logsumexp gives
    if (lse != nullptr && c == 0)
      lse[static_cast<size_t>(bh) * sq + q0 + r] = m + logf(l);
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int bhq, int sq, int sk, int group, int causal,
               int window, float scale, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes_f32<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kBQ = F32Tiling<HD>::kBQ;
  const dim3 grid((sq + kBQ - 1) / kBQ, bhq);
  flash_fwd_f32<HD><<<grid, F32Tiling<HD>::kThreads, bytes, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, sq, sk,
      group, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------- bf16: tensor cores (wgmma) -------------------------------

// (the tiles, copies, descriptors and products: flash_wgmma.cuh)

template <int HD>
constexpr size_t smem_bytes_bf16() {
  return 5 * Tile<HD>::kBytes + 1024;   // Q, 2 x (K, V), alignment
}

// Mask and scale one 64-key tile's scores s (keys k0..) in place, then the
// online softmax of rows pos0, pos0 + 8: the running max m and sum l are
// updated, s becomes P = exp2(s - m), and corr is the factor the output
// accumulated so far is rescaled by.  `masked` (uniform over the block)
// is false where no key of the tile is past Sk, above the diagonal or
// behind the window for any row.
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l,
                                             float* corr, bool masked,
                                             int k0, int pos0, int cq,
                                             int sk, int causal, int window,
                                             float scale2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;                      // row pos0 + 8h
    if (masked) {
      const int key = k0 + 8 * (i >> 2) + cq + (i & 1);
      const int pos = pos0 + 8 * h;
      const bool live = (!causal || key <= pos) &&
                        (window <= 0 || pos - key < window);
      s[i] = key >= sk ? -INFINITY : (live ? s[i] * scale2 : kNegInf);
    } else {
      s[i] *= scale2;
    }
    mx[h] = fmaxf(mx[h], s[i]);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    corr[h] = exp2f(m[h] - m_new);
    m[h] = m_new;
    l[h] *= corr[h];
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int h = (i >> 1) & 1;
    s[i] = exp2f(s[i] - m[h]);
    l[h] += s[i];
  }
}

template <int HD>
__global__ void __launch_bounds__(kWG)
flash_fwd_wgmma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o,
                float* __restrict__ lse, int sq, int sk, int group, int causal,
                int window, float scale) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kTile = Tile<HD>::kBytes;
  const uint32_t qs = aligned_smem(smem_raw);
  const uint32_t ring = qs + kTile;      // stage s: K at + 2s, V at + 2s + 1

  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int r0 = 16 * (t >> 5) + (lane >> 2);   // rows r0 and r0 + 8
  const int cq = 2 * (lane & 3);                // columns 8i + cq + 0, 1
  const int off = sk - sq;
  const bf16* kb = k + static_cast<size_t>(bh / group) * sk * HD;
  const bf16* vb = v + static_cast<size_t>(bh / group) * sk * HD;

  // keys any row of this tile can see (as flash_fwd_f32)
  const int pos_lo = q0 + off;
  const int pos_hi = min(q0 + kRows, sq) - 1 + off;
  int k_begin = 0, k_end = sk;
  if (!(causal && pos_lo < 0)) {
    if (causal) k_end = min(sk, pos_hi + 1);
    if (window > 0) k_begin = max(0, pos_lo - window + 1);
  }
  k_begin = (k_begin / kRows) * kRows;

  load_tile<HD>(qs, q + static_cast<size_t>(bh) * sq * HD, q0, sq, t);
  load_tile<HD>(ring, kb, k_begin, sk, t);
  load_tile<HD>(ring + kTile, vb, k_begin, sk, t);
  cp_async_commit();

  const float scale2 = scale * 1.4426950408889634f;   // exp -> exp2
  const int pos0 = q0 + r0 + off;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, corr[2];
  float acc[HD / 2], s[32];
  uint32_t a[16];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;

  int stage = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kRows, stage ^= 1) {
    cp_async_wait();
    fence_proxy_async();
    // everyone's copies of this tile landed, and everyone is done with the
    // last tile, whose stage the copies below refill
    __syncthreads();
    const uint32_t ks = ring + 2 * stage * kTile;
    start_ss<HD>(s, qs, ks);
    // the next tile's copies go out while the tensor cores work
    if (k0 + kRows < k_end) {
      const uint32_t next = ring + 2 * (stage ^ 1) * kTile;
      load_tile<HD>(next, kb, k0 + kRows, sk, t);
      load_tile<HD>(next + kTile, vb, k0 + kRows, sk, t);
      cp_async_commit();
    }
    wgmma_wait();
    fence_regs<32>(s);
    // mask only where the tile crosses the diagonal, the window's edge or
    // Sk (uniform over the block)
    const bool masked =
        k0 + kRows > sk || (causal && k0 + kRows - 1 > pos_lo) ||
        (window > 0 && q0 + kRows - 1 + off - k0 >= window);
    softmax_tile(s, m, l, corr, masked, k0, pos0, cq, sk, causal, window,
                 scale2);
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
    pack_p(a, s);
    start_rs<HD>(acc, a, ks + kTile);
    wgmma_wait();
    fence_regs<HD / 2>(acc);
  }

  // store rows r0, r0 + 8 of the tile, columns as the fragment holds them
  constexpr int N = HD < 64 ? HD : 64;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = q0 + r0 + 8 * h;
    if (row >= sq) continue;
    // m is in log2 units (scores pre-scaled by log2(e)) but for a row
    // masked everywhere, whose m is the unscaled -1e30
    if (lse != nullptr && (lane & 3) == 0)
      lse[static_cast<size_t>(bh) * sq + row] =
          m[h] == kNegInf ? kNegInf + logf(l[h])
                          : m[h] * 0.6931471805599453f + logf(l[h]);
    const float inv_l = 1.f / fmaxf(l[h], 1e-30f);
    bf16* ob = o + (static_cast<size_t>(bh) * sq + row) * HD;
#pragma unroll
    for (int j = 0; j < HD / N; ++j)
#pragma unroll
      for (int i = 0; i < N / 8; ++i) {
        const float* x = acc + j * (N / 2) + 4 * i + 2 * h;
        *reinterpret_cast<__nv_bfloat162*>(ob + j * N + 8 * i + cq) =
            __floats2bfloat162_rn(x[0] * inv_l, x[1] * inv_l);
      }
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int bhq, int sq, int sk, int group, int causal,
                int window, float scale, cudaStream_t st) {
  constexpr size_t bytes = smem_bytes_bf16<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kRows - 1) / kRows, bhq);
  flash_fwd_wgmma<HD><<<grid, kWG, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), lse, sq, sk,
      group, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// The tile products alone, for testing the descriptors and fragment
// layouts: s (64 x 64 f32) = q k^T and o (64 x HD f32) = p v, q, k, v
// (64 x HD) and p (64 x 64) bf16, one warpgroup, through the same loads
// and wgmma calls as flash_fwd_wgmma.
template <int HD>
__global__ void __launch_bounds__(kWG)
wgmma_probe(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ p,
            float* __restrict__ s_out, float* __restrict__ o_out) {
  extern __shared__ uint8_t smem_raw[];
  constexpr int kTile = Tile<HD>::kBytes;
  const uint32_t qs = aligned_smem(smem_raw);
  const int t = threadIdx.x, lane = t & 31;
  const int r0 = 16 * (t >> 5) + (lane >> 2), cq = 2 * (lane & 3);
  load_tile<HD>(qs, q, 0, kRows, t);
  load_tile<HD>(qs + kTile, k, 0, kRows, t);
  load_tile<HD>(qs + 2 * kTile, v, 0, kRows, t);
  cp_async_commit();
  cp_async_wait();
  fence_proxy_async();
  __syncthreads();

  float s[32], acc[HD / 2];
  uint32_t a[16];
  start_ss<HD>(s, qs, qs + kTile);
  wgmma_wait();
  fence_regs<32>(s);
#pragma unroll
  for (int i = 0; i < 32; ++i) {   // fragment element i of rows r0, r0 + 8
    const int idx = (r0 + 8 * ((i >> 1) & 1)) * kRows + 8 * (i >> 2) + cq +
                    (i & 1);
    s_out[idx] = s[i];
    s[i] = __bfloat162float(p[idx]);
  }
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  pack_p(a, s);
  start_rs<HD>(acc, a, qs + 2 * kTile);
  wgmma_wait();
  fence_regs<HD / 2>(acc);
  constexpr int N = HD < 64 ? HD : 64;
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) {
    const int j = i / (N / 2), e = i % (N / 2);
    const int row = r0 + 8 * ((e >> 1) & 1);
    o_out[row * HD + j * N + 8 * (e >> 2) + cq + (e & 1)] = acc[i];
  }
}

template <int HD>
int launch_probe(const void* q, const void* k, const void* v, const void* p,
                 void* s, void* o, cudaStream_t st) {
  constexpr size_t bytes = 3 * Tile<HD>::kBytes + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_probe<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  wgmma_probe<HD><<<1, kWG, bytes, st>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(p),
      static_cast<float*>(s), static_cast<float*>(o));
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, hd>) for each head dim both kernels take
template <typename F>
int by_head_dim(int hd, F&& f) {
  switch (hd) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 128: return f(std::integral_constant<int, 128>{});
    case 256: return f(std::integral_constant<int, 256>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// o (BHq, Sq, hd) = attention of q (BHq, Sq, hd) over k, v (BHq / group,
// Sk, hd), all contiguous and of one type: dtype 0 is f32 (CUDA cores),
// 1 is bf16 (wgmma; pointers 16-byte aligned).  hd is 16, 32, 64, 128 or
// 256, and for f32 also 512 and 1024.  lse, when not null, receives each
// row's f32 logsumexp of its scaled, masked scores (BHq, Sq), what the
// backward pass reads.  Launches on `stream`; returns the cudaError_t of
// the launch (0 = success).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, void* lse, int dtype, int bhq, int sq,
                           int sk, int hd, int group, int causal, int window,
                           float scale, void* stream) {
  if (bhq < 1 || bhq > 65535 || sq < 1 || sk < 1 || group < 1 ||
      bhq % group)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0 && hd == 512)
    return launch_f32<512>(q, k, v, o, l, bhq, sq, sk, group, causal, window,
                           scale, st);
  if (dtype == 0 && hd == 1024)
    return launch_f32<1024>(q, k, v, o, l, bhq, sq, sk, group, causal, window,
                            scale, st);
  if (dtype == 0)
    return by_head_dim(hd, [&](auto h) {
      return launch_f32<decltype(h)::value>(q, k, v, o, l, bhq, sq, sk,
                                            group, causal, window, scale,
                                            st);
    });
  if (dtype == 1)
    return by_head_dim(hd, [&](auto h) {
      return launch_bf16<decltype(h)::value>(q, k, v, o, l, bhq, sq, sk,
                                             group, causal, window, scale,
                                             st);
    });
  return static_cast<int>(cudaErrorInvalidValue);
}

// The wgmma tile products alone (bf16 q, k, v (64, hd), p (64, 64); f32
// s (64, 64) = q k^T, o (64, hd) = p v): one block on `stream`.
int flash_wgmma_probe_launch(const void* q, const void* k, const void* v,
                             const void* p, void* s, void* o, int hd,
                             void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_head_dim(hd, [&](auto h) {
    return launch_probe<decltype(h)::value>(q, k, v, p, s, o, st);
  });
}

}  // extern "C"

// Grouped expert FFN over capacity-padded buffers, for Hopper: two passes
// that stream the expert weights near the card's memory rate.
//
// Replaces the TPU kernel repro/kernels/moe_gmm/kernel.py::_kernel
// (launched by moe_gmm_fwd) and computes what ref.moe_gmm_ref computes:
// for every expert e and capacity row c,
//   out[e, c, :] = (act(h[e, c] @ Wg[e]) * (h[e, c] @ Wu[e])) @ Wd[e]
// with h (E, C, D), Wg/Wu (E, D, F), Wd (E, F, D) and act the config's
// activation (models/moe.py:101 of the JAX package): silu, gelu in its tanh
// form (jax.nn.gelu) or relu, a compile-time parameter of the first
// pass.  Products, the activation and every sum are f32 for f32 and bf16
// inputs alike; the output is rounded once to h's type.  Empty capacity
// rows are computed like any other (the model's dispatch leaves them
// zero).
//
// Bound.  Every expert's three weight matrices are read once: 6 * E * D *
// F bytes in bf16, 1.208 GB per qwen3-moe layer (E 128, D 2048, F 768),
// 0.36 ms at 3.35 TB/s.  The operations are 6 * E * C * D * F: about four
// per weight byte at a 4-slot decode step (C = 4), where the tensor cores
// would need ~295 to be the limit.  So the kernel is bound by reading the
// weights, and its design is about keeping enough bytes in flight on
// every SM.
//
// Design.  The TPU kernel walks F inside one grid step per (expert, row
// block), keeping the (block_c, bf) activation and a (block_c, D) f32
// accumulator in VMEM.  Carried over as it was, that gave one block per
// expert at decode (128 blocks on 132 SMs, each walking 9.4 MB alone) and
// 22 % of the memory rate.  Here the work is split in two passes, each
// over (column tile, row tile, expert), so that thousands of blocks fill
// the card:
//   1. moe_gmm_gate_up: act[e, c, f] = act(h @ Wg) * (h @ Wu), written
//      as f32 to a scratch (E, C, F) buffer that the wrapper allocates;
//   2. moe_gmm_down: out[e, c, d] = act @ Wd, rounded once.
// The activation thus goes through device memory, where the TPU keeps it
// on chip: E * C * F * 4 bytes written and read back, 1.5 MB at decode,
// 0.12 % of the weights' bytes, for a grid that fills the card.
// A block owns kCols columns of its pass's output for R capacity rows,
// staged in shared memory as f32 (h in pass 1, act in pass 2, kChunk =
// 2048 rows of the summed dimension at a time, so any D and F fit).
// kLanesX = 16 lanes read one 256-byte segment of a weight row with
// 16-byte loads (8 bf16 or 4 f32 each: kCols 128 bf16, 64 f32), so a
// warp reads 2 rows at once.  In pass 1 warps 0-3 read Wg and warps 4-7
// Wu, so a lane holds one R x V tile of sums (32 or 64 registers, not
// twice that); the summed dimension (D in pass 1, F in pass 2) is cut
// into interleaved slices, one a column group (8 slices of D for each of
// Wg and Wu, 16 of F), slice s holding rows s, s + 8 (or 16), ...  Each
// lane issues the loads of kUnroll = 8 rows of its slice (128 bytes)
// before it uses them, streaming past L1 with a 256-byte L2 fetch, and
// sums its slice in order with fmaf.  The 2 slices of a warp are added
// by one shuffle, the warps' sums through shared memory in warp order.
// No atomics: the same inputs give the same bits.
// Rows a block: R = 4 at decode (C 4), and wherever 8 would pad C to more
// rows; else 8, so that each weight load feeds twice the rows (kernel.
// plan picks).  C > R runs ceil(C / R) row tiles, each reading the
// weights again (mostly from the 50 MB L2: the row tiles of one column
// tile are neighbours in the grid).
// Tile sizes at qwen3 decode (bf16, C 4): pass 1 is 6 x 128 = 768 blocks
// of 256 threads reading 1 MB each, pass 2 16 x 128 = 2,048 blocks
// reading 192 KB each; 32 KB and 16 KB of shared memory.  Registers
// (ptxas, sm_90a, the 16-byte-load instantiations): gate_up 95 bf16 / 80
// f32 at R = 4, 120 / 102 at R = 8; down 95 / 78 and 118 / 100; no spill
// (the scalar ones spill up to 232 bytes at R = 8).  Two blocks an SM
// (__launch_bounds__(256, 2)), 16 warps.
// Measured slower on the H100 and not kept: 8 lanes across a row; a
// third block an SM (it spills); 8 rows a block with 8-byte loads.
// Shapes whose weight rows are not a whole number of 16-byte loads (F or
// D not a multiple of V), or weights not on 16 bytes, take the scalar
// instantiation (VEC false): the same loop with V guarded scalar loads.
// Rounding: fmaf explicitly (the library is built with -fmad=false), silu
// as g / (1 + exp(-g)), gelu as 0.5 g (1 + tanh(sqrt(2 / pi) (g + 0.044715
// g^3))), relu as max(g, 0), in IEEE f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLanesX = 16;                // lanes across one weight row
constexpr int kGroups = 32 / kLanesX;      // rows a warp reads at once
constexpr int kSlices = kWarps * kGroups;  // slices of F in pass 2
constexpr int kUnroll = 8;                 // weight rows in flight a lane
constexpr int kChunk = 2048;               // rows of h or act staged at once
constexpr size_t kDefaultSmem = 48 * 1024;

// The gate's activation (kernel.ACTS): a template argument of pass 1.
enum Act { kSilu = 0, kGelu = 1, kRelu = 2 };

template <int ACT>
__device__ __forceinline__ float activate(float g) {
  if constexpr (ACT == kSilu) {
    return g / (1.f + expf(-g));
  } else if constexpr (ACT == kGelu) {
    constexpr float kC = 0.7978845608028654f;   // sqrt(2 / pi)
    return 0.5f * g * (1.f + tanhf(kC * (g + 0.044715f * (g * g * g))));
  } else {
    return g > 0.f ? g : 0.f;
  }
}

template <typename T>
struct Pack {
  static constexpr int V = 16 / sizeof(T);    // elements in a 16-byte load
  static constexpr int kCols = kLanesX * V;   // columns a block owns
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ void unpack(const uint4& q, float (&x)[4]) {
  x[0] = __uint_as_float(q.x);
  x[1] = __uint_as_float(q.y);
  x[2] = __uint_as_float(q.z);
  x[3] = __uint_as_float(q.w);
}
__device__ __forceinline__ void unpack(const uint4& q, float (&x)[8]) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // element 2i: the low half of word i
    x[2 * i] = __uint_as_float(w[i] << 16);
    x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// V consecutive elements of a weight row from p as f32: one 16-byte load
// (VEC), or n guarded scalar loads with zeros past them.  The vector load
// streams: read-only, not kept in L1, and it asks L2 to fetch the whole
// 256-byte line pair the row's segment lies in.
template <typename T, bool VEC>
__device__ __forceinline__ void load_row(const T* p, int n,
                                         float (&x)[Pack<T>::V]) {
  if constexpr (VEC) {
    uint4 q;
    asm("ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, "
        "[%4];"
        : "=r"(q.x), "=r"(q.y), "=r"(q.z), "=r"(q.w)
        : "l"(p));
    unpack(q, x);
  } else {
#pragma unroll
    for (int v = 0; v < Pack<T>::V; ++v) x[v] = v < n ? to_f32(p[v]) : 0.f;
  }
}

// Columns k0 .. k0 + kn - 1 of R rows of a row-major matrix with `ld`
// columns (rows from `rows` on are zero), as f32 in dst[k * R + r].
template <int R, typename S>
__device__ __forceinline__ void stage(float* dst, const S* src, int rows,
                                      int ld, int k0, int kn) {
  for (int i = threadIdx.x; i < R * kn; i += kThreads) {
    const int r = i / kn, k = i - r * kn;
    dst[k * R + r] =
        r < rows ? to_f32(src[static_cast<size_t>(r) * ld + k0 + k]) : 0.f;
  }
}

// The R staged values of one row k of the summed dimension.
template <int R>
__device__ __forceinline__ void staged(const float* src, int k,
                                       float (&x)[R]) {
  const float4* p = reinterpret_cast<const float4*>(src + k * R);
#pragma unroll
  for (int i = 0; i < R / 4; ++i) {
    const float4 q = p[i];
    x[4 * i] = q.x;
    x[4 * i + 1] = q.y;
    x[4 * i + 2] = q.z;
    x[4 * i + 3] = q.w;
  }
}

// Adds the kGroups slices of a warp pairwise ((0 + 1) + (2 + 3) ...):
// every lane of a column group ends with the same sums.
template <int R, int V>
__device__ __forceinline__ void warp_sum(float (&x)[R][V]) {
#pragma unroll
  for (int m = kLanesX; m < 32; m *= 2)
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v)
        x[r][v] += __shfl_xor_sync(0xffffffffu, x[r][v], m);
}

// Adds rows k = s, s + S, s + 2S, ... (k < kn) of the staged chunk times
// the same rows of a weight matrix (rows of `ld` elements, the chunk
// starting at row k0) into acc, in order, with the loads of U rows in
// flight at once.
template <typename T, int R, bool VEC, int S, int U>
__device__ __forceinline__ void accumulate(float (&acc)[R][Pack<T>::V],
                                           const T* w, int ld,
                                           const float* rows_f32, int s,
                                           int k0, int kn, int n) {
  constexpr int V = Pack<T>::V;
  int k = s;
  for (; k + (U - 1) * S < kn; k += U * S) {
    float a[U][V];
#pragma unroll
    for (int j = 0; j < U; ++j)
      load_row<T, VEC>(w + static_cast<size_t>(k0 + k + j * S) * ld, n,
                       a[j]);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      float x[R];
      staged<R>(rows_f32, k + j * S, x);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int v = 0; v < V; ++v)
          acc[r][v] = fmaf(x[r], a[j][v], acc[r][v]);
    }
  }
  for (; k < kn; k += S) {
    float a[V], x[R];
    load_row<T, VEC>(w + static_cast<size_t>(k0 + k) * ld, n, a);
    staged<R>(rows_f32, k, x);
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[r][v] = fmaf(x[r], a[v], acc[r][v]);
  }
}

// Each lane's sums, added over its warp, into red[warp][R][kCols]: row r
// from the lanes of column group r % kGroups.
template <int R, int V, int kCols>
__device__ __forceinline__ void to_shared(float* red, float (&acc)[R][V],
                                          int warp, int grp, int col) {
  warp_sum(acc);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r % kGroups != grp) continue;
#pragma unroll
    for (int v = 0; v < V; ++v)
      red[(warp * R + r) * kCols + col + v] = acc[r][v];
  }
}

template <typename T, int R, bool VEC, int ACT>
__global__ void __launch_bounds__(kThreads, 2)
moe_gmm_gate_up(const T* __restrict__ h, const T* __restrict__ wg,
                const T* __restrict__ wu, float* __restrict__ act, int C,
                int D, int F, int row_tiles) {
  constexpr int V = Pack<T>::V, kCols = Pack<T>::kCols;
  constexpr int kHalf = kWarps / 2;       // warps on each of Wg and Wu
  constexpr int S = kHalf * kGroups;      // slices of D in each
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int e = blockIdx.y;
  const int c0 = static_cast<int>(blockIdx.x % row_tiles) * R;
  const int f0 = static_cast<int>(blockIdx.x / row_tiles) * kCols;
  const int rows = min(R, C - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / kLanesX, col = (lane % kLanesX) * V;
  const int s = (warp % kHalf) * kGroups + grp;  // this lane's slice of D
  const int n = F - f0 - col;            // columns from this lane's first
  const T* hb = h + (static_cast<size_t>(e) * C + c0) * D;
  const T* wb = (warp < kHalf ? wg : wu) + static_cast<size_t>(e) * D * F +
                f0 + col;

  float acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
  for (int k0 = 0; k0 < D; k0 += kChunk) {
    const int kn = min(kChunk, D - k0);
    __syncthreads();  // the last chunk's reads are done
    stage<R>(smem, hb, rows, D, k0, kn);
    __syncthreads();
    if (n > 0)
      accumulate<T, R, VEC, S, kUnroll>(acc, wb, F, smem, s, k0, kn, n);
  }
  __syncthreads();  // every warp is done with the staged h
  to_shared<R, V, kCols>(smem, acc, warp, grp, col);
  __syncthreads();
  for (int i = threadIdx.x; i < R * kCols; i += kThreads) {
    const int r = i / kCols, cc = i - r * kCols;
    if (r >= rows || f0 + cc >= F) continue;
    float g = 0.f, u = 0.f;
#pragma unroll
    for (int w = 0; w < kHalf; ++w) {
      g += smem[(w * R + r) * kCols + cc];
      u += smem[((kHalf + w) * R + r) * kCols + cc];
    }
    act[(static_cast<size_t>(e) * C + c0 + r) * F + f0 + cc] =
        activate<ACT>(g) * u;
  }
}

template <typename T, int R, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
moe_gmm_down(const float* __restrict__ act, const T* __restrict__ wd,
             T* __restrict__ out, int C, int D, int F, int row_tiles) {
  constexpr int V = Pack<T>::V, kCols = Pack<T>::kCols;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int e = blockIdx.y;
  const int c0 = static_cast<int>(blockIdx.x % row_tiles) * R;
  const int d0 = static_cast<int>(blockIdx.x / row_tiles) * kCols;
  const int rows = min(R, C - c0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int grp = lane / kLanesX, col = (lane % kLanesX) * V;
  const int s = warp * kGroups + grp;    // this lane's slice of F
  const int n = D - d0 - col;
  const float* ab = act + (static_cast<size_t>(e) * C + c0) * F;
  const T* wb = wd + static_cast<size_t>(e) * F * D + d0 + col;

  float acc[R][V];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[r][v] = 0.f;
  for (int k0 = 0; k0 < F; k0 += kChunk) {
    const int kn = min(kChunk, F - k0);
    __syncthreads();
    stage<R>(smem, ab, rows, F, k0, kn);
    __syncthreads();
    if (n > 0)
      accumulate<T, R, VEC, kSlices, kUnroll>(acc, wb, D, smem, s, k0, kn, n);
  }
  __syncthreads();
  to_shared<R, V, kCols>(smem, acc, warp, grp, col);
  __syncthreads();
  for (int i = threadIdx.x; i < R * kCols; i += kThreads) {
    const int r = i / kCols, cc = i - r * kCols;
    if (r >= rows || d0 + cc >= D) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += smem[(w * R + r) * kCols + cc];
    store(out + (static_cast<size_t>(e) * C + c0 + r) * D + d0 + cc, sum);
  }
}

template <typename K, typename... Args>
int launch_one(K kernel, dim3 grid, size_t smem, cudaStream_t st,
               Args... args) {
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Pass 1 with the activation `act` (an Act) and 16-byte loads if vec.
template <typename T, int R, int ACT>
int launch_gate_up(bool vec, dim3 grid, size_t smem, cudaStream_t st,
                   const T* h, const T* wg, const T* wu, float* act, int C,
                   int D, int F, int row_tiles) {
  return vec ? launch_one(moe_gmm_gate_up<T, R, true, ACT>, grid, smem, st,
                          h, wg, wu, act, C, D, F, row_tiles)
             : launch_one(moe_gmm_gate_up<T, R, false, ACT>, grid, smem, st,
                          h, wg, wu, act, C, D, F, row_tiles);
}

template <typename T, int R>
int launch(const void* h, const void* wg, const void* wu, const void* wd,
           float* act, void* out, int activation, bool vec_gate_up,
           bool vec_down, int E, int C, int D, int F, cudaStream_t st) {
  constexpr int V = Pack<T>::V, kCols = Pack<T>::kCols;
  constexpr uintptr_t kAlign = 16;
  const bool gu_ok = F % V == 0 &&
                     reinterpret_cast<uintptr_t>(wg) % kAlign == 0 &&
                     reinterpret_cast<uintptr_t>(wu) % kAlign == 0;
  const bool down_ok =
      D % V == 0 && reinterpret_cast<uintptr_t>(wd) % kAlign == 0;
  if ((vec_gate_up && !gu_ok) || (vec_down && !down_ok))
    return static_cast<int>(cudaErrorInvalidValue);
  const int row_tiles = (C + R - 1) / R;
  const size_t smem_gu = sizeof(float) *
      std::max(R * std::min(D, kChunk), kWarps * R * kCols);
  const size_t smem_down = sizeof(float) *
      std::max(R * std::min(F, kChunk), kWarps * R * kCols);
  const dim3 grid_gu(row_tiles * ((F + kCols - 1) / kCols), E);
  const dim3 grid_down(row_tiles * ((D + kCols - 1) / kCols), E);
  const T* ht = static_cast<const T*>(h);
  const T* gt = static_cast<const T*>(wg);
  const T* ut = static_cast<const T*>(wu);
  const T* dt = static_cast<const T*>(wd);
  const float* at = act;
  T* ot = static_cast<T*>(out);
  int err = static_cast<int>(cudaErrorInvalidValue);
  if (activation == kSilu)
    err = launch_gate_up<T, R, kSilu>(vec_gate_up, grid_gu, smem_gu, st, ht,
                                      gt, ut, act, C, D, F, row_tiles);
  else if (activation == kGelu)
    err = launch_gate_up<T, R, kGelu>(vec_gate_up, grid_gu, smem_gu, st, ht,
                                      gt, ut, act, C, D, F, row_tiles);
  else if (activation == kRelu)
    err = launch_gate_up<T, R, kRelu>(vec_gate_up, grid_gu, smem_gu, st, ht,
                                      gt, ut, act, C, D, F, row_tiles);
  if (err) return err;
  return vec_down
      ? launch_one(moe_gmm_down<T, R, true>, grid_down, smem_down, st, at,
                   dt, ot, C, D, F, row_tiles)
      : launch_one(moe_gmm_down<T, R, false>, grid_down, smem_down, st, at,
                   dt, ot, C, D, F, row_tiles);
}

template <typename T>
int launch_rows(int rows, const void* h, const void* wg, const void* wu,
                const void* wd, float* act, void* out, int activation,
                bool vec_gate_up, bool vec_down, int E, int C, int D, int F,
                cudaStream_t st) {
  if (rows == 4)
    return launch<T, 4>(h, wg, wu, wd, act, out, activation, vec_gate_up,
                        vec_down, E, C, D, F, st);
  if (rows == 8)
    return launch<T, 8>(h, wg, wu, wd, act, out, activation, vec_gate_up,
                        vec_down, E, C, D, F, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// out (E, C, D) = act(h @ Wg) * (h @ Wu) @ Wd per expert, all contiguous
// and of one type: dtype 0 is f32, 1 is bf16; activation 0 is silu, 1 gelu
// (tanh form), 2 relu.  act is f32 scratch of (E, C, F); rows (4 or 8) the
// capacity rows a block holds.  vec_gate_up /
// vec_down select 16-byte loads of Wg, Wu / Wd (weight rows a whole
// number of 16 bytes, the weights on 16 bytes).  Launches both passes on
// `stream`; returns the first non-zero cudaError_t (0 = success).
int moe_gmm_launch(const void* h, const void* wg, const void* wu,
                   const void* wd, void* act, void* out, int dtype,
                   int activation, int rows, int vec_gate_up, int vec_down,
                   int E, int C, int D, int F, void* stream) {
  if (E < 1 || E > 65535 || C < 1 || D < 1 || F < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* a = static_cast<float*>(act);
  if (dtype == 0)
    return launch_rows<float>(rows, h, wg, wu, wd, a, out, activation,
                              vec_gate_up, vec_down, E, C, D, F, st);
  if (dtype == 1)
    return launch_rows<__nv_bfloat16>(rows, h, wg, wu, wd, a, out,
                                      activation, vec_gate_up, vec_down, E,
                                      C, D, F, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

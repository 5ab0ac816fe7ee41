// Backward of the RG-LRU diagonal linear recurrence, for Hopper: the
// forward's chunked scan with a carry, walked from the end.
//
// Replaces no TPU kernel.  The JAX package trains through plain jnp
// (models/rglru.py:55, an associative scan) and differentiates it with
// jax.grad; the port's forward runs the hand-written rglru_scan.cu, which
// autograd cannot see into, so its gradient is a kernel too.  It computes
// what ref.rglru_scan_bwd_ref computes: for each batch row b and channel d,
// from the gradients dhs of every state h_t = a_t h_{t-1} + bx_t,
//     g_t  = dhs_t + a_{t+1} g_{t+1}          (g_{S-1} = dhs_{S-1})
//     da_t = g_t h_{t-1}   (h_{-1} = h0),   dbx_t = g_t,   dh0 = a_0 g_0
// in f32, da and dbx rounded once to a's type.  Written with the carried
// q_t = a_t g_t, one step from the end is
//     g = dhs_t + q;  da_t = g h_{t-1};  dbx_t = g;  q = a_t g
// and q obeys the forward's recurrence reversed: q_t = a_t q_{t+1} +
// a_t dhs_t.  The products round before the sums (-fmad=false), as the
// plain version's.
//
// Bound.  The function reads a, hs (the forward's saved states) and dhs
// once and writes da and dbx once: at recurrentgemma-2b's training shape
// (B 1, S 4096, D 2560, all f32) 20 B an element, 210 MB, 63 us at 3.35
// TB/s, against ~4 operations an element (0.6 us at 67 TFLOP/s): the
// bytes bound it.
//
// Design.  rglru_scan.cu's three passes, each walking its chunk from its
// last step to its first:
//   rglru_bwd_chunk_ends   each chunk's q out of it from a zero carry, e_c,
//                          and the product P_c of its a's, into an f32
//                          (B, nc, 2, D) scratch;
//   rglru_bwd_chunk_carry  one thread a (b, d) walks the chunks from the
//                          last, Q_c = P_c Q_{c+1} + e_c from Q = 0 past
//                          the end, and writes Q_c, the carry into chunk
//                          c - 1, over P_c (linear in S);
//   rglru_bwd_chunk_scan   walks its chunk from its carry as the plain
//                          version does, writing da and dbx; chunk 0's
//                          thread writes dh0 = q_0.
// Within a chunk the arithmetic is the plain version's, step for step;
// only the carry into a chunk is rounded another way.  Neighbouring
// threads hold neighbouring channels, so every access is coalesced.  No
// atomics and a fixed order: the same bits every run.  The design moves
// 28 B an element (a and dhs read twice).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;    // steps a chunk (the forward's)
constexpr int kAhead = 16;    // steps whose loads are in flight together

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// The unit of work of block (x, y): chunk c of batch row b, channel d.
struct Unit {
  int b, c, d, steps;
  size_t at;   // offset of (b, c * kChunk, d) in a (B, S, D) tensor
};

__device__ __forceinline__ Unit unit(int s_len, int dim, int groups) {
  Unit u;
  u.c = blockIdx.x / groups;
  u.d = (blockIdx.x - u.c * groups) * kThreads + threadIdx.x;
  u.b = blockIdx.y;
  u.steps = min(kChunk, s_len - u.c * kChunk);
  u.at = (static_cast<size_t>(u.b) * s_len + u.c * kChunk) * dim + u.d;
  return u;
}

// Pass 1: each chunk's q out of it from a zero carry, and the product of
// its a's, walking the chunk from its last step.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_chunk_ends(const T* __restrict__ a, const float* __restrict__ dhs,
                     float* __restrict__ ends, int s_len, int dim,
                     int groups) {
  const Unit u = unit(s_len, dim, groups);
  if (u.d >= dim) return;
  float p = 1.f, q = 0.f;
  for (int i0 = u.steps - 1; i0 >= 0; i0 -= kAhead) {
    T av[kAhead];
    float gv[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (i0 - i >= 0) {
        const size_t at = u.at + static_cast<size_t>(i0 - i) * dim;
        av[i] = a[at];
        gv[i] = dhs[at];
      }
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (i0 - i >= 0) {
        const float ai = to_f32(av[i]);
        q = ai * (gv[i] + q);
        p = p * ai;
      }
  }
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  float* pe = ends + (static_cast<size_t>(u.b) * n_chunks + u.c) * 2 * dim
              + u.d;
  pe[0] = p;
  pe[dim] = q;
}

// Pass 2: the carry into every chunk but the last, walking the chunks
// from the last: chunk c's carry is written over P_{c+1}.
__global__ void __launch_bounds__(kThreads)
rglru_bwd_chunk_carry(float* ends, int n_chunks, int dim) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= dim) return;
  const int b = blockIdx.y;
  float* pe = ends + static_cast<size_t>(b) * n_chunks * 2 * dim + d;
  // chunk c's carry in is Q_{c+1}, the q out of chunk c + 1
  float q = 0.f;
  for (int j0 = n_chunks - 1; j0 > 0; j0 -= kAhead) {
    float p[kAhead], e[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (j0 - i > 0) {
        p[i] = pe[static_cast<size_t>(2 * (j0 - i)) * dim];
        e[i] = pe[static_cast<size_t>(2 * (j0 - i) + 1) * dim];
      }
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (j0 - i > 0) {
        // the q out of chunk j = j0 - i, the carry into chunk j - 1,
        // written over P_j (read above; later groups read smaller j only)
        q = p[i] * q + e[i];
        pe[static_cast<size_t>(2 * (j0 - i)) * dim] = q;
      }
  }
}

// Pass 3: the chunk's walk from its carry: da, dbx, and dh0 from chunk 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_bwd_chunk_scan(const T* __restrict__ a, const float* __restrict__ hs,
                     const float* __restrict__ h0,
                     const float* __restrict__ dhs,
                     const float* __restrict__ ends, T* __restrict__ da,
                     T* __restrict__ dbx, float* __restrict__ dh0, int s_len,
                     int dim, int groups) {
  const Unit u = unit(s_len, dim, groups);
  if (u.d >= dim) return;
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  float q = u.c == n_chunks - 1
      ? 0.f
      : ends[(static_cast<size_t>(u.b) * n_chunks + u.c + 1) * 2 * dim
             + u.d];
  const float hinit = h0[static_cast<size_t>(u.b) * dim + u.d];
  for (int i0 = u.steps - 1; i0 >= 0; i0 -= kAhead) {
    T av[kAhead];
    float gv[kAhead], hv[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int t = i0 - i;
      if (t >= 0) {
        const size_t at = u.at + static_cast<size_t>(t) * dim;
        av[i] = a[at];
        gv[i] = dhs[at];
        // h_{t-1}: the state before step t, h0 before the sequence
        const bool first = u.c == 0 && t == 0;
        hv[i] = first ? hinit : hs[first ? at : at - dim];
      }
    }
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int t = i0 - i;
      if (t >= 0) {
        const size_t at = u.at + static_cast<size_t>(t) * dim;
        const float g = gv[i] + q;
        store(da + at, g * hv[i]);
        store(dbx + at, g);
        q = to_f32(av[i]) * g;
      }
    }
  }
  if (u.c == 0) dh0[static_cast<size_t>(u.b) * dim + u.d] = q;
}

template <typename T>
int launch(const void* a, const float* hs, const float* h0, const float* dhs,
           float* ends, void* da, void* dbx, float* dh0, int bsz, int s_len,
           int dim, cudaStream_t st) {
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  const int groups = (dim + kThreads - 1) / kThreads;
  if (static_cast<long long>(groups) * n_chunks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(groups * n_chunks, bsz);
  const T* at = static_cast<const T*>(a);
  if (n_chunks > 1) {
    rglru_bwd_chunk_ends<T><<<grid, kThreads, 0, st>>>(at, dhs, ends, s_len,
                                                       dim, groups);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    rglru_bwd_chunk_carry<<<dim3(groups, bsz), kThreads, 0, st>>>(
        ends, n_chunks, dim);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rglru_bwd_chunk_scan<T><<<grid, kThreads, 0, st>>>(
      at, hs, h0, dhs, ends, static_cast<T*>(da), static_cast<T*>(dbx), dh0,
      s_len, dim, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of the scratch that rglru_scan_bwd_launch needs: (B, nc, 2, D),
// nc = ceil(S / kChunk).
long long rglru_scan_bwd_scratch_floats(int bsz, int s_len, int dim) {
  return static_cast<long long>(bsz) * ((s_len + kChunk - 1) / kChunk) * 2
         * dim;
}

// da, dbx (B, S, D) in a's type and dh0 (B, D) f32 from a (B, S, D), the
// forward's states hs (B, S, D) f32, h0 (B, D) f32 and the states'
// gradient dhs (B, S, D) f32, all contiguous; dtype (a's, da's and
// dbx's) 0 is f32, 1 bf16.  `ends` is f32 scratch of
// rglru_scan_bwd_scratch_floats elements.  Launches on `stream`; returns
// the cudaError_t of the launches (0 = success).
int rglru_scan_bwd_launch(const void* a, const void* hs, const void* h0,
                          const void* dhs, void* ends, void* da, void* dbx,
                          void* dh0, int dtype, int bsz, int s_len, int dim,
                          void* stream) {
  if (bsz < 1 || bsz > 65535 || s_len < 1 || dim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* hf = static_cast<const float*>(hs);
  const float* h0f = static_cast<const float*>(h0);
  const float* gf = static_cast<const float*>(dhs);
  float* ef = static_cast<float*>(ends);
  float* d0 = static_cast<float*>(dh0);
  if (dtype == 0)
    return launch<float>(a, hf, h0f, gf, ef, da, dbx, d0, bsz, s_len, dim,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, hf, h0f, gf, ef, da, dbx, d0, bsz, s_len,
                                 dim, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

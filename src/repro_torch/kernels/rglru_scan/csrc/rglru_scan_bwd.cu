// Backward of the RG-LRU diagonal linear recurrence, for Hopper: one pass
// over the forward's chunks, each walked from its end, the chunks handing
// their carries to each other by a look-back.
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
// Design.  A tile is a chunk of kChunk steps of kThreads channels of one
// batch row; a block takes one, a thread a channel.  The kernel reads a,
// dhs and hs once and writes da, dbx and dh0 once:
//   1. The block takes its tile from a ticket (an atomic counter), every
//      column's (batch row's, channel group's) last chunk first, then the
//      one before it: the tiles a block waits on were handed out before
//      its own, to blocks already running, so the waits end whatever
//      order the hardware starts blocks in.  The ticket orders work and
//      touches no value: the result is the same bits every run.
//   2. The tile's a, dhs and hs are staged in shared memory by 16-byte
//      cp.async copies (element loads where D is not a multiple of 8);
//      hs is waited for only in walk 2.
//   3. Walk 1, from the tile's last step with a zero carry: the chunk's
//      q out of it, e_c, and the product P_c of its a's.  Published
//      (f32 scratch, then a fence, then the tile's status word with
//      release semantics) as AGGREGATE.
//   4. Look-back: one warp reads the status words of chunks c + 1, c + 2,
//      ... 32 at a time (acquire loads) until the nearest INCLUSIVE one,
//      whose carry Q_j it takes; the aggregates passed over are folded in
//      from the farthest to the nearest, q = P_j q + e_j, which are the
//      operations of a carry pass walking the chunks from the last, in its
//      order.  The tile's own Q_c = P_c Q_{c+1} + e_c is published as
//      INCLUSIVE (the last chunk's is P 0 + e).  Published values are
//      read through L2 (__ldcg).
//   5. Walk 2, from Q_{c+1} (zero for the last chunk): the chunk as the
//      plain version walks it, writing da and dbx; chunk 0 writes dh0.
// Within a chunk the arithmetic is the plain version's, step for step;
// only the carry into a chunk is rounded another way, the same way at
// every run (ref.rglru_scan_bwd_chunked_ref repeats it in plain torch,
// bit for bit).  Chunk 0 publishes nothing and the last chunk no
// aggregate.  The status words and the ticket are zeroed by one
// cudaMemsetAsync on the caller's stream before the kernel.
//
// Tiling.  32 steps of 128 channels: a, dhs and hs staged take 48 KB at
// f32, so four blocks share an SM.  The design moves the function's bytes
// and 16 B a chunk and channel (P, e and Q written, Q read again).  At
// recurrentgemma-2b's training shape on an H100 (PERF.md §6) it takes
// 0.092 ms, 68 % of the bound, against 0.150 for the three passes it
// replaces.  Timed side by side, this tiling took 0.103 ms, 64 steps of
// 64 channels 0.105, and 64 steps of 128 channels with hs read into
// registers in walk 2 (a and dhs alone staged, 64 KB, three blocks an
// SM) 0.184.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 32;      // steps a tile
constexpr int kThreads = 128;   // channels a tile, one a thread

// A tile's status word: nothing yet, its aggregate (P_c, e_c), its
// inclusive carry Q_c.
constexpr int kPending = 0;
constexpr int kAggregate = 1;
constexpr int kInclusive = 2;
// SM clocks a look-back may wait (~5 s) before the kernel traps: only a
// broken hand-out order could make it wait that long.
constexpr long long kSpinLimit = 10000000000LL;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kLeft>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kLeft) : "memory");
}

// `rows` rows of the tile's channels d0 .. d0 + kThreads - 1, row r at
// src + r * dim, into dst[r][0 .. kThreads): 16-byte copies where `vec`
// (dim a multiple of 8, the tensors 16-byte aligned), else each thread
// loads its own channel.
template <typename E>
__device__ __forceinline__ void stage(E* dst, const E* src, int rows,
                                      int dim, int d0, bool vec) {
  if (vec) {
    constexpr int kPer = 16 / sizeof(E);      // elements a copy
    constexpr int kRow = kThreads / kPer;     // copies a row
    for (int i = threadIdx.x; i < rows * kRow; i += kThreads) {
      const int r = i / kRow, k = (i - r * kRow) * kPer;
      if (d0 + k < dim)
        cp_async16(dst + r * kThreads + k,
                   src + static_cast<size_t>(r) * dim + d0 + k);
    }
  } else if (d0 + static_cast<int>(threadIdx.x) < dim) {
#pragma unroll 8
    for (int r = 0; r < rows; ++r)
      dst[r * kThreads + threadIdx.x] =
          src[static_cast<size_t>(r) * dim + d0 + threadIdx.x];
  }
}

// Every thread's published values visible on the device, then the status.
__device__ __forceinline__ void publish(int* status, int v) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) store_release(status, v);
}

// The scratch: the ticket and one status word a tile (ints, zeroed before
// each launch), then (P_c, e_c) a chunk and channel, then Q_c.
struct Scratch {
  long long flags;      // ints, a multiple of 4
  long long pe, carry;  // float offsets of the two value arrays
  long long floats;     // floats in all
};

Scratch layout(int bsz, int s_len, int dim) {
  const long long nc = (s_len + kChunk - 1) / kChunk;
  const long long groups = (dim + kThreads - 1) / kThreads;
  Scratch s;
  s.flags = (1 + bsz * groups * nc + 3) / 4 * 4;
  s.pe = s.flags;
  s.carry = s.pe + bsz * nc * 2 * dim;
  s.floats = s.carry + bsz * nc * dim;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_bwd(const T* __restrict__ a, const float* __restrict__ hs,
          const float* __restrict__ h0, const float* __restrict__ dhs,
          int* flags, float* pe, float* carry, T* __restrict__ da,
          T* __restrict__ dbx, float* __restrict__ dh0, int s_len, int dim,
          int groups, int n_chunks, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_a = reinterpret_cast<T*>(smem);
  float* s_g = reinterpret_cast<float*>(smem + kChunk * kThreads * sizeof(T));
  float* s_h = s_g + kChunk * kThreads;   // h_{t-1} of each step
  __shared__ int s_ticket, s_stop;

  if (threadIdx.x == 0) s_ticket = atomicAdd(flags, 1);
  __syncthreads();
  const int cols = gridDim.x / n_chunks;
  const int level = s_ticket / cols;
  const int col = s_ticket - level * cols;          // b * groups + group
  const int c = n_chunks - 1 - level;
  const int b = col / groups;
  const int d0 = (col - b * groups) * kThreads;
  const int d = d0 + threadIdx.x;
  const bool live = d < dim;
  const int steps = min(kChunk, s_len - c * kChunk);
  const size_t row0 = static_cast<size_t>(b) * s_len + c * kChunk;
  int* status = flags + 1 + static_cast<size_t>(col) * n_chunks;
  // chunk j's values of channel d: P_j at pe[2 cell(j) + d], e_j D
  // further, Q_j at carry[cell(j) + d]
  const auto cell = [&](int j) {
    return (static_cast<size_t>(b) * n_chunks + j) * dim;
  };

  stage(s_a, a + row0 * dim, steps, dim, d0, vec);
  stage(s_g, dhs + row0 * dim, steps, dim, d0, vec);
  cp_async_commit();
  // hs rows c * kChunk - 1 ..., waited for in walk 2; h0 stands before
  // row 0
  const int skip = c == 0;
  stage(s_h + skip * kThreads, hs + (row0 + skip - 1) * dim, steps - skip,
        dim, d0, vec);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // walk 1: the chunk's q out of it from a zero carry, and its a's product
  float p = 1.f, e = 0.f;
  if (c > 0) {
    for (int i = steps - 1; i >= 0; --i) {
      const float ai = to_f32(s_a[i * kThreads + threadIdx.x]);
      e = ai * (s_g[i * kThreads + threadIdx.x] + e);
      p = p * ai;
    }
    if (c < n_chunks - 1) {
      if (live) {
        float* own = pe + 2 * cell(c) + d;
        own[0] = p;
        own[dim] = e;
      }
      publish(status + c, kAggregate);
    }
  }

  // look-back: the carry into this chunk, Q_{c+1}
  float q = 0.f;
  if (c < n_chunks - 1) {
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const long long t0 = clock64();
      for (int base = c + 1;;) {
        const int j = base + lane;
        const int st = j < n_chunks ? load_acquire(status + j) : kPending;
        const unsigned inc = __ballot_sync(~0u, st == kInclusive);
        const unsigned pending = __ballot_sync(~0u, st == kPending);
        // the lanes nearer than the nearest INCLUSIVE one
        const unsigned nearer = inc ? (inc & (0u - inc)) - 1 : ~0u;
        if (!(pending & nearer)) {
          if (inc) {
            if (lane == 0) s_stop = base + __ffs(inc) - 1;
            break;
          }
          base += 32;
          continue;
        }
        if (clock64() - t0 > kSpinLimit) __trap();
        __nanosleep(32);
      }
    }
    __syncthreads();
    const int stop = s_stop;
    if (live) {
      q = __ldcg(carry + cell(stop) + d);
#pragma unroll 4
      for (int j = stop - 1; j > c; --j) {
        const float* pj = pe + 2 * cell(j) + d;
        q = __ldcg(pj) * q + __ldcg(pj + dim);
      }
    }
  }
  if (c > 0) {
    if (live) carry[cell(c) + d] = p * q + e;
    publish(status + c, kInclusive);
  }

  // walk 2: the chunk from its carry, da and dbx; dh0 from chunk 0
  cp_async_wait<0>();
  __syncthreads();
  if (!live) return;
  const float hinit = h0[static_cast<size_t>(b) * dim + d];
  const size_t at = row0 * dim + d;
#pragma unroll 8
  for (int i = steps - 1; i >= 0; --i) {
    const int k = i * kThreads + threadIdx.x;
    const float hprev = c == 0 && i == 0 ? hinit : s_h[k];
    const float g = s_g[k] + q;
    store(da + at + static_cast<size_t>(i) * dim, g * hprev);
    store(dbx + at + static_cast<size_t>(i) * dim, g);
    q = to_f32(s_a[k]) * g;
  }
  if (c == 0) dh0[static_cast<size_t>(b) * dim + d] = q;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
int launch(const void* a, const float* hs, const float* h0, const float* dhs,
           float* scratch, void* da, void* dbx, float* dh0, int bsz,
           int s_len, int dim, cudaStream_t st) {
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  const int groups = (dim + kThreads - 1) / kThreads;
  const long long tiles = static_cast<long long>(bsz) * groups * n_chunks;
  if (tiles > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const Scratch sc = layout(bsz, s_len, dim);
  cudaError_t err = cudaMemsetAsync(scratch, 0, sc.flags * sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = kChunk * kThreads * (sizeof(T) + 2 * sizeof(float));
  err = cudaFuncSetAttribute(rglru_bwd<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = dim % 8 == 0 && aligned16(a) && aligned16(hs)
                   && aligned16(dhs);
  rglru_bwd<T><<<static_cast<unsigned>(tiles), kThreads, smem, st>>>(
      static_cast<const T*>(a), hs, h0, dhs, reinterpret_cast<int*>(scratch),
      scratch + sc.pe, scratch + sc.carry, static_cast<T*>(da),
      static_cast<T*>(dbx), dh0, s_len, dim, groups, n_chunks, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of the scratch that rglru_scan_bwd_launch needs: the ticket and
// a status word a tile (ints), then (B, nc, 2, D) and (B, nc, D) f32,
// nc = ceil(S / kChunk).
long long rglru_scan_bwd_scratch_floats(int bsz, int s_len, int dim) {
  return layout(bsz, s_len, dim).floats;
}

// The tiling, into tiling[2]: the steps of a chunk and the channels of a
// tile.
void rglru_scan_bwd_tiling(int* tiling) {
  tiling[0] = kChunk;
  tiling[1] = kThreads;
}

// da, dbx (B, S, D) in a's type and dh0 (B, D) f32 from a (B, S, D), the
// forward's states hs (B, S, D) f32, h0 (B, D) f32 and the states'
// gradient dhs (B, S, D) f32, all contiguous; dtype (a's, da's and
// dbx's) 0 is f32, 1 bf16.  `scratch` is f32 scratch of
// rglru_scan_bwd_scratch_floats elements, its head zeroed here.
// Launches on `stream`; returns the cudaError_t of the memset and the
// launch (0 = success).
int rglru_scan_bwd_launch(const void* a, const void* hs, const void* h0,
                          const void* dhs, void* scratch, void* da, void* dbx,
                          void* dh0, int dtype, int bsz, int s_len, int dim,
                          void* stream) {
  if (bsz < 1 || s_len < 1 || dim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* hf = static_cast<const float*>(hs);
  const float* h0f = static_cast<const float*>(h0);
  const float* gf = static_cast<const float*>(dhs);
  float* sf = static_cast<float*>(scratch);
  float* d0 = static_cast<float*>(dh0);
  if (dtype == 0)
    return launch<float>(a, hf, h0f, gf, sf, da, dbx, d0, bsz, s_len, dim,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, hf, h0f, gf, sf, da, dbx, d0, bsz, s_len,
                                 dim, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

// RG-LRU diagonal linear recurrence, for Hopper: a chunked scan with a
// carry across chunks.
//
// Replaces the TPU kernel repro/kernels/rglru_scan/kernel.py::_kernel
// (launched by rglru_scan_fwd) and computes what ref.rglru_scan_ref
// computes: for each batch row b and channel d, from h = h0[b, d],
//     h_t = a_t * h_{t-1} + bx_t,   out[b, t, d] = h_t
// in f32 (the product rounded before the sum: -fmad=false, as the plain
// version does it), every h_t written.
//
// Bound.  The function reads a and bx once and writes every h_t once: at
// recurrentgemma-2b's longest prefill (B 1, S 3300, D 2560, a and bx f32)
// 12 B an element, ~101 MB, 30 us at 3.35 TB/s, against two operations
// an element, 0.25 us at 67 TFLOP/s: the bytes bound it.
//
// Design.  The TPU kernel walks S in chunks with the state carried in
// VMEM scratch across sequential grid steps.  One thread a channel
// walking all of S fills 40 of the card's 132 SMs at B 1 (D 2560), and
// keeps too few loads in flight to reach the memory's rate.  Here S is
// cut into chunks of kChunk steps and each (b, chunk, channel) is one
// thread: 52 x 2,560 threads at S 3300.  Neighbouring threads hold
// neighbouring channels, so every access is coalesced.  Three kernels,
// launched by one call:
//   rglru_chunk_ends   scans each chunk from a zero state: its end state
//                      e_c and the product P_c of its a's, into an f32
//                      (B, nc, 2, D) scratch that the wrapper allocates;
//   rglru_chunk_carry  one thread a (b, d) walks the chunks in order from
//                      h0, H_c = P_c * H_{c-1} + e_c, and writes H_c over
//                      e_c: nc - 1 steps in all, linear in S (folding
//                      them again in every chunk's thread would read
//                      ~nc^2 / 2 carries);
//   rglru_chunk_scan   scans its chunk from the carry H_{c-1} (h0 for
//                      the first) as the plain version does, writing
//                      every h_t.
// Within a chunk the arithmetic is the plain version's, step for step;
// only the carry into a chunk is rounded another way.  No atomics and a
// fixed order: the result is the same bits every run.  S within one
// chunk runs the last kernel alone, from h0.
//
// The design moves 20 B an element (a and bx read twice), a 0.050 ms
// floor at S 3300, and the two chunk passes take about equal time there.
// Walking the last pass's chunks in the reverse of the first's order, so
// that the chunks read last would be read again first from the 50 MB L2,
// measured no faster on the H100 (every chunk is in flight at once);
// chunks of 32 steps, and 16-byte accesses of four channels a thread,
// measured within 3 % (PERF.md §6).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 64;    // steps a chunk
constexpr int kAhead = 16;    // steps whose loads are in flight together

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The unit of work of block (x, y): chunk c of batch row b, channel d.
// `groups` blocks cover D.
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

// Pass 1: each chunk's end state from zero and the product of its a's.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_chunk_ends(const T* __restrict__ a, const T* __restrict__ bx,
                 float* __restrict__ ends, int s_len, int dim, int groups) {
  const Unit u = unit(s_len, dim, groups);
  if (u.d >= dim) return;
  float p = 1.f, e = 0.f;
  for (int i0 = 0; i0 < u.steps; i0 += kAhead) {
    T av[kAhead], bv[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (i0 + i < u.steps) {
        const size_t at = u.at + static_cast<size_t>(i0 + i) * dim;
        av[i] = a[at];
        bv[i] = bx[at];
      }
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (i0 + i < u.steps) {
        const float ai = to_f32(av[i]);
        e = ai * e + to_f32(bv[i]);
        p = p * ai;
      }
  }
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  float* pe = ends + (static_cast<size_t>(u.b) * n_chunks + u.c) * 2 * dim
              + u.d;
  pe[0] = p;
  pe[dim] = e;
}

// Pass 2: the carry out of every chunk but the last, in chunk order from
// h0, written over the chunk's end state.
__global__ void __launch_bounds__(kThreads)
rglru_chunk_carry(const float* __restrict__ h0, float* ends, int n_chunks,
                  int dim) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= dim) return;
  const int b = blockIdx.y;
  float h = h0[static_cast<size_t>(b) * dim + d];
  float* pe = ends + static_cast<size_t>(b) * n_chunks * 2 * dim + d;
  const int last = n_chunks - 1;
  for (int j0 = 0; j0 < last; j0 += kAhead) {
    float p[kAhead], e[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (j0 + i < last) {
        p[i] = pe[static_cast<size_t>(2 * (j0 + i)) * dim];
        e[i] = pe[static_cast<size_t>(2 * (j0 + i) + 1) * dim];
      }
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (j0 + i < last) {
        h = p[i] * h + e[i];
        pe[static_cast<size_t>(2 * (j0 + i) + 1) * dim] = h;
      }
  }
}

// Pass 3: the chunk's scan from its carry, every h_t.
template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_chunk_scan(const T* __restrict__ a, const T* __restrict__ bx,
                 const float* __restrict__ h0,
                 const float* __restrict__ ends, float* __restrict__ out,
                 int s_len, int dim, int groups) {
  const Unit u = unit(s_len, dim, groups);
  if (u.d >= dim) return;
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  float h = u.c == 0
      ? h0[static_cast<size_t>(u.b) * dim + u.d]
      : ends[(static_cast<size_t>(u.b) * n_chunks + u.c - 1) * 2 * dim
             + dim + u.d];
  for (int i0 = 0; i0 < u.steps; i0 += kAhead) {
    T av[kAhead], bv[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (i0 + i < u.steps) {
        const size_t at = u.at + static_cast<size_t>(i0 + i) * dim;
        av[i] = a[at];
        bv[i] = bx[at];
      }
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      if (i0 + i < u.steps) {
        h = to_f32(av[i]) * h + to_f32(bv[i]);
        out[u.at + static_cast<size_t>(i0 + i) * dim] = h;
      }
  }
}

template <typename T>
int launch(const void* a, const void* bx, const float* h0, float* ends,
           float* out, int bsz, int s_len, int dim, cudaStream_t st) {
  const int n_chunks = (s_len + kChunk - 1) / kChunk;
  const int groups = (dim + kThreads - 1) / kThreads;
  if (static_cast<long long>(groups) * n_chunks > 0x7fffffff)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(groups * n_chunks, bsz);
  const T* at = static_cast<const T*>(a);
  const T* bt = static_cast<const T*>(bx);
  if (n_chunks > 1) {
    rglru_chunk_ends<T><<<grid, kThreads, 0, st>>>(at, bt, ends, s_len, dim,
                                                   groups);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    rglru_chunk_carry<<<dim3(groups, bsz), kThreads, 0, st>>>(h0, ends,
                                                             n_chunks, dim);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  rglru_chunk_scan<T><<<grid, kThreads, 0, st>>>(at, bt, h0, ends, out,
                                                 s_len, dim, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Floats of the scratch that rglru_scan_launch needs: (B, nc, 2, D),
// nc = ceil(S / kChunk).
long long rglru_scan_scratch_floats(int bsz, int s_len, int dim) {
  return static_cast<long long>(bsz) * ((s_len + kChunk - 1) / kChunk) * 2
         * dim;
}

// out (B, S, D) f32: every state of h_t = a_t * h_{t-1} + bx_t from
// h0 (B, D) f32; a and bx (B, S, D) contiguous, of one type: dtype 0 is
// f32, 1 is bf16.  `ends` is f32 scratch of rglru_scan_scratch_floats
// elements.  Launches on `stream`; returns the cudaError_t of the
// launches (0 = success).
int rglru_scan_launch(const void* a, const void* bx, const void* h0,
                      void* ends, void* out, int dtype, int bsz, int s_len,
                      int dim, void* stream) {
  if (bsz < 1 || bsz > 65535 || s_len < 1 || dim < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* hf = static_cast<const float*>(h0);
  float* ef = static_cast<float*>(ends);
  float* of = static_cast<float*>(out);
  if (dtype == 0)
    return launch<float>(a, bx, hf, ef, of, bsz, s_len, dim, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(a, bx, hf, ef, of, bsz, s_len, dim, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"

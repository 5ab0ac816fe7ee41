// One permutation-sparse Opera slice over a scenario batch, for Hopper.
//
// Replaces the TPU kernel repro/kernels/rotor_slice/kernel.py::_kernel
// (launched by rotor_slice_fwd) and computes what ref.rotor_slice_ref
// computes:
//   * direct sends min(own, 1) on the live circuits of the slice,
//   * relay forwarding into the room left on each circuit,
//   * with vlb, a VLB spread of the bytes that have no live circuit,
//     in proportion to the room each partner has left,
// and returns the new own/relay state with the per-scenario delivered
// and VLB-moved totals.  The TPU form's select trees exist because XLA
// serializes scatters; here each row writes its own u edge entries at
// own[b, i, dst[i, s]] directly.
//
// Inputs: own, relay (B, N, N) f32; dst (N, u) int32, sentinel N for a
// dark slot (switch reconfiguring, or a self-loop inside a live
// matching, so partly dark columns are normal).  Slots are disjoint: a
// column j of row i is served by at most one slot.
//
// Bound.  The step must read own and relay once and write both once:
// 16 * B * N^2 bytes.  At k64-n1024-g4 with B = 16 that is 268 MB, about
// 80 us at 3.35 TB/s; the arithmetic (a few flops per element, plus
// u per element for the VLB gather) is far below the card's rate, so
// the step is bound by bytes.  The design keeps to one pass over each
// state tensor in device memory:
//   pass A (one block per (b, i) row) reads own[b, i, :] into shared
//     memory once, gathers its u edges, reduces the row's eligible
//     backlog q_i and room r_i, writes own_out[b, i, :] and, only where
//     frac_i != 0, the row's take = elig * frac_i into a (B, N, N)
//     scratch;
//   pass B (one block per (b, j) row) reads relay[b, j, :] once, applies
//     the row's own relay sends, and adds sum_s w[j, s] * take[dst[j, s]]
//     (the involution turns the scatter into a gather).  It reads other
//     rows' take, so it cannot share a launch with pass A without a
//     grid-wide sync.  Staging take instead of recomputing it costs
//     4 * B * N^2 bytes written for the rows that spread, and the gather
//     reads u take rows per output row, mostly from L2: the blocks in
//     flight share one scenario, whose take (4 * N^2 bytes, 4 MB at
//     N = 1024) fits the 50 MB L2.  Slots whose weight or frac is zero
//     add an exact 0 in the plain version and are skipped here.
// The (B, N) per-row partials are summed to (B,) in a fixed order by
// pass B's first block of each scenario: no float atomics, so the same
// inputs give the same bits run after run.
//
// Rounding: built with -fmad=false so that a*b + c rounds twice, as the
// plain version does; t / max(q, 1e-30) is an IEEE division (no
// fast-math).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxU = 64;

__device__ __forceinline__ bool live(int d, int n) {
  return static_cast<unsigned>(d) < static_cast<unsigned>(n);
}

// Sum over the block in a fixed order: per-warp shuffle tree, then the
// warp partials by warp 0.  Every thread of the block must call it.
__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? red[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
}

// Pass A: one block per (b, i).  Dynamic shared memory: slot_of[N] int,
// row[N] float.
__global__ void __launch_bounds__(kThreads) rotor_rows(
    const float* __restrict__ own, const float* __restrict__ relay,
    const int* __restrict__ dst, int n, int u, int vlb,
    float* __restrict__ own_out, float* __restrict__ take,
    float* __restrict__ send_relay_e, float* __restrict__ share_e,
    float* __restrict__ frac_out, float* __restrict__ row_parts) {
  extern __shared__ int smem[];
  int* slot_of = smem;
  float* row = reinterpret_cast<float*>(smem + n);
  __shared__ float s_send_own[kMaxU], s_send_relay[kMaxU], s_room[kMaxU];
  __shared__ float s_r;
  __shared__ float red[32];

  const int i = blockIdx.x, b = blockIdx.y;
  const size_t bn = static_cast<size_t>(gridDim.y) * n;
  const size_t rb = static_cast<size_t>(b) * n + i;
  const size_t base = rb * n;

  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    slot_of[j] = -1;
    row[j] = own[base + j];
  }
  __syncthreads();
  if (threadIdx.x < u) {
    const int s = threadIdx.x;
    const int d = dst[static_cast<size_t>(i) * u + s];
    const bool ok = live(d, n);
    const int c = ok ? d : 0;
    const float vf = ok ? 1.f : 0.f;
    const float own_e = row[c] * vf;
    const float so = fminf(own_e, vf);
    float room = vf - so;
    const float relay_e = relay[base + c] * vf;
    const float sr = fminf(relay_e, room);
    room = room - sr;
    s_send_own[s] = so;
    s_send_relay[s] = sr;
    s_room[s] = room;
    send_relay_e[rb * u + s] = sr;
    if (ok) slot_of[d] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f, rr = 0.f, r = 0.f;
    for (int s = 0; s < u; ++s) {
      a += s_send_own[s];
      rr += s_send_relay[s];
      r += s_room[s];
    }
    row_parts[rb] = a;
    row_parts[bn + rb] = rr;
    row_parts[2 * bn + rb] = 0.f;
    s_r = r;
  }
  if (!vlb) {
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const int s = slot_of[j];
      own_out[base + j] = s >= 0 ? row[j] - s_send_own[s] : row[j];
    }
    return;
  }

  // Eligible backlog: own after direct sends, live-edge columns excluded
  // (the plain version's x - x there is an exact zero).
  float qp = 0.f;
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    if (slot_of[j] < 0) qp += row[j];
  const float q = block_sum(qp, red);  // its barriers publish s_r too
  const float r = s_r;
  const float t = fminf(q, r);
  const float frac = q > 0.f ? t / fmaxf(q, 1e-30f) : 0.f;
  const float inv_r = r > 0.f ? 1.f / fmaxf(r, 1e-30f) : 0.f;
  if (threadIdx.x < u) share_e[rb * u + threadIdx.x] = s_room[threadIdx.x] * inv_r;
  if (threadIdx.x == 0) {
    frac_out[rb] = frac;
    row_parts[2 * bn + rb] = t;
  }
  const bool spreads = frac != 0.f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    const int s = slot_of[j];
    if (s >= 0) {
      own_out[base + j] = row[j] - s_send_own[s];
      if (spreads) take[base + j] = 0.f;
    } else {
      const float tk = row[j] * frac;
      own_out[base + j] = row[j] - tk;
      if (spreads) take[base + j] = tk;
    }
  }
}

// Pass B: one block per (b, j).  Dynamic shared memory: slot_of[N] int.
// Block j == 0 of each scenario also reduces the row partials.
__global__ void __launch_bounds__(kThreads) rotor_cols(
    const float* __restrict__ relay, const int* __restrict__ dst,
    const float* __restrict__ take, const float* __restrict__ send_relay_e,
    const float* __restrict__ share_e, const float* __restrict__ frac,
    const float* __restrict__ row_parts, int n, int u, int vlb,
    float* __restrict__ relay_out, float* __restrict__ delivered,
    float* __restrict__ moved) {
  extern __shared__ int slot_of[];
  __shared__ float s_sr[kMaxU], s_w[kMaxU];
  __shared__ int s_k[kMaxU];
  __shared__ int s_cnt;
  __shared__ float red[32];

  const int j = blockIdx.x, b = blockIdx.y;
  const size_t bn = static_cast<size_t>(gridDim.y) * n;
  const size_t rb = static_cast<size_t>(b) * n + j;
  const size_t base = rb * n;

  for (int c = threadIdx.x; c < n; c += blockDim.x) slot_of[c] = -1;
  __syncthreads();
  if (threadIdx.x < u) {
    const int s = threadIdx.x;
    const int d = dst[static_cast<size_t>(j) * u + s];
    const bool ok = live(d, n);
    s_sr[s] = send_relay_e[rb * u + s];
    if (ok) slot_of[d] = s;
    const size_t kb = static_cast<size_t>(b) * n + (ok ? d : 0);
    s_w[s] = (vlb && ok && frac[kb] != 0.f) ? share_e[kb * u + s] : 0.f;
    s_k[s] = ok ? d : 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // keep the contributing slots, in slot order
    int cnt = 0;
    for (int s = 0; s < u; ++s) {
      if (s_w[s] != 0.f) {
        s_w[cnt] = s_w[s];
        s_k[cnt] = s_k[s];
        ++cnt;
      }
    }
    s_cnt = cnt;
  }
  __syncthreads();
  const int cnt = s_cnt;
  const float* take_b = take + static_cast<size_t>(b) * n * n;
  for (int c = threadIdx.x; c < n; c += blockDim.x) {
    float v = relay[base + c];
    const int s = slot_of[c];
    if (s >= 0) v = v - s_sr[s];
    if (cnt) {
      float acc = 0.f;
      for (int m = 0; m < cnt; ++m)
        acc = acc + s_w[m] * take_b[static_cast<size_t>(s_k[m]) * n + c];
      v = v + acc;
    }
    relay_out[base + c] = v;
  }

  if (j == 0) {
    const size_t row0 = static_cast<size_t>(b) * n;
    float a = 0.f, rr = 0.f, t = 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      a += row_parts[row0 + i];
      rr += row_parts[bn + row0 + i];
      t += row_parts[2 * bn + row0 + i];
    }
    a = block_sum(a, red);
    rr = block_sum(rr, red);
    t = block_sum(t, red);
    if (threadIdx.x == 0) {
      delivered[b] = a + rr;
      moved[b] = vlb ? t : 0.f;
    }
  }
}

}  // namespace

extern "C" {

// Both passes on `stream`; returns the first cudaError_t (0 = success).
// Scratch: take (B, N, N) (read only with vlb), send_relay_e and share_e
// (B, N, u), frac (B, N), row_parts (3, B, N).
int rotor_slice_launch(const float* own, const float* relay, const int* dst,
                       int bsz, int n, int u, int vlb,
                       float* own_out, float* relay_out, float* delivered,
                       float* moved, float* take, float* send_relay_e,
                       float* share_e, float* frac, float* row_parts,
                       void* stream) {
  if (u < 1 || u > kMaxU || n < 1 || bsz < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n, bsz);
  rotor_rows<<<grid, kThreads, 2 * n * sizeof(float), st>>>(
      own, relay, dst, n, u, vlb, own_out, take, send_relay_e, share_e, frac,
      row_parts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rotor_cols<<<grid, kThreads, n * sizeof(int), st>>>(
      relay, dst, take, send_relay_e, share_e, frac, row_parts, n, u, vlb,
      relay_out, delivered, moved);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

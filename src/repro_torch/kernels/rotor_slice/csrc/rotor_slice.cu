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
// and VLB-moved totals.
//
// Inputs: own, relay (B, N, N) f32; dst (N, u) int32, sentinel N for a
// dark slot (switch reconfiguring, or a self-loop inside a live
// matching, so partly dark columns are normal).  Slots are disjoint (a
// column j of row i is served by at most one slot), and every slot is
// an involution: dst[dst[i, s], s] == i wherever dst[i, s] is live.
//
// Bound.  The step must read own and relay once and write both once:
// 16 * B * N^2 bytes.  At k64-n1024-g4 with B = 16 that is 268 MB, about
// 80 us at 3.35 TB/s; the arithmetic (a few flops per element, plus at
// most u per element for the VLB gather) is far below the card's rate,
// so the step is bound by bytes.
//
// Design: two passes, 20 * B * N^2 bytes (own read twice, relay read
// once, both outputs written once), so at best 0.8 of the bound.
//   pass A, rows (one warp per (b, i), eight a block): the row's u edges
//     (direct and relay sends, room), its eligible backlog q_i (own off
//     the live columns, which a per-warp bit map in shared memory marks),
//     t_i, frac_i and the spread shares; writes own_out[b, i, :] with
//     16-byte accesses where rows are 16-byte aligned (a row of N <= 1024
//     stays in registers, so own is read once), and the row partials.
//     It scatters the spread weight into the partner's edge slot,
//     W[b, dst[i, s], s] = (share_i,s, i) where frac_i != 0 and the share
//     is not zero, and sets bit s of the partner's slot mask.  The
//     involution makes that slot (b, dst[i, s], s) the row's alone, so
//     the pair needs no atomics (the mask takes an integer atomicOr); a
//     slot dark for row j has no writer and no bit.  It counts the rows
//     that spread, per scenario, as an int.
//   pass B, column strips (one block of 1024 threads per (b, strip of T
//     columns), T from N alone so that N * T * 4 bytes fit shared memory;
//     a lane takes 8 columns of a row): stages the strip of take for
//     every spreading row k with cp.async, take = own[b, k, c] * frac_k
//     (the product the plain version forms, so the staged values keep its
//     bits), and lists the strip's live cells by row (column c is live in
//     row dst[c, s], by the involution), where take is zero and relay
//     loses send_relay; then for each row j, relay_out = relay -
//     send_relay at the row's live cells, plus sum over the slots of its
//     mask, in slot order, of W * take[k, strip], the next row's relay
//     and mask already in flight.  All of the gather's reuse comes from
//     shared memory; a scenario with no spreading row stages nothing.  L2
//     serves each strip's re-read of the masks, W and dst.
// The gather is what keeps pass B from the bytes: per output element it
// issues a multiply and an add (no fma, see below) and 4 bytes of
// shared-memory reads for each contributing slot, with a warp's eight
// rows waiting on the longest list.  The (B, N) per-row partials are
// summed to (B,) in a fixed order by pass B's first strip of each
// scenario: no float atomics, so the same inputs give the same bits run
// after run.
//
// Rounding: built with -fmad=false so that a*b + c rounds twice, as the
// plain version does; t / max(q, 1e-30) is an IEEE division (no
// fast-math).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxU = 64;
constexpr int kRowWarps = 8;       // pass A: one row per warp
constexpr int kHold = 8;           // pass A: float4s a lane holds, N <= 1024
constexpr int kColThreads = 1024;  // pass B
constexpr int kLaneCols = 8;       // pass B: strip columns a lane
constexpr int kPerRound = 8;       // pass B: slot loads a row issues together
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ bool live(int d, int n) {
  return static_cast<unsigned>(d) < static_cast<unsigned>(n);
}

// The same bits in every lane: xor pairs add commutatively.
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the block in a fixed order: per-warp shuffle tree, then the
// warp partials by warp 0.  Every thread of the block must call it.
__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = warp_sum(lane < (blockDim.x >> 5) ? red[lane] : 0.f);
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  const float out = red[0];
  __syncthreads();
  return out;
}

__device__ __forceinline__ void cp_async(float* dst, const float* src, int vec) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if (vec == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// VEC floats of a row (VEC 4: one 16-byte access).
template <int VEC> struct Vec { float v[VEC]; };

template <int VEC>
__device__ __forceinline__ Vec<VEC> load_vec(const float* p) {
  Vec<VEC> r;
  if constexpr (VEC == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    r.v[0] = x.x; r.v[1] = x.y; r.v[2] = x.z; r.v[3] = x.w;
  } else {
    r.v[0] = *p;
  }
  return r;
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const Vec<VEC>& r) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r.v[0], r.v[1], r.v[2], r.v[3]);
  } else {
    *p = r.v[0];
  }
}

// C consecutive floats, VEC at a time, of which the first `lim` exist
// (lim is a multiple of VEC).
template <int C, int VEC>
__device__ __forceinline__ void load_cols(Vec<C>& r, const float* p, int lim) {
#pragma unroll
  for (int ch = 0; ch < C; ch += VEC)
    if (ch < lim) {
      const Vec<VEC> x = load_vec<VEC>(p + ch);
#pragma unroll
      for (int e = 0; e < VEC; ++e) r.v[ch + e] = x.v[e];
    }
}

template <int C, int VEC>
__device__ __forceinline__ void store_cols(float* p, const Vec<C>& r, int lim) {
#pragma unroll
  for (int ch = 0; ch < C; ch += VEC)
    if (ch < lim) {
      Vec<VEC> x;
#pragma unroll
      for (int e = 0; e < VEC; ++e) x.v[e] = r.v[ch + e];
      store_vec<VEC>(p + ch, x);
    }
}

// Pass A: one warp per (b, i).  Dynamic shared memory: a bit map of the
// row's live columns, (kRowWarps, ceil(N / 32)) words.  HOLD > 0 keeps
// the row in registers (HOLD * 32 * VEC >= N), so own is read once and
// its loads start before the edge gathers; else the row is streamed
// twice (the second time mostly from L2).
template <int VEC, int HOLD>
__global__ void __launch_bounds__(kRowWarps * 32) rotor_rows(
    const float* __restrict__ own, const float* __restrict__ relay,
    const int* __restrict__ dst, int n, int u, int vlb,
    float* __restrict__ own_out, float* __restrict__ send_relay_e,
    float2* __restrict__ w_pairs, unsigned long long* __restrict__ w_mask,
    float* __restrict__ frac_out, float* __restrict__ row_parts,
    int* __restrict__ spreading) {
  extern __shared__ unsigned live_bits[];
  const int words = (n + 31) >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kRowWarps + warp, b = blockIdx.y;
  if (i >= n) return;  // whole warps only; no block barrier follows
  unsigned* bits = live_bits + warp * words;
  const size_t bn = static_cast<size_t>(gridDim.y) * n;
  const size_t rb = static_cast<size_t>(b) * n + i;
  const float* row = own + rb * n;
  float* out = own_out + rb * n;

  Vec<VEC> held[HOLD > 0 ? HOLD : 1];
  if constexpr (HOLD > 0) {
#pragma unroll
    for (int m = 0; m < HOLD; ++m) {
      const int c = (lane + 32 * m) * VEC;
      if (c < n) held[m] = load_vec<VEC>(row + c);
    }
  }
  for (int w = lane; w < words; w += 32) bits[w] = 0u;
  __syncwarp();
  // slots lane and lane + 32
  int d[2];
  float own_e[2], so[2], room[2];
  float a = 0.f, rr = 0.f, r = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = lane + 32 * h;
    d[h] = s < u ? dst[static_cast<size_t>(i) * u + s] : n;
    const bool ok = live(d[h], n);
    const float vf = ok ? 1.f : 0.f;
    own_e[h] = ok ? row[d[h]] : 0.f;
    so[h] = fminf(own_e[h], vf);
    const float rm = vf - so[h];
    const float sr = fminf(ok ? relay[rb * n + d[h]] : 0.f, rm);
    room[h] = rm - sr;
    if (s < u) send_relay_e[rb * u + s] = sr;
    if (ok) atomicOr(&bits[d[h] >> 5], 1u << (d[h] & 31));
    a += so[h];
    rr += sr;
    r += room[h];
  }
  a = warp_sum(a);
  rr = warp_sum(rr);
  r = warp_sum(r);
  __syncwarp();  // publishes the bit map

  // Eligible backlog: own after direct sends, live columns excluded (the
  // plain version's x - x there is an exact zero).
  float q = 0.f;
  if (vlb) {
    if constexpr (HOLD > 0) {
#pragma unroll
      for (int m = 0; m < HOLD; ++m) {
        const int c = (lane + 32 * m) * VEC;
        if (c < n) {
          const unsigned msk = bits[c >> 5] >> (c & 31);
#pragma unroll
          for (int e = 0; e < VEC; ++e) q += (msk >> e) & 1u ? 0.f : held[m].v[e];
        }
      }
    } else {
#pragma unroll 4
      for (int c = lane * VEC; c < n; c += 32 * VEC) {
        const Vec<VEC> x = load_vec<VEC>(row + c);
        const unsigned msk = bits[c >> 5] >> (c & 31);
#pragma unroll
        for (int e = 0; e < VEC; ++e) q += (msk >> e) & 1u ? 0.f : x.v[e];
      }
    }
    q = warp_sum(q);
  }
  const float t = fminf(q, r);
  const float frac = q > 0.f ? t / fmaxf(q, 1e-30f) : 0.f;
  if (vlb) {
    // the spread weight, into the partner's slot with this row's index
    const float inv_r = r > 0.f ? 1.f / fmaxf(r, 1e-30f) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float w = room[h] * inv_r;
      if (live(d[h], n) && frac != 0.f && w != 0.f) {
        const size_t jb = static_cast<size_t>(b) * n + d[h];
        w_pairs[jb * u + lane + 32 * h] = make_float2(w, __int_as_float(i));
        atomicOr(&w_mask[jb], 1ull << (lane + 32 * h));
      }
    }
    if (lane == 0) {
      frac_out[rb] = frac;
      if (frac != 0.f) atomicAdd(&spreading[b], 1);
    }
  }
  if (lane == 0) {
    row_parts[rb] = a;
    row_parts[bn + rb] = rr;
    row_parts[2 * bn + rb] = vlb ? t : 0.f;
  }

  // own_out: own - own * frac off the live columns (own itself without
  // vlb); the live columns' own - send_own by the slot's own lane.
  auto put = [&](int c, Vec<VEC> x) {
    if (vlb) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) x.v[e] = x.v[e] - x.v[e] * frac;
    }
    const unsigned msk = (bits[c >> 5] >> (c & 31)) & ((1u << VEC) - 1u);
    if (msk == 0u) {
      store_vec<VEC>(out + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        if (!((msk >> e) & 1u)) out[c + e] = x.v[e];
    }
  };
  if constexpr (HOLD > 0) {
#pragma unroll
    for (int m = 0; m < HOLD; ++m) {
      const int c = (lane + 32 * m) * VEC;
      if (c < n) put(c, held[m]);
    }
  } else {
#pragma unroll 4
    for (int c = lane * VEC; c < n; c += 32 * VEC) put(c, load_vec<VEC>(row + c));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (live(d[h], n)) out[d[h]] = own_e[h] - so[h];
}

// Pass B's dynamic shared memory, in bytes: the (N, T) strip of take
// (with vlb), then the strip's live cells as lists by row: head[N], and
// for each cell a link (next * 256 + strip column) and its send_relay.
__host__ __device__ constexpr size_t cols_smem(int n, int t, int u, int vlb) {
  return (vlb ? static_cast<size_t>(n) * t * 4 : 0) + static_cast<size_t>(n) * 4 +
         static_cast<size_t>(t) * u * 8;
}

// Pass B: one block per (strip of T columns, b).  Each row's T columns
// are covered by T / C lanes, C columns a lane.  The first strip of each
// scenario also reduces the row partials to the totals.
template <int T, int VEC>
__global__ void __launch_bounds__(kColThreads) rotor_cols(
    const float* __restrict__ own, const float* __restrict__ relay,
    const int* __restrict__ dst, int n, int u, int vlb,
    const float* __restrict__ send_relay_e, const float2* __restrict__ w_pairs,
    const unsigned long long* __restrict__ w_mask,
    const float* __restrict__ frac, const int* __restrict__ spreading,
    const float* __restrict__ row_parts, float* __restrict__ relay_out,
    float* __restrict__ delivered, float* __restrict__ moved) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[32];
  constexpr int C = VEC == 1 ? 1 : (kLaneCols < T ? kLaneCols : T);
  constexpr int G = T / C;  // lanes a row
  float* take = reinterpret_cast<float*>(smem);
  int* head = reinterpret_cast<int*>(smem + (vlb ? static_cast<size_t>(n) * T * 4 : 0));
  int* link = head + n;
  float* cell_sr = reinterpret_cast<float*>(link + T * u);
  const int strip = blockIdx.x, b = blockIdx.y;
  const int c0 = strip * T;
  const int width = min(T, n - c0);
  const int rows_per_step = blockDim.x / G;
  const int t = (threadIdx.x % G) * C;  // this lane's first strip column
  const bool col_ok = t < width;          // VEC 4: width is a multiple of 4
  const size_t plane = static_cast<size_t>(b) * n * n;
  const size_t row0 = static_cast<size_t>(b) * n;
  const bool gather = vlb && spreading[b] > 0;

  // Rows go to threads as j = j0 + k * rows_per_step.  A thread keeps its
  // next row's relay values and mask in flight while it adds the gather
  // to the current one.
  const int j0 = threadIdx.x / G;
  Vec<C> v, v_next;
  unsigned long long msk, msk_next;
  auto fetch = [&](int j, Vec<C>& vv, unsigned long long& mm) {
    const bool ok = j < n && col_ok;
    if (ok) load_cols<C, VEC>(vv, relay + plane + static_cast<size_t>(j) * n + c0 + t, width - t);
    mm = ok && gather ? w_mask[row0 + j] : 0ull;
  };

  if (gather)  // own's strip of every spreading row
    for (int k = j0; k < n; k += rows_per_step)
      if (col_ok && frac[row0 + k] != 0.f) {
#pragma unroll
        for (int ch = 0; ch < C; ch += VEC)
          if (ch < width - t)
            cp_async(take + k * T + t + ch,
                     own + plane + static_cast<size_t>(k) * n + c0 + t + ch, VEC);
      }
  for (int k = threadIdx.x; k < n; k += blockDim.x) head[k] = -1;
  fetch(j0, v, msk);
  __syncthreads();
  // The strip's live cells, as lists by row: column c0 + c is live in row
  // j = dst[c0 + c, s] (the involution); relay loses send_relay there.
  for (int x = threadIdx.x; x < width * u; x += blockDim.x) {
    const int c = x / u, s = x - c * u;
    const int j = dst[static_cast<size_t>(c0 + c) * u + s];
    if (!live(j, n)) continue;
    cell_sr[x] = send_relay_e[(row0 + j) * u + s];
    link[x] = atomicExch(&head[j], x) * 256 + c;  // each cell once: any order
  }
  if (gather) {  // take = own * frac, by the thread that copied it
    cp_async_wait_all();
    for (int k = j0; k < n; k += rows_per_step) {
      const float f = frac[row0 + k];
      if (col_ok && f != 0.f) {
#pragma unroll
        for (int e = 0; e < C; ++e) take[k * T + t + e] = take[k * T + t + e] * f;
      }
    }
  }
  __syncthreads();
  if (gather) {  // take is zero at the live cells
    for (int j = threadIdx.x; j < n; j += blockDim.x)
      for (int x = head[j]; x >= 0; x = link[x] >> 8) take[j * T + (link[x] & 255)] = 0.f;
    __syncthreads();
  }

  for (int j = j0; j < n; j += rows_per_step) {
    fetch(j + rows_per_step, v_next, msk_next);
    if (col_ok) {
      for (int x = head[j]; x >= 0;) {
        const int l = link[x];
        const int rel = (l & 255) - t;
#pragma unroll
        for (int e = 0; e < C; ++e)
          if (e == rel) v.v[e] = v.v[e] - cell_sr[x];
        x = l >> 8;
      }
      if (gather) {
        // the contributing slots in slot order, kPerRound loads at a time
        const float2* pr = w_pairs + (row0 + j) * u;
        const float* tk_t = take + t;
        float acc[C];
#pragma unroll
        for (int e = 0; e < C; ++e) acc[e] = 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          unsigned word = static_cast<unsigned>(msk >> (32 * half));
          while (word) {
            int ss[kPerRound];
            float2 pw[kPerRound];
#pragma unroll
            for (int q = 0; q < kPerRound; ++q) {
              ss[q] = word ? 32 * half + __ffs(word) - 1 : -1;
              word &= word - 1;
            }
#pragma unroll
            for (int q = 0; q < kPerRound; ++q)
              if (ss[q] >= 0) pw[q] = pr[ss[q]];
#pragma unroll
            for (int q = 0; q < kPerRound; ++q)
              if (ss[q] >= 0) {
                Vec<C> tk;
                load_cols<C, VEC>(tk, tk_t + __float_as_int(pw[q].y) * T, C);
#pragma unroll
                for (int e = 0; e < C; ++e) acc[e] = acc[e] + pw[q].x * tk.v[e];
              }
          }
        }
#pragma unroll
        for (int e = 0; e < C; ++e) v.v[e] = v.v[e] + acc[e];
      }
      store_cols<C, VEC>(relay_out + plane + static_cast<size_t>(j) * n + c0 + t, v, width - t);
    }
    v = v_next;
    msk = msk_next;
  }

  if (strip == 0) {
    const size_t bn = static_cast<size_t>(gridDim.y) * n;
    float a = 0.f, rr = 0.f, tt = 0.f;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      a += row_parts[row0 + i];
      rr += row_parts[bn + row0 + i];
      tt += row_parts[2 * bn + row0 + i];
    }
    a = block_sum(a, red);
    rr = block_sum(rr, red);
    tt = block_sum(tt, red);
    if (threadIdx.x == 0) {
      delivered[b] = a + rr;
      moved[b] = vlb ? tt : 0.f;
    }
  }
}

struct ColsArgs {
  const float *own, *relay;
  const int* dst;
  int n, u, vlb;
  const float* send_relay_e;
  const float2* w_pairs;
  const unsigned long long* w_mask;
  const float* frac;
  const int* spreading;
  const float* row_parts;
  float *relay_out, *delivered, *moved;
};

template <int T, int VEC>
cudaError_t launch_cols(const ColsArgs& a, int bsz, cudaStream_t st) {
  const size_t smem = cols_smem(a.n, T, a.u, a.vlb);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rotor_cols<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.n + T - 1) / T, bsz);
  rotor_cols<T, VEC><<<grid, kColThreads, smem, st>>>(
      a.own, a.relay, a.dst, a.n, a.u, a.vlb, a.send_relay_e, a.w_pairs,
      a.w_mask, a.frac, a.spreading, a.row_parts, a.relay_out, a.delivered,
      a.moved);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_cols_t(int strip, const ColsArgs& a, int bsz, cudaStream_t st) {
  switch (strip) {
    case 8: return launch_cols<8, VEC>(a, bsz, st);
    case 16: return launch_cols<16, VEC>(a, bsz, st);
    case 32: return launch_cols<32, VEC>(a, bsz, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Both passes on `stream`; returns the first cudaError_t (0 = success).
// `strip` is pass B's strip width T (8, 16 or 32).  Scratch:
// send_relay_e (B, N, u) f32; w_pairs (B, N, u) float2 (the weight and
// the partner row's index) and w_mask (B, N) u64, read only with vlb;
// frac (B, N), row_parts (3, B, N), spreading (B,) int.
int rotor_slice_launch(const float* own, const float* relay, const int* dst,
                       int bsz, int n, int u, int vlb, int strip,
                       float* own_out, float* relay_out, float* delivered,
                       float* moved, float* send_relay_e, void* w_pairs,
                       void* w_mask, float* frac, float* row_parts,
                       int* spreading, void* stream) {
  if (u < 1 || u > kMaxU || n < 1 || bsz < 1 || bsz > 65535 ||
      cols_smem(n, strip, u, vlb) > static_cast<size_t>(kMaxSmem) - 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte accesses where every row starts on 16 bytes
  const uintptr_t any = reinterpret_cast<uintptr_t>(own) |
                        reinterpret_cast<uintptr_t>(relay) |
                        reinterpret_cast<uintptr_t>(own_out) |
                        reinterpret_cast<uintptr_t>(relay_out);
  const bool vec4 = n % 4 == 0 && any % 16 == 0;
  auto* pairs = static_cast<float2*>(w_pairs);
  auto* mask = static_cast<unsigned long long*>(w_mask);
  cudaError_t err = cudaSuccess;
  if (vlb) {
    err = cudaMemsetAsync(spreading, 0, bsz * sizeof(int), st);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(mask, 0, static_cast<size_t>(bsz) * n * 8, st);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 rows((n + kRowWarps - 1) / kRowWarps, bsz);
  const size_t bits = static_cast<size_t>(kRowWarps) * ((n + 31) / 32) * sizeof(unsigned);
#define ROTOR_ROWS(V, H)                                                      \
  rotor_rows<V, H><<<rows, kRowWarps * 32, bits, st>>>(                        \
      own, relay, dst, n, u, vlb, own_out, send_relay_e, pairs, mask, frac,    \
      row_parts, spreading)
  if (vec4 && n <= 32 * 4 * kHold)
    ROTOR_ROWS(4, kHold);
  else if (vec4)
    ROTOR_ROWS(4, 0);
  else
    ROTOR_ROWS(1, 0);
#undef ROTOR_ROWS
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const ColsArgs a{own, relay, dst, n, u, vlb, send_relay_e, pairs, mask,
                   frac, spreading, row_parts, relay_out, delivered, moved};
  err = vec4 ? launch_cols_t<4>(strip, a, bsz, st) : launch_cols_t<1>(strip, a, bsz, st);
  return static_cast<int>(err);
}

}  // extern "C"

// Tensor-core (wgmma, sm_90a) building blocks of the bf16 expert-FFN
// backward (moe_gmm_bwd.cu): 64 x 64 bf16 atoms in swizzled shared memory,
// their descriptors read K-major or MN-major, and the m64n64k16 product of
// two such atoms into a warpgroup's f32 accumulator.
//
// An atom holds 64 rows of 64 bf16 (128 bytes) of a row-major matrix, the
// 16-byte chunks of row r swizzled (chunk ^= r mod 8: the 128-byte swizzle
// mode), on a 1024-byte boundary.  One layout is read two ways: K-major
// (its rows are the product's M or N, its columns the summed index) and
// MN-major (its rows are the summed index, its columns M or N), for either
// operand: wgmma's transpose flags choose, so no operand needs a transpose
// copy.  An atom is filled by 16-byte cp.async copies where the matrix's
// rows are a whole number of aligned 16-byte chunks, else by element
// loads into the same layout; whatever lies outside the matrix is zero.
//
// The pieces follow kernels/flash_attention/csrc/flash_wgmma.cuh (the
// flash kernels' 64-row tiles at hd 64), with MN-major A added; the build
// keys the library by this header's bytes too (kernels/__init__.py,
// library_path).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWG = 128;                  // one warpgroup
constexpr int kAtom = 64;                 // rows and columns of an atom
constexpr int kAtomBytes = kAtom * 128;   // 8 KB

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the 1024-byte aligned start of dynamic shared memory
__device__ __forceinline__ uint32_t aligned_smem(const void* base) {
  return (smem_addr(base) + 1023u) & ~1023u;
}

// Byte offset of element (r, c) in an atom, c a multiple of 8.
__device__ __forceinline__ uint32_t atom_offset(int r, int c) {
  return static_cast<uint32_t>(r * 128 + ((c * 2) ^ ((r & 7) << 4)));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, const uint32_t* v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
               :: "r"(dst), "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// Rows row0 .. row0 + 63, columns col0 .. col0 + 63 of a row-major bf16
// matrix (rows x ld, every column of a row in the matrix) into the atom
// at dst, zero outside the matrix; NT threads side by side along a row,
// thread t of them.  vec: the matrix starts on 16 bytes and ld is a
// multiple of 8, so a chunk is one 16-byte copy; else element loads.
template <int NT>
__device__ __forceinline__ void load_atom(uint32_t dst, const bf16* src,
                                          int ld, int rows, int row0,
                                          int col0, bool vec, int t) {
#pragma unroll
  for (int i = 0; i < kAtom * 8 / NT; ++i) {
    const int q = t + i * NT;
    const int r = q >> 3, c = (q & 7) * 8;
    const int gr = row0 + r, gc = col0 + c;
    const uint32_t at = dst + atom_offset(r, c);
    const bf16* g = src + static_cast<size_t>(gr) * ld + gc;
    if (vec) {
      const bool in = gr < rows && gc < ld;
      cp_async16(at, in ? g : src, in ? 16 : 0);
    } else {
      const uint16_t* e = reinterpret_cast<const uint16_t*>(g);
      uint32_t v[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (gr < rows && gc + j < ld)
          v[j >> 1] |= static_cast<uint32_t>(e[j]) << (16 * (j & 1));
      st_shared16(at, v);
    }
  }
}

// Make this thread's shared-memory writes visible to the wgmma (async)
// proxy; a barrier after it makes everyone's visible.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major atom: 8-row groups SBO = 1024 bytes apart (LBO unused by the
// swizzled K-major layout); k16 step kk is 32 bytes along the row.
// MN-major atom: its rows are the summed index, 8-row groups SBO = 1024
// apart; one atom is 64 wide, so LBO (the stride to the next 64 columns)
// is never crossed by an m64n64 instruction; k16 step kk is 16 rows.
template <bool MN>
__device__ __forceinline__ uint64_t desc(uint32_t atom, int kk) {
  return make_desc(atom, MN ? kAtomBytes : 16, 1024) +
         (MN ? 128 * kk : 2 * kk);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait for all committed wgmma groups
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of registers that a wgmma
// in flight reads or writes across the wait for it (asm statements keep
// their order): fenced after the wait, they are live until it.
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 64 f32) += A (64 x 16) B (16 x 64), both from shared memory:
// A MN-major if TA (else K-major), B MN-major if TB.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// d += A B over one 64-deep stage: A and B atoms, four k16 steps.
template <int TA, int TB>
__device__ __forceinline__ void mma_atoms(float* d, uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_n64<TA, TB>(d, desc<TA != 0>(a, kk), desc<TB != 0>(b, kk));
}

// Row and column in the 64 x 64 tile of a warpgroup thread tw's
// accumulator element i: d[4j + 0, 1] at row r, columns 8j + 2 (lane mod
// 4) + 0, 1; d[4j + 2, 3] at row r + 8.
__device__ __forceinline__ int frag_row(int tw, int i) {
  return 16 * (tw >> 5) + ((tw & 31) >> 2) + 8 * ((i >> 1) & 1);
}
__device__ __forceinline__ int frag_col(int tw, int i) {
  return 8 * (i >> 2) + 2 * (tw & 3) + (i & 1);
}

// The stages of a cp.async ring: load(stage address, step) issues step's
// copies, mma(stage address) its wgmma products for this warpgroup and
// waits for them.  Step s + STAGES - 1 is loaded while step s computes.
template <int STAGES, int BYTES, typename Load, typename Mma>
__device__ __forceinline__ void pipeline(uint32_t ring, int steps,
                                         Load&& load, Mma&& mma) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(ring + s * BYTES, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<STAGES - 2>();   // step s has landed (this thread's part)
    fence_proxy_async();
    __syncthreads();               // everyone's part; step s - 1 is done
    const int next = s + STAGES - 1;
    if (next < steps) load(ring + (next % STAGES) * BYTES, next);
    cp_async_commit();
    mma(ring + (s % STAGES) * BYTES);
  }
}

}  // namespace

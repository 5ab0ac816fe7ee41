// Tensor-core (wgmma, sm_90a) building blocks of the bf16 flash kernels:
// the forward (flash_attention.cu, flash_fwd_wgmma) and the backward
// (flash_attention_bwd.cu, flash_bwd_dkdv_wgmma and flash_bwd_dq_wgmma).
//
// Every operand is a 64 x HD bf16 tile in shared memory, filled by 16-byte
// cp.async copies straight into the layout the wgmma descriptors name: per
// tile, column blocks of min(HD, 64) elements, rows of W = min(2 HD, 128)
// bytes, 16-byte chunks swizzled (chunk ^= (address >> 7) mod W/16: the
// 128/64/32-byte swizzle modes).  One layout is read two ways: K-major (the
// tile's rows are the product's M or N, its columns the depth: Q and K of
// S = Q K^T) and MN-major (its rows are the depth: V of O = P V), so no
// operand needs a transpose copy.  A product's f32 accumulator fragment,
// packed in pairs to bf16x2, is the next product's A fragment from
// registers, with no shuffle (pack_p).
//
// Included by both .cu files of the flash library builds; the build keys
// each library by this header's bytes too (kernels/__init__.py,
// library_path).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;        // rows of a tile: queries or keys
constexpr int kWG = 128;         // one warpgroup

// A 64 x HD bf16 tile in shared memory as the wgmma descriptors read it:
// column blocks of kCols elements, each 64 rows of kW bytes, swizzled.
template <int HD>
struct Tile {
  static constexpr int kW = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int kCols = kW / 2;
  static constexpr int kBytes = kRows * HD * 2;
  // descriptor layout type: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte swizzle
  static constexpr uint64_t kLayout = kW == 128 ? 1 : (kW == 64 ? 2 : 3);
};

// Byte offset of element (r, c) in the tile, c a multiple of 8.  The
// swizzle XORs the 16-byte chunk index with address bits 7.. (mod W/16);
// tiles start on 1024-byte boundaries, so offsets stand for addresses.
template <int HD>
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  constexpr int W = Tile<HD>::kW, C = Tile<HD>::kCols;
  const uint32_t off = (c / C) * (kRows * W) + r * W + (c % C) * 2;
  return off ^ (((off >> 7) & (W / 16 - 1)) << 4);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// wait for all of this thread's committed copies
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows row0.. of a (rows, HD) matrix into a tile, 16 bytes a copy, the
// block's NT threads (t one of them) side by side along a row; rows >=
// rows_valid are zero-filled, never read.
template <int HD, int NT = kWG>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int row0, int rows_valid, int t) {
  constexpr int kChunks = HD / 8;          // 16-byte chunks a row
  constexpr int kStep = NT / kChunks;      // rows a pass
  const int c = (t % kChunks) * 8;
#pragma unroll
  for (int r = t / kChunks; r < kRows; r += kStep) {
    const bool in = row0 + r < rows_valid;
    const bf16* g = in ? src + static_cast<size_t>(row0 + r) * HD + c : src;
    cp_async16(dst + tile_offset<HD>(r, c), g, in ? 16 : 0);
  }
}

// Make this thread's cp.async writes visible to the wgmma (async) proxy;
// a barrier after it makes everyone's visible.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

// The descriptor through an empty asm: what is derived from it is computed
// where it is used, not hoisted out of the key loop into registers.
__device__ __forceinline__ uint64_t opaque(uint64_t d) {
  asm volatile("" : "+l"(d));
  return d;
}

// K-major operand (Q as A, K as B of S = Q K^T): 8-row groups SBO = 8 W
// apart (LBO is unused by swizzled K-major layouts).  Step kk adds, in
// 16-byte units, its column block and 32 bytes a step inside the swizzle
// row (no carry: shared addresses stay below 2^18).
template <int HD>
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile) {
  return make_desc(tile, 16, 8 * Tile<HD>::kW, Tile<HD>::kLayout);
}
template <int HD>
__device__ __forceinline__ uint64_t k_major_step(int kk) {
  constexpr int W = Tile<HD>::kW, C = Tile<HD>::kCols;
  return ((16 * kk / C) * (kRows * W) + (16 * kk % C) * 2) >> 4;
}

// MN-major operand (V as B of O = P V, keys x hd with hd contiguous): key
// step kk is 16 rows (two 8-row groups, SBO = 8 W apart); column block j
// is one swizzle atom wide, so LBO (the stride between atoms along N) is
// not crossed by one instruction.
template <int HD>
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile) {
  constexpr int W = Tile<HD>::kW;
  return make_desc(tile, kRows * W, 8 * W, Tile<HD>::kLayout);
}
template <int HD>
__device__ __forceinline__ uint64_t mn_major_step(int kk, int j) {
  constexpr int W = Tile<HD>::kW;
  return (j * (kRows * W) + kk * 16 * W) >> 4;
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
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// d (64 x 64 f32) = A B (+ d if accumulate): A, B descriptors, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x N f32) += A B: A (64 x 16 bf16) from registers, B descriptor
// MN-major (transpose-B)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Start d (64 x 64 f32 fragment) = A B^T as one wgmma group, A and B
// 64 x HD tiles read K-major (S = Q K^T in the forward; S^T = K Q^T,
// dP^T = V dO^T, S and dP = dO V^T in the backward).  d is zeroed first,
// so that its last values are dead here (the first product ignores them).
template <int HD>
__device__ __forceinline__ void start_ss(float* d, uint32_t a, uint32_t b) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
  const uint64_t ad = opaque(desc_k_major<HD>(a));
  const uint64_t bd = opaque(desc_k_major<HD>(b));
  fence_regs<32>(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    wgmma_ss_n64(d, ad + k_major_step<HD>(kk), bd + k_major_step<HD>(kk),
                 kk > 0);
  wgmma_commit();
}

// A 64 x 64 product as the A operand: a thread's fragment of a 64 x N
// product holds, for column group i, d[4i + 0, 1] at row r, columns 8i + 2
// (lane mod 4) + 0, 1 and d[4i + 2, 3] at row r + 8, so pairs of the
// 64 x 64 f32 fragment p rounded to bf16x2 are the k16 A fragments
// a[4kk .. 4kk + 3].
__device__ __forceinline__ void pack_p(uint32_t* a, const float* p) {
#pragma unroll
  for (int i = 0; i < 16; ++i) a[i] = pack_bf16x2(p[2 * i], p[2 * i + 1]);
}

// Start acc (64 x HD f32 fragment) += A B as one wgmma group, A (64 x 64)
// from the registers a (pack_p), B a 64 x HD tile read MN-major (O += P V
// in the forward; dV += P^T dO, dK += dS^T Q and dQ += dS K in the
// backward).
template <int HD>
__device__ __forceinline__ void start_rs(float* acc, const uint32_t* a,
                                         uint32_t b) {
  constexpr int N = HD < 64 ? HD : 64;   // columns an instruction
  const uint64_t bd = opaque(desc_mn_major<HD>(b));
  fence_regs<HD / 2>(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < HD / N; ++j)
      wgmma_rs<N>(acc + j * (N / 2), a + 4 * kk,
                  bd + mn_major_step<HD>(kk, j));
  wgmma_commit();
}

// the 1024-byte aligned start of dynamic shared memory
__device__ __forceinline__ uint32_t aligned_smem(const void* base) {
  return (smem_addr(base) + 1023u) & ~1023u;
}

}  // namespace

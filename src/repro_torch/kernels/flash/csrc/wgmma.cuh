// What K6 (flash.cu) and K7 (flash_bwd.cu) share: the position mask and
// the tile vote's compaction, cp.async copies, ex2.approx, and the wgmma
// pieces of their MMA paths (operand descriptors of 128-byte-swizzled
// tiles, fences, the m64n64k16 products with A from registers or from
// shared memory).  One definition each, so the two kernels mask and
// multiply alike.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kNoWindow = -2147483647 - 1;  // INT_MIN: no window given
constexpr int kSwizzleBytes = 1024;      // one 128-byte-swizzle atom: 8 rows

// `window` is kNoWindow when none is given
__device__ __forceinline__ bool visible(int kp, int qp, int causal, int window) {
  bool ok = kp >= 0;
  if (causal) ok = ok && kp <= qp;
  if (window != kNoWindow) ok = ok && (long long)kp > (long long)qp - window;
  return ok;
}

// Whether some row with a position in [lo, hi] may see key position kp: a
// superset of the rows' own tests, used only to skip tiles.
__device__ __forceinline__ bool maybe_visible(int kp, int lo, int hi,
                                              int causal, int window) {
  bool ok = kp >= 0;
  if (causal) ok = ok && kp <= hi;
  if (window != kNoWindow) ok = ok && (long long)kp > (long long)lo - window;
  return ok;
}

// Warp 0 writes the indices of the set flags[0..n) to list in order and
// their count to *count.
__device__ __forceinline__ void compact(const int* flags, int n, int* list,
                                        int* count) {
  if (threadIdx.x >= 32) return;
  const int lane = threadIdx.x;
  int total = 0;
  for (int c = 0; c < n; c += 32) {
    const bool on = c + lane < n && flags[c + lane];
    const unsigned bal = __ballot_sync(kFull, on);
    if (on) list[total + __popc(bal & ((1u << lane) - 1u))] = c + lane;
    total += __popc(bal);
  }
  if (lane == 0) *count = total;
}

// 2^x in one MUFU instruction (relative error ~2^-22)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global → shared, asynchronous; zeros where !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// wgmma operand descriptor of a 128-byte-swizzled tile in shared memory:
// start address, leading and stride byte offsets (16-byte units), layout 1
// (128B swizzle).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// makes this thread's shared-memory writes (cp.async included) visible to
// the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keeps the compiler from moving accumulator registers across an
// asynchronous wgmma
__device__ __forceinline__ void pin(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (64×64 f32) = A (64×16 bf16, registers) · B (16×64 bf16, shared
// memory) [+ D]; B K-major (TransB 0) or MN-major (TransB 1)
template <int TransB>
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate),
        "n"(TransB)
      : "memory");
}

// D (64×64 f32) = A (64×16 bf16) · B (16×64 bf16) [+ D], both from shared
// memory and K-major (the form that keeps a block's own tile out of the
// registers)
__device__ __forceinline__ void wgmma_64x64x16_ss(float (&d)[32], uint64_t desc_a,
                                                  uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
        "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
        "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
        "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate)
      : "memory");
}

}  // namespace

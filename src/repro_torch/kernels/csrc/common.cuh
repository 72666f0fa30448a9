// Helpers shared by the kernel sources: float32 / bfloat16 conversion,
// asynchronous tile copies and the float32-accurate tensor-core
// products (3xTF32, through mma.sync and wgmma).  Included by attention.cu,
// scan.cu and peak.cu; each translation unit keeps its own copy (anonymous
// namespace).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// e^x as 2^(x log2 e): the hardware's exp2 and one multiply, where expf
// takes about eight instructions.  The rounding of x log2 e costs a
// relative error of |x| 2^-24 in the result, below 1e-6 wherever e^x is
// not negligible (the kernels take it only of x <= 0).
__device__ __forceinline__ float exp_fast(float x) { return exp2f(x * 1.4426950408889634f); }

// Four consecutive elements as float32 (16-byte load for float32, 8-byte
// load for bfloat16; the wrappers check the alignment).
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// ---------------------------------------------------------------------------
// Asynchronous tile copies, global -> shared (cp.async, sm_80 and later)
// ---------------------------------------------------------------------------

// One chunk of four elements (16 bytes of float32, 8 of bfloat16: the
// wrappers check 4-element alignment).  valid = false copies nothing and
// zero-fills the chunk (src-size 0); src must still be a mapped address.
template <typename T>
__device__ __forceinline__ void cp_async4(T* dst, const T* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 * (int)sizeof(T) : 0;
  if constexpr (sizeof(T) == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  }
}

// One 4-byte element (a strided float32 such as dA, an int32 position),
// zero-filled if !valid.
template <typename U>
__device__ __forceinline__ void cp_async1(U* dst, const U* src, bool valid) {
  static_assert(sizeof(U) == 4, "one 4-byte element");
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying rows [r0, r0 + ROWS) of a (S, COLS) matrix (row stride
// ld_src elements) into shared memory with row stride LD, in the source's
// type; rows at or past S are zero-filled.  The caller commits the group.
template <int ROWS, int COLS, int LD, int NT, typename T>
__device__ __forceinline__ void copy_rows_async(T* dst, const T* src, long long ld_src, int r0,
                                                int S) {
  constexpr int CPR = COLS / 4;  // chunks per row
  static_assert(COLS % 4 == 0 && LD % 4 == 0, "rows of whole, aligned chunks");
  for (int idx = threadIdx.x; idx < ROWS * CPR; idx += NT) {
    const int r = idx / CPR, c = (idx % CPR) * 4;
    const bool valid = r0 + r < S;
    cp_async4(dst + r * LD + c, valid ? src + (r0 + r) * ld_src + c : src, valid);
  }
}

// ---------------------------------------------------------------------------
// Float32-accurate products on the tensor cores (3xTF32)
// ---------------------------------------------------------------------------
//
// mma.sync.m16n8k8 with tf32 operands and a float32 accumulator; for lane
// = 4 g + t (g = lane / 4, t = lane % 4) of the warp:
//   A (16 x 8, row):  a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8 x 8, col):   b0 = B[t][g], b1 = B[t+4][g]
//   C (16 x 8):       c0 = C[g][2t], c1 = C[g][2t+1], c2 = C[g+8][2t], c3 = C[g+8][2t+1]
// One TF32 pass keeps 10 of float32's 23 mantissa bits (relative error
// about 5e-4 per product).  Each float32 operand x is split into hi =
// tf32(x) and lo = tf32(x - hi), and a.b is taken as a_lo.b_hi + a_hi.b_lo
// + a_hi.b_hi (the a_lo.b_lo term is below float32's rounding): three
// passes, small terms first, into one float32 accumulator.  This is
// CUTLASS's "fast accurate float32" mode, at a third of the TF32 rate
// (495 / 3 = 165 TFLOP/s on an H100 SXM, against 67 on the CUDA cores).
// Both halves are rounded to nearest with ties away from zero, as
// cvt.rna.tf32.f32 rounds a finite value: adding half a tf32 ulp (bit 12)
// to the bit pattern carries into the kept bits exactly when the dropped
// ones reach half.  That takes two integer instructions where cvt.rna
// compiles to four (it also guards NaN and infinity, which the kernels'
// finite operands never are).  hi is masked to its 19 bits so that x - hi
// is exact; lo's dropped bits are left in place, as the tensor core reads
// only the 19 high bits of a tf32 operand.

struct Split {
  uint32_t hi, lo;
};

__device__ __forceinline__ Split split_tf32(float x) {
  const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi)) + 0x1000u};
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// c += A B for one m16n8k8 step, float32-accurate (three TF32 passes).
__device__ __forceinline__ void mma3(float (&c)[4], const Split (&a)[4], const Split (&b)[2]) {
  mma_tf32(c, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b[0].hi, b[1].hi);
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
  mma_tf32(c, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// ---------------------------------------------------------------------------
// Warpgroup products on the tensor cores (wgmma, sm_90a)
// ---------------------------------------------------------------------------
//
// wgmma.mma_async.m64nNk8 with tf32 operands: A (64 x 8) from registers,
// each warp of the warpgroup holding 16 rows in mma.sync's m16n8k8 A layout
// (a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]); B (8 x N)
// from shared memory, K-major as tf32 requires (each column's 8 k values
// contiguous), through a descriptor; D (64 x N) float32 in registers, per
// warp in mma.sync's C layout for each 8 columns i: d[4i + e] = D[g + 8
// (e / 2)][8i + 2t + e % 2].  B's layout is the canonical one without
// swizzle: core matrices of 8 columns x 4 k values (16 bytes a column),
// LBO bytes apart along k and SBO bytes apart along N.

__device__ __forceinline__ uint64_t wgmma_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  const uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(smem));
  return ((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wgmma reads its A registers and updates its accumulators asynchronously:
// pinning them around the fence / wait keeps the compiler from moving
// their other reads and writes across, or reusing A's registers early.
template <int N>
__device__ __forceinline__ void pin_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]));
}
template <int N>
__device__ __forceinline__ void pin_regs(Split (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i].hi), "+r"(r[i].lo));
}

// Shared-memory writes by threads become visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// d += A B, one tf32 pass (m64nNk8).
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2], uint32_t a0, uint32_t a1,
                                           uint32_t a2, uint32_t a3, uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<80>(float (&d)[40], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], uint32_t a0, uint32_t a1,
                                               uint32_t a2, uint32_t a3, uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc));
}

// d += A B, float32-accurate: three tf32 passes, small terms first (as mma3).
template <int N>
__device__ __forceinline__ void wgmma3(float (&d)[N / 2], const Split (&a)[4], uint64_t b_hi,
                                       uint64_t b_lo) {
  wgmma_tf32<N>(d, a[0].lo, a[1].lo, a[2].lo, a[3].lo, b_hi);
  wgmma_tf32<N>(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b_lo);
  wgmma_tf32<N>(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b_hi);
}

// d += A B, one tf32 pass (m64n32k8), A from shared memory too: K-major in
// the same canonical layout as B (core matrices of 8 rows x 4 k values, LBO
// bytes apart along k and SBO bytes apart along the rows).
__device__ __forceinline__ void wgmma_tf32_ss32(float (&d)[16], uint64_t desc_a,
                                                uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b));
}

// wgmma3 with A's halves from shared memory (N = 32).
template <int N>
__device__ __forceinline__ void wgmma3_ss(float (&d)[N / 2], uint64_t a_hi, uint64_t a_lo,
                                          uint64_t b_hi, uint64_t b_lo) {
  static_assert(N == 32, "the score tile");
  wgmma_tf32_ss32(d, a_lo, b_hi);
  wgmma_tf32_ss32(d, a_hi, b_lo);
  wgmma_tf32_ss32(d, a_hi, b_hi);
}

}  // namespace

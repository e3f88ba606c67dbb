// Tensor-core and asynchronous-copy building blocks shared by the bf16
// flash kernels (flash_fwd.cu, flash_bwd.cu, flash_fused_bwd.cu): warp-level
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), ldmatrix / ldmatrix.trans
// from shared memory, and 16- and 4-byte cp.async with zero fill.
//
// Fragment layouts of mma.m16n8k16 (lane = 4 * g + c, g = lane / 4,
// c = lane % 4), each 32-bit register holding two bf16 of neighbouring
// columns, the lower column in the lower half:
//   A (16 x 16, row-major): a0 (g, 2c..2c+1), a1 (g+8, 2c..), a2 (g, 2c+8..),
//                           a3 (g+8, 2c+8..)
//   B (16 x 8, k x n):      b0 (k 2c..2c+1, n g), b1 (k 2c+8.., n g)
//   C (16 x 8, f32):        c0, c1 (g, 2c..2c+1), c2, c3 (g+8, 2c..2c+1)
// Two C tiles side by side (16 x 16) are exactly one A tile once packed to
// bf16, which is how p and ds feed the next product without leaving
// registers.

#pragma once

#include <cuda_bf16.h>

#include <cmath>
#include <cstdint>

namespace dtx {

using bf16 = __nv_bfloat16;

// Threads of a tensor-core block: 8 warps.
constexpr int kTcThreads = 256;

// bf16 elements a shared row of a D-wide tile: 16 bytes of pad, so the 8
// rows one ldmatrix phase reads start in 8 distinct 16-byte bank groups.
template <int D>
__host__ __device__ constexpr int tc_stride() { return D + 8; }

// Which kernel a launch takes for its dtype codes (0 = float32,
// 1 = bfloat16): 1, the tensor-core kernel, for bf16 in with either output
// (every flash kernel's tensor-core instances store bf16 or f32; the f32
// ones are checked by tools/flash_rounding.py); 0, the CUDA-core kernel, for
// f32 in (the tensor cores take bf16 operands).
inline int tc_route(int in_dtype, int out_dtype) {
  return in_dtype == 1 && (out_dtype == 0 || out_dtype == 1);
}

// 1/sqrt(D), and the q fold log2(e)/sqrt(D), in double, as the JAX
// wrapper computes them (each rounded to f32 once by its caller).
template <int D>
inline double rsqrt_d() { return 1.0 / std::sqrt(static_cast<double>(D)); }

template <int D>
inline float fold_scale() { return static_cast<float>(rsqrt_d<D>() * 1.4426950408889634); }

// Eight bf16 of q (one 16-byte chunk) folded: each times qc (the fold
// scale already rounded to bf16) and rounded to bf16, as the JAX fold.
__device__ __forceinline__ uint4 fold8(uint4 raw, float qc) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(h[e]);
    h[e] = __floats2bfloat162_rn(f.x * qc, f.y * qc);
  }
  return raw;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a.b for one 16x8 f32 tile.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 rounded to bf16 (round to nearest even), lo in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two neighbouring outputs (an accumulator's c0, c1 or c2, c3) stored at
// p: rounded to bf16 as pack_bf16 rounds them, or as they are in f32.
// p must be 4-byte (bf16) or 8-byte (f32) aligned.
__device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}
__device__ __forceinline__ void store2(float* p, float lo, float hi) {
  *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src must still
// be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, or zero when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

}  // namespace dtx

// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernel
// distributed_tensorflow_examples_tpu/ops/flash_attention.py::_fwd_kernel
// (called through _fwd / fwd_call).  Same contract: q, k, v [BH, T, D];
// o = softmax(q.k^T / sqrt(D)).v in the input dtype or f32; lse [BH, T] f32
// in natural log.  q is scaled ONCE by log2(e)/sqrt(D), rounded to the
// input precision as the JAX fold does; the online softmax runs in base 2
// (exp2) with f32 running max m, running sum l and accumulator; lse =
// m*ln2 + log(l).  Scores that are masked take the finite -1e30 and
// contribute exactly 0; p is rounded to the input precision before the
// p.v product (the JAX kernel casts p to v's dtype for the MXU).
//
// What bounds it.  At the flagship shape (BH = 8 per row, T = 2048,
// D = 128, bf16, causal) one call does 2*BH*T^2*D = 8.59 GFLOP (the two
// products over the causal half), 8.7 us at 989 TFLOP/s bf16, and moves
// 16.8 MB of q/k/v/o, 5.0 us at 3.35 TB/s: compute-bound.
//
// Design (the first, simple one; tensor cores come later).
// - One block of 256 threads per (bh, 64-row q tile); the q tile lives in
//   shared memory (transposed) for the whole loop, so q is read from device
//   memory once.  Two blocks fit on an SM at D = 128.
// - A loop over 64-row k/v tiles staged in shared memory as f32, the
//   sequential k dimension of the TPU grid turned into a loop in the block.
// - Causal: tiles above the diagonal are never visited (the loop stops at
//   the diagonal tile); only the diagonal tile and a ragged last tile are
//   masked.  Any T works: the ragged edge is masked, never padded.
// - Products on the CUDA cores in f32 (4x4 register tiles per thread for
//   q.k^T, 4 rows x D/16 columns of the accumulator per thread for p.v),
//   so the kernel runs far below its bound: shared-memory loads, not the
//   tensor cores, limit it.  wgmma/mma.sync, TMA and warp specialisation
//   are the next steps for speed.
// - Heavy causal tiles (high q tile index) are scheduled first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T's precision and widened back.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// At D = 128 this is 115,712 bytes: two blocks fill an SM's 228 KB
// exactly (with the 1 KB each block reserves), so the layout has no slack.
template <int D>
constexpr size_t smem_floats() {
  return size_t(D) * kBlockQ                // q tile, transposed
         + size_t(kBlockK) * (D + 1)        // k tile, padded rows
         + size_t(kBlockK) * D              // v tile
         + size_t(kBlockQ) * (kBlockK + 1)  // scores; the pad column holds alpha
         + 2 * size_t(kBlockQ);             // m, l per row
}

template <typename Tin, typename Tout, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                 const Tin* __restrict__ v, Tout* __restrict__ o,
                 float* __restrict__ lse, int t, int causal, float qscale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kDp = D + 1;        // k row stride: no bank conflicts in q.k^T
  constexpr int kSp = kBlockK + 1;  // score row stride; column kBlockK is alpha
  constexpr int kCols = D / 16;     // accumulator columns per thread

  extern __shared__ float smem[];
  float* qt = smem;  // [D][kBlockQ]: the two half-warps' rows hit two banks
  float* ks = qt + D * kBlockQ;
  float* vs = ks + kBlockK * kDp;
  float* ss = vs + kBlockK * D;
  float* m_s = ss + kBlockQ * kSp;
  float* l_s = m_s + kBlockQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.x;
  const int nq = gridDim.y;
  const int qi = nq - 1 - static_cast<int>(blockIdx.y);  // heavy tiles first
  const int q0 = qi * kBlockQ;
  const size_t base = static_cast<size_t>(bh) * t * D;

  // The q tile, scaled once in the input precision (the JAX fold).
  const float qc = round_to<Tin>(qscale);
  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, c = i % D, row = q0 + r;
    const float x = row < t ? to_f32(q[base + static_cast<size_t>(row) * D + c]) : 0.f;
    qt[c * kBlockQ + r] = round_to<Tin>(x * qc);
  }
  if (tid < kBlockQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  const int nk = (t + kBlockK - 1) / kBlockK;
  const int k_end = causal ? min(nk, qi + 1) : nk;  // never above the diagonal
  for (int kj = 0; kj < k_end; ++kj) {
    const int k0 = kj * kBlockK;
    __syncthreads();  // the previous tile's reads of ks/vs/ss are done
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, c = i % D, row = k0 + r;
      const bool in = row < t;
      const size_t off = base + static_cast<size_t>(row) * D + c;
      ks[r * kDp + c] = in ? to_f32(k[off]) : 0.f;
      vs[r * D + c] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    // s = q.k^T (base-2 logits): rows ty + 16*i, columns tx + 16*j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qt[c * kBlockQ + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + 16 * j) * kDp + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
    // Only the diagonal tile and a ragged last tile carry masked scores.
    const bool masked = (causal && kj == qi) || (k0 + kBlockK > t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float x = s[i][j];
        if (masked) {
          const int kpos = k0 + c;
          if (kpos >= t || (causal && kpos > q0 + r)) x = kNegInf;
        }
        ss[r * kSp + c] = x;
      }
    __syncthreads();

    // Online softmax: four neighbouring lanes per row, 16 columns each.
    {
      const int r = tid / 4, part = tid % 4;
      float* srow = ss + r * kSp + part * 16;
      const float m_prev = m_s[r];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float x = srow[c];
        float p = exp2f(x - m_new);
        if (masked && !(x > 0.5f * kNegInf)) p = 0.f;  // fully masked rows add 0
        sum += p;
        srow[c] = round_to<Tin>(p);  // p enters p.v in v's precision
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {  // every lane of the row read m_prev before the shuffles
        const float alpha = exp2f(m_prev - m_new);
        ss[r * kSp + kBlockK] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p.v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = ss[(ty + 16 * i) * kSp + kBlockK];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty + 16 * i) * kSp + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = vs[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i, row = q0 + r;
    if (row >= t) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
    Tout* orow = o + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) orow[tx + 16 * j] = from_f32<Tout>(acc[i][j] / l);
    if (tx == 0) lse[static_cast<size_t>(bh) * t + row] = m_s[r] * kLn2 + logf(l);
  }
}

template <typename Tin, typename Tout, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, void* lse,
                   int bh, int t, int causal, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kernel = flash_fwd_kernel<Tin, Tout, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t + kBlockQ - 1) / kBlockQ);
  // (1/sqrt(D)) * log2(e) in double, as the JAX wrapper computes it.
  const float qscale =
      static_cast<float>((1.0 / std::sqrt(static_cast<double>(D))) * 1.4426950408889634);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Tin*>(q), static_cast<const Tin*>(k), static_cast<const Tin*>(v),
      static_cast<Tout*>(o), static_cast<float*>(lse), t, causal, qscale);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, void* lse,
                     int bh, int t, int d, int causal, cudaStream_t stream) {
  switch (d) {
    case 32: return launch<Tin, Tout, 32>(q, k, v, o, lse, bh, t, causal, stream);
    case 64: return launch<Tin, Tout, 64>(q, k, v, o, lse, bh, t, causal, stream);
    case 128: return launch<Tin, Tout, 128>(q, k, v, o, lse, bh, t, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  Returns the launch's
// cudaError_t (0 = success); the caller raises on anything else.
extern "C" int dtx_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int bh, int t, int d, int in_dtype,
                             int out_dtype, int causal, void* stream) {
  if (bh < 1 || t < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0 && out_dtype == 0)
    return launch_d<float, float>(q, k, v, o, lse, bh, t, d, causal, s);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_d<__nv_bfloat16, __nv_bfloat16>(q, k, v, o, lse, bh, t, d, causal, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_d<__nv_bfloat16, float>(q, k, v, o, lse, bh, t, d, causal, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_d<float, __nv_bfloat16>(q, k, v, o, lse, bh, t, d, causal, s);
  return cudaErrorInvalidValue;
}

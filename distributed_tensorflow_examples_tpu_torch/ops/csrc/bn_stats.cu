// BatchNorm statistics for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of
// distributed_tensorflow_examples_tpu/ops/bn.py:
// - _stats_kernel (bn_stats): per-channel sum(x) and sum(x*x) in f32, one
//   pass over x;
// - _bwd_stats_kernel (bn_bwd_stats): s1 = sum(dy) and s2 = sum(dy*xhat)
//   with xhat = (x - mean) * inv and, when relu is set,
//   dy = do * [xhat*scale + bias > 0] recomputed here in f32, so the masked
//   gradient never exists in device memory (the reason the TPU kernel
//   exists).  Without relu dy = do.
//
// Layout.  The activation is [M, C] row-major, M = N*H*W: the memory of a
// contiguous NHWC tensor and of a channels_last NCHW one.  The wrapper
// refuses anything else (no hidden copy).
//
// What bounds it.  Each element is read once and costs a few f32
// operations, so both are bound by device memory: at the ResNet-50 stem
// [256, 112, 112, 64] bf16 the forward reads 411 MB (0.123 ms at
// 3.35 TB/s), the backward 822 MB (0.245 ms).
//
// Design (simple first; the TPU's (bn, bh, W, C) VMEM blocking is not
// carried over).
// - Pass 1: a block of 256 threads owns a strip of channels and a range of
//   rows.  Threads along the strip read neighbouring channels, VEC at a
//   time (16-byte loads when C and the pointers allow: 8 bf16 or 4 f32),
//   so a warp reads whole contiguous rows; threads across the strip take
//   every ty_n-th row of the range, four rows per iteration with the loads
//   issued first.  Sums stay in f32 registers, then the block combines its
//   row lanes in shared memory in a fixed order and writes one partial per
//   channel to an [S, C] f32 workspace (S = row ranges).
// - Pass 2: one thread per (channel, lane) sums every 8th partial, and
//   the 8 lanes combine in a fixed order.  No atomics anywhere, so a run
//   gives the same bits as the last one.
// - Any M and any C: the ragged channel strip is masked, VEC falls back to
//   1 where C is not a multiple of it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kFinalLanes = 8;
constexpr int kFinalChannels = kThreads / kFinalLanes;  // 32
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// VEC consecutive elements at p, widened to f32 (p is 16-byte aligned
// when VEC > 1: the wrapper checks).  A bf16 widens exactly by moving its
// 16 bits to the top of an f32; element 2i is the low half of word i.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_f32(p[0]);
  } else {
    static_assert(sizeof(T) * VEC == 16, "vector loads are 16 bytes");
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (sizeof(T) == 4) {
        out[i] = __uint_as_float(w[i]);
      } else {
        out[2 * i] = __uint_as_float(w[i] << 16);
        out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    }
  }
}

// The block's two sets of per-thread sums -> one partial per channel of
// its strip in ws[0][split][c] and ws[1][split][c], row lanes added in
// order 0, 1, ..., ty_n-1.
template <int VEC>
__device__ __forceinline__ void write_partials(const float (&a)[VEC], const float (&b)[VEC],
                                               float* __restrict__ ws, int c, int splits,
                                               int tx, int ty, int tx_n, int ty_n,
                                               int strip_c0) {
  __shared__ float red[2][kThreads * VEC];
  const int w = tx_n * VEC;  // channels in the strip
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    red[0][ty * w + tx * VEC + i] = a[i];
    red[1][ty * w + tx * VEC + i] = b[i];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < w; j += kThreads) {
    const int ch = strip_c0 + j;
    if (ch >= c) continue;
    float sa = 0.f, sb = 0.f;
    for (int r = 0; r < ty_n; ++r) {
      sa += red[0][r * w + j];
      sb += red[1][r * w + j];
    }
    const size_t at = static_cast<size_t>(blockIdx.y) * c + ch;
    ws[at] = sa;
    ws[static_cast<size_t>(splits) * c + at] = sb;
  }
}

// B6, pass 1: partial sum(x) and sum(x*x) of one (channel strip, row range).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bn_stats_partial(const T* __restrict__ x, float* __restrict__ ws, long long m, int c,
                 int tx_n, long long rows_per_split) {
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n, ty_n = kThreads / tx_n;
  const int strip_c0 = blockIdx.x * tx_n * VEC;
  const int c0 = strip_c0 + tx * VEC;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long r1 = r0 + rows_per_split < m ? r0 + rows_per_split : m;
  float s[VEC], ss[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = ss[i] = 0.f;
  if (c0 < c) {
    long long r = r0 + ty;
    for (; r + (kUnroll - 1) * ty_n < r1; r += kUnroll * ty_n) {
      float v[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load_vec<T, VEC>(x + (r + u * ty_n) * c + c0, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          s[i] += v[u][i];
          ss[i] = fmaf(v[u][i], v[u][i], ss[i]);
        }
      }
    }
    for (; r < r1; r += ty_n) {
      float v[VEC];
      load_vec<T, VEC>(x + r * c + c0, v);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        s[i] += v[i];
        ss[i] = fmaf(v[i], v[i], ss[i]);
      }
    }
  }
  write_partials<VEC>(s, ss, ws, c, gridDim.y, tx, ty, tx_n, ty_n, strip_c0);
}

// B7, pass 1: partial s1 = sum(dy) and s2 = sum(dy*xhat) of one (channel
// strip, row range); dy = do * [xhat*scale + bias > 0] when RELU.
template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(kThreads)
bn_bwd_stats_partial(const T* __restrict__ dout, const T* __restrict__ x,
                     const float* __restrict__ mean, const float* __restrict__ inv,
                     const float* __restrict__ scale, const float* __restrict__ bias,
                     float* __restrict__ ws, long long m, int c, int tx_n,
                     long long rows_per_split) {
  const int tx = threadIdx.x % tx_n, ty = threadIdx.x / tx_n, ty_n = kThreads / tx_n;
  const int strip_c0 = blockIdx.x * tx_n * VEC;
  const int c0 = strip_c0 + tx * VEC;
  const long long r0 = static_cast<long long>(blockIdx.y) * rows_per_split;
  const long long r1 = r0 + rows_per_split < m ? r0 + rows_per_split : m;
  float s1[VEC], s2[VEC], mu[VEC], iv[VEC], sc[VEC], bi[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    s1[i] = s2[i] = 0.f;
    mu[i] = iv[i] = sc[i] = bi[i] = 0.f;
  }
  if (c0 < c) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      mu[i] = mean[c0 + i];
      iv[i] = inv[c0 + i];
      if (RELU) {
        sc[i] = scale[c0 + i];
        bi[i] = bias[c0 + i];
      }
    }
    auto add = [&](const float (&dv)[VEC], const float (&xv)[VEC]) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float xh = (xv[i] - mu[i]) * iv[i];
        float d = dv[i];
        if (RELU) d = d * (xh * sc[i] + bi[i] > 0.f ? 1.f : 0.f);
        s1[i] += d;
        s2[i] = fmaf(d, xh, s2[i]);
      }
    };
    long long r = r0 + ty;
    for (; r + (kUnroll - 1) * ty_n < r1; r += kUnroll * ty_n) {
      float dv[kUnroll][VEC], xv[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long off = (r + u * ty_n) * c + c0;
        load_vec<T, VEC>(dout + off, dv[u]);
        load_vec<T, VEC>(x + off, xv[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add(dv[u], xv[u]);
    }
    for (; r < r1; r += ty_n) {
      float dv[VEC], xv[VEC];
      load_vec<T, VEC>(dout + r * c + c0, dv);
      load_vec<T, VEC>(x + r * c + c0, xv);
      add(dv, xv);
    }
  }
  write_partials<VEC>(s1, s2, ws, c, gridDim.y, tx, ty, tx_n, ty_n, strip_c0);
}

// Pass 2 of both: out_a[ch] = sum over splits of ws[0][.][ch], out_b from
// ws[1]; lane l adds splits l, l+8, ..., then the 8 lanes in order.
__global__ void __launch_bounds__(kThreads)
bn_stats_finalize(const float* __restrict__ ws, float* __restrict__ out_a,
                  float* __restrict__ out_b, int splits, int c) {
  __shared__ float ra[kFinalLanes][kFinalChannels], rb[kFinalLanes][kFinalChannels];
  const int lane = threadIdx.x / kFinalChannels, j = threadIdx.x % kFinalChannels;
  const int ch = blockIdx.x * kFinalChannels + j;
  float a = 0.f, b = 0.f;
  if (ch < c) {
    const float* wa = ws + ch;
    const float* wb = ws + static_cast<size_t>(splits) * c + ch;
#pragma unroll 4
    for (int s = lane; s < splits; s += kFinalLanes) {
      a += wa[static_cast<size_t>(s) * c];
      b += wb[static_cast<size_t>(s) * c];
    }
  }
  ra[lane][j] = a;
  rb[lane][j] = b;
  __syncthreads();
  if (lane == 0 && ch < c) {
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int l = 0; l < kFinalLanes; ++l) {
      sa += ra[l][j];
      sb += rb[l][j];
    }
    out_a[ch] = sa;
    out_b[ch] = sb;
  }
}

// The launch geometry the wrapper chose, checked before anything runs.
bool bad_shape(long long m, int c, int vec, int tx_n, int splits, long long rows_per_split) {
  if (m < 1 || c < 1 || splits < 1 || splits > 65535 || rows_per_split < 1) return true;
  if (tx_n < 1 || tx_n > 32 || (tx_n & (tx_n - 1)) != 0) return true;
  if (c % vec != 0) return true;
  return rows_per_split * splits < m;
}

cudaError_t finalize(const float* ws, void* out_a, void* out_b, int splits, int c,
                     cudaStream_t stream) {
  const int blocks = (c + kFinalChannels - 1) / kFinalChannels;
  bn_stats_finalize<<<blocks, kThreads, 0, stream>>>(ws, static_cast<float*>(out_a),
                                                     static_cast<float*>(out_b), splits, c);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t stats(const void* x, void* ws, void* out_s, void* out_ss, long long m, int c,
                  int tx_n, int splits, long long rows_per_split, cudaStream_t stream) {
  const int strips = (c + tx_n * VEC - 1) / (tx_n * VEC);
  bn_stats_partial<T, VEC><<<dim3(strips, splits), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(ws), m, c, tx_n, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return finalize(static_cast<const float*>(ws), out_s, out_ss, splits, c, stream);
}

template <typename T, int VEC, bool RELU>
cudaError_t bwd_stats(const void* dout, const void* x, const void* mean, const void* inv,
                      const void* scale, const void* bias, void* ws, void* s1, void* s2,
                      long long m, int c, int tx_n, int splits, long long rows_per_split,
                      cudaStream_t stream) {
  const int strips = (c + tx_n * VEC - 1) / (tx_n * VEC);
  bn_bwd_stats_partial<T, VEC, RELU><<<dim3(strips, splits), kThreads, 0, stream>>>(
      static_cast<const T*>(dout), static_cast<const T*>(x), static_cast<const float*>(mean),
      static_cast<const float*>(inv), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<float*>(ws), m, c, tx_n, rows_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return finalize(static_cast<const float*>(ws), s1, s2, splits, c, stream);
}

template <typename T, int VEC>
cudaError_t bwd_stats_relu(int relu, const void* dout, const void* x, const void* mean,
                           const void* inv, const void* scale, const void* bias, void* ws,
                           void* s1, void* s2, long long m, int c, int tx_n, int splits,
                           long long rows_per_split, cudaStream_t stream) {
  if (relu)
    return bwd_stats<T, VEC, true>(dout, x, mean, inv, scale, bias, ws, s1, s2, m, c, tx_n,
                                   splits, rows_per_split, stream);
  return bwd_stats<T, VEC, false>(dout, x, mean, inv, scale, bias, ws, s1, s2, m, c, tx_n,
                                  splits, rows_per_split, stream);
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16.  vec: 1, or 16 bytes' worth of
// the dtype (4 float32, 8 bfloat16).  ws: f32 [2, splits, c] scratch.
// out_s, out_ss: f32 [c].  Returns the launches' cudaError_t (0 = success);
// the caller raises on anything else.
extern "C" int dtx_bn_stats(const void* x, void* ws, void* out_s, void* out_ss, long long m,
                            int c, int dtype, int vec, int tx_n, int splits,
                            long long rows_per_split, void* stream) {
  if (bad_shape(m, c, vec, tx_n, splits, rows_per_split)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 1)
    return stats<float, 1>(x, ws, out_s, out_ss, m, c, tx_n, splits, rows_per_split, s);
  if (dtype == 0 && vec == 4)
    return stats<float, 4>(x, ws, out_s, out_ss, m, c, tx_n, splits, rows_per_split, s);
  if (dtype == 1 && vec == 1)
    return stats<__nv_bfloat16, 1>(x, ws, out_s, out_ss, m, c, tx_n, splits, rows_per_split, s);
  if (dtype == 1 && vec == 8)
    return stats<__nv_bfloat16, 8>(x, ws, out_s, out_ss, m, c, tx_n, splits, rows_per_split, s);
  return cudaErrorInvalidValue;
}

// do and x share the dtype and the [m, c] layout; mean, inv, scale, bias
// are f32 [c]; s1, s2 f32 [c].  Other arguments as for dtx_bn_stats.
extern "C" int dtx_bn_bwd_stats(const void* dout, const void* x, const void* mean,
                                const void* inv, const void* scale, const void* bias, void* ws,
                                void* s1, void* s2, long long m, int c, int dtype, int vec,
                                int tx_n, int splits, long long rows_per_split, int relu,
                                void* stream) {
  if (bad_shape(m, c, vec, tx_n, splits, rows_per_split)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 1)
    return bwd_stats_relu<float, 1>(relu, dout, x, mean, inv, scale, bias, ws, s1, s2, m, c,
                                    tx_n, splits, rows_per_split, s);
  if (dtype == 0 && vec == 4)
    return bwd_stats_relu<float, 4>(relu, dout, x, mean, inv, scale, bias, ws, s1, s2, m, c,
                                    tx_n, splits, rows_per_split, s);
  if (dtype == 1 && vec == 1)
    return bwd_stats_relu<__nv_bfloat16, 1>(relu, dout, x, mean, inv, scale, bias, ws, s1, s2,
                                            m, c, tx_n, splits, rows_per_split, s);
  if (dtype == 1 && vec == 8)
    return bwd_stats_relu<__nv_bfloat16, 8>(relu, dout, x, mean, inv, scale, bias, ws, s1, s2,
                                            m, c, tx_n, splits, rows_per_split, s);
  return cudaErrorInvalidValue;
}

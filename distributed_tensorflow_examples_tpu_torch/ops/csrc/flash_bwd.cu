// Flash-attention backward for Hopper (sm_90a), with a plain C interface:
// two kernels, dq and dk/dv, the split backward of the JAX package.
//
// Replace the Pallas TPU kernels
// distributed_tensorflow_examples_tpu/ops/flash_attention.py::_dq_kernel
// (called through dq_call) and ::_dkv_kernel (called through dkv_call).
// Same contract: q, k, v, do [BH, T, D] in one dtype; lse and delta
// [BH, T] f32 (lse in natural log from the forward, delta = rowsum(do*o)).
// q is scaled ONCE by log2(e)/sqrt(D) and rounded to the input precision,
// as the JAX fold does, so s = q.k^T is a base-2 logit; lse2 = lse*log2(e);
// p = exp2(s - lse2), with masked scores at the finite -1e30 and
// p = 0 where a score was masked; ds = p*(do.v^T - delta).  The operand
// casts of the JAX products are kept: p is rounded to do's precision for
// dv = p^T.do, ds to k's for dq = ds.k and to q's for dk = ds^T.q.  Sums
// are f32.  dq is multiplied by 1/sqrt(D) at the end; dk, accumulated
// against the pre-scaled q, is multiplied by 1/log2(e) at the end.
//
// What bounds them.  At the training path's shape (BH = 64, T = 2048,
// D = 128, bf16, causal) dq does three products over the causal half,
// 3*2*BH*T^2/2*D = 103 GFLOP (0.104 ms at 989 TFLOP/s bf16), and dk/dv
// four, 137 GFLOP (0.139 ms); each moves under 0.2 GB (< 0.06 ms at
// 3.35 TB/s): compute-bound.
//
// Design (the first, simple one; tensor cores come later).
// - dq: one block of 256 threads per (bh, 64-row q tile).  The q tile
//   (scaled) and the do tile stay in shared memory, transposed, for the
//   whole loop over 64-row k/v tiles; the loop stops at the diagonal tile
//   when causal.  The dq accumulator (64 x D f32) lives in registers,
//   4 rows x D/16 columns per thread.  Heavy (late) q tiles launch first.
// - dk/dv: one block per (bh, 64-row k tile).  The k and v tiles stay in
//   shared memory; the loop over q tiles STARTS at the diagonal tile when
//   causal (the mirror of dq's bound).  The two accumulators (2 x 64 x D
//   f32: 64 KB at D = 128) live in registers, so shared memory holds only
//   the four f32 operand tiles and the p^T / ds^T tiles (165,888 bytes at
//   D = 128, under the 227 KB a block may opt into).  Heavy (early) k
//   tiles launch first.
// - No atomics: each output row is written by exactly one block, so both
//   kernels give the same bits run to run.
// - Only the diagonal tile and ragged edge tiles are masked; any T works
//   (the ragged edge is masked, never padded).
// - Products on the CUDA cores in f32 (4x4 register tiles per thread),
//   limited by shared-memory loads, far below the bound.  wgmma/mma.sync,
//   TMA and warp specialisation are the next steps for speed.
// - nvcc -Xptxas -v for sm_90a: 96 (dq) and 126 (dk/dv) registers a thread
//   at D = 128, 79 and 96 at D = 64, 64 and 80 at D = 32; no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kBlock = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;
constexpr double kLog2eD = 1.4426950408889634;

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

// 148,736 bytes at D = 128: one block per SM.
template <int D>
constexpr size_t dq_smem_floats() {
  return 2 * size_t(D) * kBlock            // q (scaled) and do tiles, transposed
         + 2 * size_t(kBlock) * (D + 1)    // k and v tiles, padded rows
         + size_t(kBlock) * (kBlock + 1)   // ds tile
         + 2 * size_t(kBlock);             // lse2, delta per q row
}

// 165,888 bytes at D = 128: one block per SM.
template <int D>
constexpr size_t dkv_smem_floats() {
  return 4 * size_t(kBlock) * (D + 1)      // k, v, q (scaled), do tiles
         + 2 * size_t(kBlock) * (kBlock + 1)  // p^T and ds^T tiles
         + 2 * size_t(kBlock);             // lse2, delta per q row
}

template <typename Tin, typename Tout, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                const Tin* __restrict__ v, const Tin* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                Tout* __restrict__ dq, int t, int causal, float qscale, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kDp = D + 1;       // k/v row stride: no bank conflicts
  constexpr int kSp = kBlock + 1;  // ds row stride
  constexpr int kCols = D / 16;    // accumulator columns per thread

  extern __shared__ float smem[];
  float* qt = smem;                 // [D][kBlock]
  float* dot = qt + D * kBlock;     // [D][kBlock]
  float* ks = dot + D * kBlock;     // [kBlock][kDp]
  float* vs = ks + kBlock * kDp;    // [kBlock][kDp]
  float* dss = vs + kBlock * kDp;   // [kBlock][kSp]
  float* lse2_s = dss + kBlock * kSp;
  float* delta_s = lse2_s + kBlock;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.x;
  const int nq = gridDim.y;
  const int qi = nq - 1 - static_cast<int>(blockIdx.y);  // heavy tiles first
  const int q0 = qi * kBlock;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const size_t row_base = static_cast<size_t>(bh) * t;

  const float qc = round_to<Tin>(qscale);
  for (int i = tid; i < kBlock * D; i += kThreads) {
    const int r = i / D, c = i % D, row = q0 + r;
    const bool in = row < t;
    const size_t off = base + static_cast<size_t>(row) * D + c;
    qt[c * kBlock + r] = in ? round_to<Tin>(to_f32(q[off]) * qc) : 0.f;
    dot[c * kBlock + r] = in ? to_f32(dout[off]) : 0.f;
  }
  if (tid < kBlock) {
    const int row = q0 + tid;
    const bool in = row < t;
    lse2_s[tid] = in ? lse[row_base + row] * static_cast<float>(kLog2eD) : 0.f;
    delta_s[tid] = in ? delta[row_base + row] : 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  const int nk = (t + kBlock - 1) / kBlock;
  const int k_end = causal ? min(nk, qi + 1) : nk;  // stop at the diagonal
  for (int kj = 0; kj < k_end; ++kj) {
    const int k0 = kj * kBlock;
    __syncthreads();  // the previous tile's reads of ks/vs/dss are done
    for (int i = tid; i < kBlock * D; i += kThreads) {
      const int r = i / D, c = i % D, row = k0 + r;
      const bool in = row < t;
      const size_t off = base + static_cast<size_t>(row) * D + c;
      ks[r * kDp + c] = in ? to_f32(k[off]) : 0.f;
      vs[r * kDp + c] = in ? to_f32(v[off]) : 0.f;
    }
    __syncthreads();

    // s = q.k^T (base-2 logits) and dp = do.v^T: rows ty + 16*i,
    // columns tx + 16*j.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a[4], g[4], b[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = qt[c * kBlock + ty + 16 * i];
        g[i] = dot[c * kBlock + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = ks[(tx + 16 * j) * kDp + c];
        w[j] = vs[(tx + 16 * j) * kDp + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }
    // Only the diagonal tile and a ragged last tile carry masked scores.
    const bool masked = (causal && kj == qi) || (k0 + kBlock > t);
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
        float p = exp2f(x - lse2_s[r]);
        if (masked && !(x > 0.5f * kNegInf)) p = 0.f;
        const float ds = p * (dp[i][j] - delta_s[r]);
        dss[r * kSp + c] = round_to<Tin>(ds);  // ds enters ds.k in k's precision
      }
    __syncthreads();

    // dq += ds.k
#pragma unroll 4
    for (int c = 0; c < kBlock; ++c) {
      float d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] = dss[(ty + 16 * i) * kSp + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float kk = ks[c * kDp + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(d[i], kk, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
    Tout* out = dq + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) out[tx + 16 * j] = from_f32<Tout>(acc[i][j] * scale);
  }
}

template <typename Tin, typename Tout, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                 const Tin* __restrict__ v, const Tin* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 Tout* __restrict__ dk, Tout* __restrict__ dv, int t, int causal,
                 float qscale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kDp = D + 1;
  constexpr int kSp = kBlock + 1;
  constexpr int kCols = D / 16;

  extern __shared__ float smem[];
  float* ks = smem;                 // [kBlock][kDp], this block's k rows
  float* vs = ks + kBlock * kDp;
  float* qs = vs + kBlock * kDp;    // the visiting q tile (scaled)
  float* dos = qs + kBlock * kDp;   // the visiting do tile
  float* pts = dos + kBlock * kDp;  // p^T [k row][q row]
  float* dsts = pts + kBlock * kSp; // ds^T [k row][q row]
  float* lse2_s = dsts + kBlock * kSp;
  float* delta_s = lse2_s + kBlock;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.x;
  const int kj = blockIdx.y;  // causal: early k tiles see the most q tiles
  const int k0 = kj * kBlock;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const size_t row_base = static_cast<size_t>(bh) * t;

  for (int i = tid; i < kBlock * D; i += kThreads) {
    const int r = i / D, c = i % D, row = k0 + r;
    const bool in = row < t;
    const size_t off = base + static_cast<size_t>(row) * D + c;
    ks[r * kDp + c] = in ? to_f32(k[off]) : 0.f;
    vs[r * kDp + c] = in ? to_f32(v[off]) : 0.f;
  }

  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  const float qc = round_to<Tin>(qscale);
  const int nq = (t + kBlock - 1) / kBlock;
  const int q_begin = causal ? kj : 0;  // start at the diagonal
  for (int qi = q_begin; qi < nq; ++qi) {
    const int q0 = qi * kBlock;
    __syncthreads();  // the previous tile's reads of qs/dos/pts/dsts are done
    for (int i = tid; i < kBlock * D; i += kThreads) {
      const int r = i / D, c = i % D, row = q0 + r;
      const bool in = row < t;
      const size_t off = base + static_cast<size_t>(row) * D + c;
      qs[r * kDp + c] = in ? round_to<Tin>(to_f32(q[off]) * qc) : 0.f;
      dos[r * kDp + c] = in ? to_f32(dout[off]) : 0.f;
    }
    if (tid < kBlock) {
      const int row = q0 + tid;
      const bool in = row < t;
      lse2_s[tid] = in ? lse[row_base + row] * static_cast<float>(kLog2eD) : 0.f;
      delta_s[tid] = in ? delta[row_base + row] : 0.f;
    }
    __syncthreads();

    // s^T = k.q^T and dp^T = v.do^T: k rows ty + 16*i, q rows tx + 16*j.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a[4], g[4], b[4], w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = ks[(ty + 16 * i) * kDp + c];
        g[i] = vs[(ty + 16 * i) * kDp + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = qs[(tx + 16 * j) * kDp + c];
        w[j] = dos[(tx + 16 * j) * kDp + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], b[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }
    // The diagonal tile and ragged q or k tiles carry masked scores.
    const bool masked =
        (causal && qi == kj) || (q0 + kBlock > t) || (k0 + kBlock > t);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = ty + 16 * i, c = tx + 16 * j;
        float x = s[i][j];
        if (masked) {
          const int kpos = k0 + r, qpos = q0 + c;
          if (qpos >= t || kpos >= t || (causal && kpos > qpos)) x = kNegInf;
        }
        float p = exp2f(x - lse2_s[c]);
        if (masked && !(x > 0.5f * kNegInf)) p = 0.f;
        pts[r * kSp + c] = round_to<Tin>(p);  // p enters p^T.do in do's precision
        const float ds = p * (dp[i][j] - delta_s[c]);
        dsts[r * kSp + c] = round_to<Tin>(ds);  // ds enters ds^T.q in q's precision
      }
    __syncthreads();

    // dv += p^T.do, dk += ds^T.q
#pragma unroll 2
    for (int c = 0; c < kBlock; ++c) {
      float pp[4], dd[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pp[i] = pts[(ty + 16 * i) * kSp + c];
        dd[i] = dsts[(ty + 16 * i) * kSp + c];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float oo = dos[c * kDp + tx + 16 * j];
        const float qq = qs[c * kDp + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][j] = fmaf(pp[i], oo, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(dd[i], qq, dk_acc[i][j]);
        }
      }
    }
  }

  const float inv_log2e = static_cast<float>(1.0 / kLog2eD);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= t) continue;
    const size_t off = base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      dk[off + tx + 16 * j] = from_f32<Tout>(dk_acc[i][j] * inv_log2e);
      dv[off + tx + 16 * j] = from_f32<Tout>(dv_acc[i][j]);
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

// (1/sqrt(D)) * log2(e) in double, as the JAX wrapper computes it.
template <int D>
float qscale_of() {
  return static_cast<float>((1.0 / std::sqrt(static_cast<double>(D))) * kLog2eD);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;
  int bh, t, causal;
  cudaStream_t stream;
};

template <typename Tin, typename Tout, int D>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  auto kernel = flash_dq_kernel<Tin, Tout, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.t + kBlock - 1) / kBlock);
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(D)));
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const Tin*>(a.q), static_cast<const Tin*>(a.k),
      static_cast<const Tin*>(a.v), static_cast<const Tin*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<Tout*>(a.out0), a.t, a.causal, qscale_of<D>(), scale);
  return cudaGetLastError();
}

template <typename Tin, typename Tout, int D>
cudaError_t launch_dkv(const Args& a) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  auto kernel = flash_dkv_kernel<Tin, Tout, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.t + kBlock - 1) / kBlock);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const Tin*>(a.q), static_cast<const Tin*>(a.k),
      static_cast<const Tin*>(a.v), static_cast<const Tin*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<Tout*>(a.out0), static_cast<Tout*>(a.out1), a.t, a.causal,
      qscale_of<D>());
  return cudaGetLastError();
}

template <bool kDq, typename Tin, typename Tout>
cudaError_t launch_d(const Args& a, int d) {
  switch (d) {
    case 32: return kDq ? launch_dq<Tin, Tout, 32>(a) : launch_dkv<Tin, Tout, 32>(a);
    case 64: return kDq ? launch_dq<Tin, Tout, 64>(a) : launch_dkv<Tin, Tout, 64>(a);
    case 128: return kDq ? launch_dq<Tin, Tout, 128>(a) : launch_dkv<Tin, Tout, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool kDq>
int dispatch(const Args& a, int d, int in_dtype, int out_dtype) {
  if (a.bh < 1 || a.t < 1) return cudaErrorInvalidValue;
  if (in_dtype == 0 && out_dtype == 0) return launch_d<kDq, float, float>(a, d);
  if (in_dtype == 1 && out_dtype == 1)
    return launch_d<kDq, __nv_bfloat16, __nv_bfloat16>(a, d);
  if (in_dtype == 1 && out_dtype == 0) return launch_d<kDq, __nv_bfloat16, float>(a, d);
  if (in_dtype == 0 && out_dtype == 1) return launch_d<kDq, float, __nv_bfloat16>(a, d);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and do share in_dtype).
// Each returns the launch's cudaError_t (0 = success); the caller raises
// on anything else.
extern "C" int dtx_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, int bh, int t,
                            int d, int in_dtype, int out_dtype, int causal,
                            void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, bh, t, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch<true>(a, d, in_dtype, out_dtype);
}

extern "C" int dtx_flash_dkv(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse, const void* delta,
                             void* dk, void* dv, int bh, int t, int d, int in_dtype,
                             int out_dtype, int causal, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, bh, t, causal,
               static_cast<cudaStream_t>(stream)};
  return dispatch<false>(a, d, in_dtype, out_dtype);
}

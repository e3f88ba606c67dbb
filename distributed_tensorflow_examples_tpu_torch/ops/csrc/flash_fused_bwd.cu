// Fused flash-attention backward for Hopper (sm_90a), with a plain C
// interface: dq, dk and dv from ONE s/p computation per tile pair.
//
// Replaces the Pallas TPU kernel
// distributed_tensorflow_examples_tpu/ops/flash_attention.py::_fused_bwd_kernel
// (called through fused_bwd_call).  Same contract as the split kernels of
// flash_bwd.cu: q, k, v, do [BH, T, D] in one dtype; lse and delta [BH, T]
// f32; q scaled ONCE by log2(e)/sqrt(D) and rounded to the input precision;
// p = exp2(s - lse*log2(e)), masked scores at the finite -1e30 and p = 0
// there; ds = p*(do.v^T - delta).  The JAX operand casts are kept: p is
// rounded to do's precision for dv = p^T.do, ds to q's for dk = ds^T.q and
// to k's for dq = ds.k.  As in _fused_bwd_kernel (and unlike the split dq,
// which scales once at the end), EACH ds.k contribution is multiplied by
// 1/sqrt(D) before it is added; dk is multiplied by 1/log2(e) at the end.
// Sums are f32.
//
// What bounds it.  At the T 8192 training path's shape (BH = 16, T = 8192,
// D = 128, bf16, causal) it does five products over the causal half,
// 5*2*BH*T(T+1)/2*D = 687 GFLOP (0.695 ms at 989 TFLOP/s bf16), against
// the split pair's seven; it reads q, k, v, do, lse, delta and writes dq,
// dk, dv once: 0.2 GB (0.06 ms at 3.35 TB/s).  Compute-bound.
//
// Where dq accumulates: the point a Hopper port has to re-derive.  The TPU
// kernel keeps a full-length [T, D] f32 dq in VMEM (4 MiB here) and relies
// on its grid running in order on one core, with only the BH axis
// parallel.  Blocks on Hopper run in no order, 227 KB of shared memory
// cannot hold 4 MiB, and the reference's gate (tools/flash_parity.py)
// demands the same bits run to run, which float atomics on dq would not
// give.  So:
// - One block of 256 threads per (bh, s), s in 0..S-1.  Block s owns the k
//   tiles r*S + s (even rounds r) and r*S + S-1-s (odd rounds): a snake,
//   so under a causal mask, where k tile j meets nq - j q tiles, the S
//   blocks of a bh get the same work to within one round.  S (chosen by
//   the wrapper from the shape alone: floor(132 / BH), at most nk) makes
//   BH*S fill the 132 SMs with one block each: S = 8 and 128 blocks at
//   BH = 16.
// - For each owned k tile, the k and v tiles stay in shared memory and the
//   dk/dv accumulators (2 x 64 x D f32) in registers over the q loop,
//   which starts at the diagonal when causal, as in flash_dkv_kernel.
// - Each q tile's dq contribution goes into the block's OWN [T, D] f32
//   slice of an [S, BH, T, D] workspace (S x 64 MiB = 512 MiB at the
//   shape above) with plain loads and stores: no other block writes that
//   slice, and inside the block one thread owns each element.  The first
//   owned k tile (r = 0, tile s) visits every q tile the slice will ever
//   hold (from tile s on when causal, all otherwise), so it STORES and
//   later tiles add: the workspace needs no memset.
// - A second kernel sums, for each dq row, the slices that hold it (causal:
//   s <= the row's q tile) in the fixed order 0..S-1, then casts.
// No atomics anywhere: the same inputs give the same bits on every run.
//
// Registers.  flash_dkv_kernel already needs 126 registers at D = 128 for
// dk/dv in registers.  A third 64 x D accumulator for dq would not fit, so
// the contribution is computed and written in chunks of 4 x 4 values a
// thread (64 columns of the 64-row tile per chunk), from the ds^T and k
// tiles already in shared memory; no shared memory is added (165,888 bytes
// at D = 128).  nvcc -Xptxas -v for sm_90a: 128 registers a thread at
// D = 128, 96-127 at D = 64, 80 at D = 32, 40 for the reduction; no spills.
//
// Products on the CUDA cores in f32, as in flash_bwd.cu; tensor cores
// (mma.sync/wgmma), TMA and warp specialisation are later work.  Any T
// (the ragged edge is masked), head dims 32/64/128, bf16 and f32 in,
// causal or not.

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

// 165,888 bytes at D = 128: one block per SM.
template <int D>
constexpr size_t fused_smem_floats() {
  return 4 * size_t(kBlock) * (D + 1)         // k, v, q (scaled), do tiles
         + 2 * size_t(kBlock) * (kBlock + 1)  // p^T and ds^T tiles
         + 2 * size_t(kBlock);                // lse2, delta per q row
}

template <typename Tin, typename Tout, int D>
__global__ void __launch_bounds__(kThreads)
flash_fused_bwd_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                       const Tin* __restrict__ v, const Tin* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       float* __restrict__ ws, Tout* __restrict__ dk,
                       Tout* __restrict__ dv, int t, int causal, float qscale,
                       float scale) {
  static_assert(D % 64 == 0 || D == 32, "head dim must be 32 or a multiple of 64");
  constexpr int kDp = D + 1;       // tile row stride: no bank conflicts
  constexpr int kSp = kBlock + 1;  // p^T / ds^T row stride
  constexpr int kCols = D / 16;    // dk/dv accumulator columns per thread
  // dq contribution chunk: 4 rows x kChunk columns a thread.
  constexpr int kChunk = kCols < 4 ? kCols : 4;

  extern __shared__ float smem[];
  float* ks = smem;                  // [kBlock][kDp], the current k tile
  float* vs = ks + kBlock * kDp;
  float* qs = vs + kBlock * kDp;     // the visiting q tile (scaled)
  float* dos = qs + kBlock * kDp;    // the visiting do tile
  float* pts = dos + kBlock * kDp;   // p^T [k row][q row]
  float* dsts = pts + kBlock * kSp;  // ds^T [k row][q row]
  float* lse2_s = dsts + kBlock * kSp;
  float* delta_s = lse2_s + kBlock;

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int bh = blockIdx.x;
  const int n_bh = gridDim.x;
  const int slice = blockIdx.y;
  const int n_slices = gridDim.y;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const size_t row_base = static_cast<size_t>(bh) * t;
  float* my_ws = ws + (static_cast<size_t>(slice) * n_bh + bh) * t * D;

  const float qc = round_to<Tin>(qscale);
  const float inv_log2e = static_cast<float>(1.0 / kLog2eD);
  const int nq = (t + kBlock - 1) / kBlock;
  const int nk = nq;
  const int rounds = (nk + n_slices - 1) / n_slices;

  for (int r = 0; r < rounds; ++r) {
    const int kj = r * n_slices + ((r & 1) ? n_slices - 1 - slice : slice);
    if (kj >= nk) continue;
    const bool first = r == 0;  // stores into the slice; later tiles add
    const int k0 = kj * kBlock;
    __syncthreads();  // the previous k tile's reads of ks/vs/dsts are done
    for (int i = tid; i < kBlock * D; i += kThreads) {
      const int rr = i / D, c = i % D, row = k0 + rr;
      const bool in = row < t;
      const size_t off = base + static_cast<size_t>(row) * D + c;
      ks[rr * kDp + c] = in ? to_f32(k[off]) : 0.f;
      vs[rr * kDp + c] = in ? to_f32(v[off]) : 0.f;
    }

    float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

    const int q_begin = causal ? kj : 0;  // start at the diagonal
    for (int qi = q_begin; qi < nq; ++qi) {
      const int q0 = qi * kBlock;
      __syncthreads();  // the previous q tile's reads of qs/dos/pts/dsts are done
      for (int i = tid; i < kBlock * D; i += kThreads) {
        const int rr = i / D, c = i % D, row = q0 + rr;
        const bool in = row < t;
        const size_t off = base + static_cast<size_t>(row) * D + c;
        qs[rr * kDp + c] = in ? round_to<Tin>(to_f32(q[off]) * qc) : 0.f;
        dos[rr * kDp + c] = in ? to_f32(dout[off]) : 0.f;
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
          const int rr = ty + 16 * i, c = tx + 16 * j;
          float x = s[i][j];
          if (masked) {
            const int kpos = k0 + rr, qpos = q0 + c;
            if (qpos >= t || kpos >= t || (causal && kpos > qpos)) x = kNegInf;
          }
          float p = exp2f(x - lse2_s[c]);
          if (masked && !(x > 0.5f * kNegInf)) p = 0.f;
          pts[rr * kSp + c] = round_to<Tin>(p);  // p enters p^T.do in do's precision
          const float ds = p * (dp[i][j] - delta_s[c]);
          dsts[rr * kSp + c] = round_to<Tin>(ds);  // ds enters ds^T.q and ds.k rounded
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

      // dq[q rows] (+)= (ds.k) * scale into this block's slice, in chunks:
      // q rows ty + 16*i, columns tx + 16*(j0 + j).  ds^T and k are read
      // only, so no barrier is needed before this.
      for (int j0 = 0; j0 < kCols; j0 += kChunk) {
        float acc[4][kChunk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < kChunk; ++j) acc[i][j] = 0.f;
#pragma unroll 4
        for (int c = 0; c < kBlock; ++c) {
          float d[4], kk[kChunk];
#pragma unroll
          for (int i = 0; i < 4; ++i) d[i] = dsts[c * kSp + ty + 16 * i];
#pragma unroll
          for (int j = 0; j < kChunk; ++j) kk[j] = ks[c * kDp + tx + 16 * (j0 + j)];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < kChunk; ++j) acc[i][j] = fmaf(d[i], kk[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = q0 + ty + 16 * i;
          if (row >= t) continue;
          float* out = my_ws + static_cast<size_t>(row) * D + tx + 16 * j0;
#pragma unroll
          for (int j = 0; j < kChunk; ++j) {
            const float contrib = acc[i][j] * scale;
            out[16 * j] = first ? contrib : out[16 * j] + contrib;
          }
        }
      }
    }

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
}

// dq = sum over the slices that hold each row, in the order 0..S-1, cast
// to Tout.  Four consecutive elements (one row, D % 4 == 0) a thread.
template <typename Tout>
__global__ void __launch_bounds__(256)
fused_dq_reduce_kernel(const float* __restrict__ ws, Tout* __restrict__ dq,
                       long long n4, long long stride, int t, int d, int slices,
                       int causal) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long e = 4 * i;
    const int row = static_cast<int>((e / d) % t);
    const int last = causal ? min(slices - 1, row / kBlock) : slices - 1;
    float4 acc = *reinterpret_cast<const float4*>(ws + e);
    for (int s = 1; s <= last; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(ws + s * stride + e);
      acc.x += x.x;
      acc.y += x.y;
      acc.z += x.z;
      acc.w += x.w;
    }
    dq[e] = from_f32<Tout>(acc.x);
    dq[e + 1] = from_f32<Tout>(acc.y);
    dq[e + 2] = from_f32<Tout>(acc.z);
    dq[e + 3] = from_f32<Tout>(acc.w);
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv, *ws;
  int bh, t, slices, causal;
  cudaStream_t stream;
};

template <typename Tin, typename Tout, int D>
cudaError_t launch(const Args& a) {
  const size_t smem = fused_smem_floats<D>() * sizeof(float);
  auto kernel = flash_fused_bwd_kernel<Tin, Tout, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  // (1/sqrt(D)) * log2(e) and 1/sqrt(D) in double, as the JAX wrapper.
  const double rsqrt_d = 1.0 / std::sqrt(static_cast<double>(D));
  const dim3 grid(a.bh, a.slices);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const Tin*>(a.q), static_cast<const Tin*>(a.k),
      static_cast<const Tin*>(a.v), static_cast<const Tin*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.ws), static_cast<Tout*>(a.dk), static_cast<Tout*>(a.dv),
      a.t, a.causal, static_cast<float>(rsqrt_d * kLog2eD), static_cast<float>(rsqrt_d));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long long n4 = static_cast<long long>(a.bh) * a.t * D / 4;
  const long long blocks = (n4 + 255) / 256;
  const int grid_r = static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
  fused_dq_reduce_kernel<Tout><<<grid_r, 256, 0, a.stream>>>(
      static_cast<const float*>(a.ws), static_cast<Tout*>(a.dq), n4,
      static_cast<long long>(a.bh) * a.t * D, a.t, D, a.slices, a.causal);
  return cudaGetLastError();
}

template <typename Tin, typename Tout>
cudaError_t launch_d(const Args& a, int d) {
  switch (d) {
    case 32: return launch<Tin, Tout, 32>(a);
    case 64: return launch<Tin, Tout, 64>(a);
    case 128: return launch<Tin, Tout, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and do share in_dtype;
// dq, dk and dv share out_dtype).  ws is an f32 [slices, bh, t, d]
// workspace the caller allocates; it needs no initial value.  Returns the
// launches' cudaError_t (0 = success); the caller raises on anything else.
extern "C" int dtx_flash_fused_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, void* ws, int bh, int t,
                                   int d, int slices, int in_dtype, int out_dtype,
                                   int causal, void* stream) {
  if (bh < 1 || t < 1 || slices < 1 || slices > (t + kBlock - 1) / kBlock)
    return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, dq, dk, dv, ws, bh, t, slices, causal,
               static_cast<cudaStream_t>(stream)};
  if (in_dtype == 0 && out_dtype == 0) return launch_d<float, float>(a, d);
  if (in_dtype == 1 && out_dtype == 1) return launch_d<__nv_bfloat16, __nv_bfloat16>(a, d);
  if (in_dtype == 1 && out_dtype == 0) return launch_d<__nv_bfloat16, float>(a, d);
  if (in_dtype == 0 && out_dtype == 1) return launch_d<float, __nv_bfloat16>(a, d);
  return cudaErrorInvalidValue;
}

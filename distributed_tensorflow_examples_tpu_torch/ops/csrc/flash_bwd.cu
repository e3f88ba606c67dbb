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
// 3.35 TB/s): compute-bound, so the products have to run on the tensor
// cores (the CUDA cores' f32 peak, 67 TFLOP/s, puts the pair at 3.6 ms).
//
// bf16 in, bf16 out (the training path) or f32 out (every hop of the
// flash ring, ops/attention.py): flash_dq_tc_kernel and
// flash_dkv_tc_kernel, the products on the tensor cores by
// mma.sync.m16n8k16 (bf16 in, f32 accumulate), with the helpers of
// tc_sm90.cuh.  The output type is a template parameter that touches the
// epilogue alone: the bf16 instance rounds each f32 accumulator to bf16
// (round to nearest even), the f32 instance stores it as it is, so the f32
// result rounded to bf16 is the bf16 result bit for bit.  Rows of every
// shared tile are padded by 16 bytes, so ldmatrix reads hit 32 distinct
// banks.
// - dq, the shape of flash_fwd_tc_kernel: one block of 256 threads
//   (8 warps) per (bh, 128-row q block); warp w owns q rows 16w..16w+15
//   and keeps their dq (16 x D f32) in registers.  The folded q block
//   (x round(qscale), rounded to bf16, as the f32 kernel and the JAX
//   wrapper fold it) and the do block stay in shared memory; k and v
//   stream in 64-row tiles through a two-stage cp.async ring (zero fill
//   past T): tile j+1 lands while tile j is in the products.  s = q.k^T
//   and dp = do.v^T for the warp's 16 rows x 64 keys (32 + 32 registers),
//   with q and do read as A fragments by ldmatrix at each k-step (held in
//   registers beside dq's 64 at D = 128 they would pass 255); p and ds in
//   registers; ds rounded to bf16 is the A operand of dq += ds.k as it
//   stands (the C layout of two 16x8 tiles is the A layout of one 16x16
//   tile), k entering as B through ldmatrix.trans.  Causal: the block's
//   loop stops at its last row's tile and a warp skips the tiles wholly
//   above its own rows (there p = 0, so ds = 0: exact).  Heavy (late) q
//   blocks launch first.  139,264 bytes of shared memory at D = 128.
// - dk/dv, the walk of flash_fused_bwd_tc_kernel without its dq: one
//   block of 8 warps per (bh, 128-key group); warp w owns keys
//   16w..16w+15 and keeps their dk and dv (16 x D f32 each, 128 registers
//   at D = 128) in registers.  The group's k and v sit in shared memory;
//   64-row q and do tiles, with their lse and delta rows, stream through a
//   two-stage cp.async ring, and each thread folds the q chunks it copied
//   itself once they land.  s^T = k.q^T and dp^T = v.do^T in chunks of 16
//   q columns at D = 128 (32 below: 32 columns spill beside dk and dv at
//   128); p^T and ds^T rounded to bf16 in registers are the A operands of
//   dv += p^T.do and dk += ds^T.q, do and q entering as B through
//   ldmatrix.trans.  A warp whose keys all lie past T or above the tile's
//   last query skips the tile (it would add exactly 0).  Causal: the q
//   loop starts at the group's diagonal.  Heavy (early) groups launch
//   first.  Without dq a block owns its dk/dv rows outright: no
//   workspace, no second kernel.  140,288 bytes of shared memory at
//   D = 128.
// - mma.sync rather than wgmma, for the reasons flash_fwd.cu gives: the
//   fragments' documented register layout keeps the masks, the exp2 and
//   the bf16 rounding of p and ds plain per-thread code.
//
// How the f32-out instances are checked (as every flash kernel's f32 out
// is: f32 out takes the tensor cores in all four, f32 in alone the CUDA
// cores).  Their sums run in another order than the plain version's, which
// moves s and dp by ~1e-7 relative; now and then a p or a ds then rounds to
// the other neighbouring bf16 value, which moves one product term by 2^-8
// of itself, more than the f32 tolerance (2e-5) allows.  So the check-only
// instances (kRecord, D = 32 and 64; dtx_flash_dq_record,
// dtx_flash_dkv_record) write the bf16 p and ds they used, and the plain
// version fed those reproduces their f32 result within the f32 tolerance;
// each recorded p and ds is held within one bf16 step (plus the f32
// summation bound for ds) of the plain version's own
// (tools/flash_rounding.py).
//
// f32 in (any out): flash_dq_kernel and flash_dkv_kernel, products on the
// CUDA cores in f32 (64-row tiles, 4x4 register tiles a thread, f32
// operand tiles in shared memory: 148,736 and 165,888 bytes at D = 128).
// Only tests ask for f32 operands (the tensor cores would need TF32), and
// both are held to the f32 tolerance.  Their loops: dq over k tiles up to
// the diagonal, dk/dv over q tiles from it.
//
// Both routes: no atomics (each output row is written by exactly one
// block, in a fixed k or q order), so the same inputs give the same bits
// run to run; only tiles that straddle the diagonal or the ragged edge are
// masked, and any T works (the ragged edge is masked, never padded).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "tc_sm90.cuh"

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

// ---------------------------------------------------------------------------
// bf16 in and out: the tensor-core kernels
// ---------------------------------------------------------------------------

constexpr int kDqBlockQ = 128;   // q rows a dq block (DQ_BLOCK_Q), 16 a warp
constexpr int kDqBlockK = 64;    // k/v rows a streamed tile (DQ_BLOCK_K)
constexpr int kDkvGroupK = 128;  // k rows a dk/dv block owns (DKV_GROUP_K), 16 a warp
constexpr int kDkvBlockQ = 64;   // q rows a streamed tile (DKV_BLOCK_Q)
using dtx::bf16;
using dtx::kTcThreads;
using dtx::tc_stride;

template <int D>
constexpr size_t dq_tc_smem_bytes() {
  return (2 * size_t(kDqBlockQ) + 4 * size_t(kDqBlockK)) * tc_stride<D>() * sizeof(bf16);
}

template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  return (2 * size_t(kDkvGroupK) + 4 * size_t(kDkvBlockQ)) * tc_stride<D>() * sizeof(bf16)
         + 4 * size_t(kDkvBlockQ) * sizeof(float);
}

// Tout: bf16 or float, the type dq is stored in (the f32 instance stores
// the same accumulator unrounded).  kRecord: the check-only instance, which
// also writes every (q row, key) pair's p and ds, rounded to bf16, to
// p_rec and ds_rec [BH, T, T] (zeroed by the caller; pairs a warp skips stay
// 0); no training or serving path launches it.
template <int D, typename Tout, bool kRecord>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   Tout* __restrict__ dq, bf16* __restrict__ p_rec, bf16* __restrict__ ds_rec,
                   int t, int causal, float qscale, float scale) {
  static_assert(D % 32 == 0, "head dim must be 32, 64 or 128");
  constexpr int S = tc_stride<D>();
  constexpr int kChunks = D / 8;             // 16-byte chunks a row
  constexpr int kDepth = D / 16;             // k-steps of q.k^T and do.v^T
  constexpr int kQTiles = D / 8;             // 16x8 tiles of dq a warp
  constexpr int kSTiles = kDqBlockK / 8;     // 16x8 tiles of s (and dp) a warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kDqBlockQ][S], folded
  bf16* dos = qs + kDqBlockQ * S;                // [kDqBlockQ][S]
  bf16* ks = dos + kDqBlockQ * S;                // [2][kDqBlockK][S]
  bf16* vs = ks + 2 * kDqBlockK * S;             // [2][kDqBlockK][S]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int bh = blockIdx.x;
  const int qb = static_cast<int>(gridDim.y) - 1 - static_cast<int>(blockIdx.y);  // heavy first
  const int q0 = qb * kDqBlockQ;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const size_t row_base = static_cast<size_t>(bh) * t;
  const int nk = (t + kDqBlockK - 1) / kDqBlockK;
  const int q_last = min(t, q0 + kDqBlockQ) - 1;
  const int k_end = causal ? min(nk, q_last / kDqBlockK + 1) : nk;  // stop at the diagonal

  auto load_kv = [&](int j, int stage) {
    const int k0 = j * kDqBlockK;
    for (int i = tid; i < kDqBlockK * kChunks; i += kTcThreads) {
      const int r = i / kChunks, col = (i % kChunks) * 8, row = k0 + r;
      const bool in = row < t;
      const size_t off = base + static_cast<size_t>(in ? row : 0) * D + col;
      const int dst = (stage * kDqBlockK + r) * S + col;
      dtx::cp_async16(ks + dst, k + off, in);
      dtx::cp_async16(vs + dst, v + off, in);
    }
  };
  load_kv(0, 0);
  for (int i = tid; i < kDqBlockQ * kChunks; i += kTcThreads) {
    const int r = i / kChunks, col = (i % kChunks) * 8, row = q0 + r;
    const bool in = row < t;
    dtx::cp_async16(dos + r * S + col, dout + base + static_cast<size_t>(in ? row : 0) * D + col,
                    in);
  }
  dtx::cp_async_commit();

  // The q block, folded once: x * round(qscale), rounded to bf16 (zero
  // past T), as the f32 kernel and the JAX wrapper fold it.
  const float qc = __bfloat162float(__float2bfloat16_rn(qscale));
  for (int i = tid; i < kDqBlockQ * kChunks; i += kTcThreads) {
    const int r = i / kChunks, col = (i % kChunks) * 8, row = q0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row < t) raw = *reinterpret_cast<const uint4*>(q + base + static_cast<size_t>(row) * D + col);
    *reinterpret_cast<uint4*>(qs + r * S + col) = dtx::fold8(raw, qc);
  }

  const int wrow = warp * 16;        // the warp's first row in the block
  const int row_a = q0 + wrow + g;   // row of c0, c1; row_a + 8 holds c2, c3
  const int warp_last = q0 + wrow + 15;
  const bool warp_live = q0 + wrow < t;
  float lse2[2], dlt[2];             // rows row_a and row_a + 8 (0 past T)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    const bool in = row < t;
    lse2[r] = in ? lse[row_base + row] * static_cast<float>(kLog2eD) : 0.f;
    dlt[r] = in ? delta[row_base + row] : 0.f;
  }
  float acc[kQTiles][4];
#pragma unroll
  for (int n = 0; n < kQTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < k_end; ++j) {
    if (j + 1 < k_end) {
      load_kv(j + 1, (j + 1) & 1);
      dtx::cp_async_commit();
      dtx::cp_async_wait<1>();
    } else {
      dtx::cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and on the first, do and the folded q) landed
    const int k0 = j * kDqBlockK;
    if (warp_live && !(causal && k0 > warp_last)) {
      const bf16* kt = ks + (j & 1) * kDqBlockK * S;
      const bf16* vt = vs + (j & 1) * kDqBlockK * S;

      // s = q.k^T (base-2 logits) and dp = do.v^T, 16 rows x 64 keys a
      // warp; q and do enter as A through ldmatrix at each k-step.
      float s[kSTiles][4], dp[kSTiles][4];
#pragma unroll
      for (int n = 0; n < kSTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
        uint32_t aq[4], ado[4];
        const int arow = wrow + lane % 8 + 8 * ((lane / 8) % 2);
        dtx::ldsm_x4(aq, qs + arow * S + kk * 16 + 8 * (lane / 16));
        dtx::ldsm_x4(ado, dos + arow * S + kk * 16 + 8 * (lane / 16));
#pragma unroll
        for (int np = 0; np < kSTiles / 2; ++np) {
          const int brow = np * 16 + lane % 8 + 8 * (lane / 16);
          const int bcol = kk * 16 + 8 * ((lane / 8) % 2);
          uint32_t b[4];
          dtx::ldsm_x4(b, kt + brow * S + bcol);
          dtx::mma_bf16(s[2 * np], aq, b[0], b[1]);
          dtx::mma_bf16(s[2 * np + 1], aq, b[2], b[3]);
          dtx::ldsm_x4(b, vt + brow * S + bcol);
          dtx::mma_bf16(dp[2 * np], ado, b[0], b[1]);
          dtx::mma_bf16(dp[2 * np + 1], ado, b[2], b[3]);
        }
      }
      // ds = p * (dp - delta) into s, f32.  Only tiles that straddle this
      // warp's diagonal and a ragged last tile carry masked scores.
      const bool masked = (causal && k0 + kDqBlockK - 1 > q0 + wrow) || (k0 + kDqBlockK > t);
#pragma unroll
      for (int n = 0; n < kSTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + n * 8 + 2 * c + (e & 1);
          const int row = row_a + 8 * (e / 2);
          float x = s[n][e];
          if (masked && (kpos >= t || (causal && kpos > row))) x = kNegInf;
          float p = exp2f(x - lse2[e / 2]);
          if (masked && !(x > 0.5f * kNegInf)) p = 0.f;
          s[n][e] = p * (dp[n][e] - dlt[e / 2]);
          if constexpr (kRecord) {
            if (row < t && kpos < t) {
              const size_t at = (row_base + row) * static_cast<size_t>(t) + kpos;
              p_rec[at] = __float2bfloat16_rn(p);
              ds_rec[at] = __float2bfloat16_rn(s[n][e]);
            }
          }
        }
      // dq += ds.k: ds rounded to bf16 (k's precision) in registers, k
      // through ldmatrix.trans.
#pragma unroll
      for (int kk = 0; kk < kDqBlockK / 16; ++kk) {
        const uint32_t a[4] = {
            dtx::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            dtx::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            dtx::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            dtx::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
        };
#pragma unroll
        for (int np = 0; np < kQTiles / 2; ++np) {
          uint32_t b[4];
          dtx::ldsm_x4_trans(b, kt + (kk * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * S + np * 16 +
                                    8 * (lane / 16));
          dtx::mma_bf16(acc[2 * np], a, b[0], b[1]);
          dtx::mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage j & 1 before it refills
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= t) continue;
    Tout* out = dq + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int n = 0; n < kQTiles; ++n)
      dtx::store2(out + n * 8 + 2 * c, acc[n][2 * r] * scale, acc[n][2 * r + 1] * scale);
  }
}

// Tout and kRecord as for flash_dq_tc_kernel: dk and dv stored in Tout;
// the check-only instance records the p and ds it rounded, at [bh, q row,
// key] of p_rec and ds_rec.
template <int D, typename Tout, bool kRecord>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    Tout* __restrict__ dk, Tout* __restrict__ dv, bf16* __restrict__ p_rec,
                    bf16* __restrict__ ds_rec, int t, int causal, float qscale) {
  static_assert(D % 32 == 0, "head dim must be 32, 64 or 128");
  constexpr int S = tc_stride<D>();
  // q columns of s^T and dp^T held at once: 16 at D = 128, where dk and dv
  // already take 128 registers a thread, 32 below.
  constexpr int kQChunk = D == 128 ? 16 : 32;
  constexpr int kChunks = D / 8;          // 16-byte chunks a row
  constexpr int kDepth = D / 16;          // k-steps of s^T and dp^T
  constexpr int kDTiles = D / 8;          // 16x8 tiles of dk, dv a warp
  constexpr int kSTiles = kQChunk / 8;    // 16x8 tiles of s^T a chunk

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kDkvGroupK][S]
  bf16* vs = ks + kDkvGroupK * S;                // [kDkvGroupK][S]
  bf16* qs = vs + kDkvGroupK * S;                // [2][kDkvBlockQ][S], folded
  bf16* dos = qs + 2 * kDkvBlockQ * S;           // [2][kDkvBlockQ][S]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * kDkvBlockQ * S);  // [2][kDkvBlockQ]
  float* delta_s = lse_s + 2 * kDkvBlockQ;                            // [2][kDkvBlockQ]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kDkvGroupK;  // causal: early groups see the most q tiles
  const size_t base = static_cast<size_t>(bh) * t * D;
  const size_t row_base = static_cast<size_t>(bh) * t;
  const float qc = __bfloat162float(__float2bfloat16_rn(qscale));
  const float log2e = static_cast<float>(kLog2eD);
  const float inv_log2e = static_cast<float>(1.0 / kLog2eD);
  const int nq = (t + kDkvBlockQ - 1) / kDkvBlockQ;
  const int q_begin = causal ? k0 / kDkvBlockQ : 0;  // start at the diagonal

  // q, do, lse, delta of q tile qi into ring stage `stage`.
  auto load_q = [&](int qi, int stage) {
    const int q0 = qi * kDkvBlockQ;
    for (int i = tid; i < kDkvBlockQ * kChunks; i += kTcThreads) {
      const int r = i / kChunks, col = (i % kChunks) * 8, row = q0 + r;
      const bool in = row < t;
      const size_t off = base + static_cast<size_t>(in ? row : 0) * D + col;
      const int at = (stage * kDkvBlockQ + r) * S + col;
      dtx::cp_async16(qs + at, q + off, in);
      dtx::cp_async16(dos + at, dout + off, in);
    }
    if (tid < 2 * kDkvBlockQ) {
      const int r = tid % kDkvBlockQ, row = q0 + r;
      const bool in = row < t;
      const float* src = (tid < kDkvBlockQ ? lse : delta) + row_base + (in ? row : 0);
      float* to = (tid < kDkvBlockQ ? lse_s : delta_s) + stage * kDkvBlockQ + r;
      dtx::cp_async4(to, src, in);
    }
  };
  // The q chunks this thread copied, folded in place once they have landed.
  auto fold_q = [&](int stage) {
    for (int i = tid; i < kDkvBlockQ * kChunks; i += kTcThreads) {
      const int r = i / kChunks, col = (i % kChunks) * 8;
      uint4* p = reinterpret_cast<uint4*>(qs + (stage * kDkvBlockQ + r) * S + col);
      *p = dtx::fold8(*p, qc);
    }
  };

  for (int i = tid; i < kDkvGroupK * kChunks; i += kTcThreads) {
    const int r = i / kChunks, col = (i % kChunks) * 8, row = k0 + r;
    const bool in = row < t;
    const size_t off = base + static_cast<size_t>(in ? row : 0) * D + col;
    dtx::cp_async16(ks + r * S + col, k + off, in);
    dtx::cp_async16(vs + r * S + col, v + off, in);
  }
  load_q(q_begin, 0);
  dtx::cp_async_commit();

  float dk_acc[kDTiles][4], dv_acc[kDTiles][4];
#pragma unroll
  for (int n = 0; n < kDTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
  const int key0 = k0 + warp * 16;  // this warp's first key

  for (int qi = q_begin; qi < nq; ++qi) {
    const int stage = (qi - q_begin) & 1;
    if (qi + 1 < nq) {
      load_q(qi + 1, stage ^ 1);
      dtx::cp_async_commit();
      dtx::cp_async_wait<1>();
    } else {
      dtx::cp_async_wait<0>();
    }
    fold_q(stage);
    __syncthreads();  // the tile (and on the first visit k, v) landed, folded

    const int q0 = qi * kDkvBlockQ;
    const bf16* qt = qs + stage * kDkvBlockQ * S;
    const bf16* dot = dos + stage * kDkvBlockQ * S;
    const float* lse_t = lse_s + stage * kDkvBlockQ;
    const float* delta_t = delta_s + stage * kDkvBlockQ;
    // A warp whose keys all lie past T or above the tile's last query
    // contributes exactly 0; only tiles that straddle the diagonal or a
    // ragged edge carry masked scores.
    const bool dead = key0 >= t || (causal && key0 > q0 + kDkvBlockQ - 1);
    const bool masked = (causal && key0 + 15 > q0) || q0 + kDkvBlockQ > t || key0 + 16 > t;
    if (!dead) {
#pragma unroll 1
      for (int qc0 = 0; qc0 < kDkvBlockQ; qc0 += kQChunk) {
        // s^T = k.q^T and dp^T = v.do^T: keys key0 + g (+8), q columns
        // qc0 + 8n + 2c (+1).
        float st[kSTiles][4], dpt[kSTiles][4];
#pragma unroll
        for (int n = 0; n < kSTiles; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kDepth; ++kk) {
          uint32_t ak[4], av[4];
          const int arow = warp * 16 + lane % 8 + 8 * ((lane / 8) % 2);
          dtx::ldsm_x4(ak, ks + arow * S + kk * 16 + 8 * (lane / 16));
          dtx::ldsm_x4(av, vs + arow * S + kk * 16 + 8 * (lane / 16));
#pragma unroll
          for (int np = 0; np < kSTiles / 2; ++np) {
            const int brow = qc0 + np * 16 + lane % 8 + 8 * (lane / 16);
            const int bcol = kk * 16 + 8 * ((lane / 8) % 2);
            uint32_t b[4];
            dtx::ldsm_x4(b, qt + brow * S + bcol);
            dtx::mma_bf16(st[2 * np], ak, b[0], b[1]);
            dtx::mma_bf16(st[2 * np + 1], ak, b[2], b[3]);
            dtx::ldsm_x4(b, dot + brow * S + bcol);
            dtx::mma_bf16(dpt[2 * np], av, b[0], b[1]);
            dtx::mma_bf16(dpt[2 * np + 1], av, b[2], b[3]);
          }
        }
        // p (f32) into st, ds = p * (dp - delta) (f32) into dpt.
#pragma unroll
        for (int n = 0; n < kSTiles; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + g + 8 * (e / 2);
            const int qq = qc0 + n * 8 + 2 * c + (e & 1);
            const int qpos = q0 + qq;
            float x = st[n][e];
            if (masked && (qpos >= t || key >= t || (causal && key > qpos))) x = kNegInf;
            float p = exp2f(x - lse_t[qq] * log2e);
            if (masked && !(x > 0.5f * kNegInf)) p = 0.f;
            st[n][e] = p;
            dpt[n][e] = p * (dpt[n][e] - delta_t[qq]);
            if constexpr (kRecord) {
              if (qpos < t && key < t) {
                const size_t at = (row_base + qpos) * static_cast<size_t>(t) + key;
                p_rec[at] = __float2bfloat16_rn(p);
                ds_rec[at] = __float2bfloat16_rn(dpt[n][e]);
              }
            }
          }
        // dv += p^T.do and dk += ds^T.q, p (do's precision) and ds (q's)
        // rounded to bf16 in registers.
#pragma unroll
        for (int kk = 0; kk < kQChunk / 16; ++kk) {
          const uint32_t ap[4] = {
              dtx::pack_bf16(st[2 * kk][0], st[2 * kk][1]),
              dtx::pack_bf16(st[2 * kk][2], st[2 * kk][3]),
              dtx::pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]),
              dtx::pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]),
          };
          const uint32_t ad[4] = {
              dtx::pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]),
              dtx::pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]),
              dtx::pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]),
              dtx::pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]),
          };
          const int brow = qc0 + kk * 16 + lane % 8 + 8 * ((lane / 8) % 2);
#pragma unroll
          for (int np = 0; np < kDTiles / 2; ++np) {
            const int bcol = np * 16 + 8 * (lane / 16);
            uint32_t b[4];
            dtx::ldsm_x4_trans(b, dot + brow * S + bcol);
            dtx::mma_bf16(dv_acc[2 * np], ap, b[0], b[1]);
            dtx::mma_bf16(dv_acc[2 * np + 1], ap, b[2], b[3]);
            dtx::ldsm_x4_trans(b, qt + brow * S + bcol);
            dtx::mma_bf16(dk_acc[2 * np], ad, b[0], b[1]);
            dtx::mma_bf16(dk_acc[2 * np + 1], ad, b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with the stage before it refills
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + g + 8 * r;
    if (key >= t) continue;
    const size_t off = base + static_cast<size_t>(key) * D + 2 * c;
#pragma unroll
    for (int n = 0; n < kDTiles; ++n) {
      dtx::store2(dk + off + n * 8, dk_acc[n][2 * r] * inv_log2e,
                  dk_acc[n][2 * r + 1] * inv_log2e);
      dtx::store2(dv + off + n * 8, dv_acc[n][2 * r], dv_acc[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Launch and dispatch
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;
  int bh, t, causal;
  cudaStream_t stream;
  void* p_rec = nullptr;   // the check-only instances' [BH, T, T] bf16 records
  void* ds_rec = nullptr;
};

template <typename Tin, typename Tout, int D>
cudaError_t launch_dq(const Args& a) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  auto kernel = flash_dq_kernel<Tin, Tout, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.t + kBlock - 1) / kBlock);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const Tin*>(a.q), static_cast<const Tin*>(a.k),
      static_cast<const Tin*>(a.v), static_cast<const Tin*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<Tout*>(a.out0), a.t, a.causal, dtx::fold_scale<D>(),
      static_cast<float>(dtx::rsqrt_d<D>()));
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
      dtx::fold_scale<D>());
  return cudaGetLastError();
}

template <int D, typename Tout, bool kRecord>
cudaError_t launch_dq_tc(const Args& a) {
  const size_t smem = dq_tc_smem_bytes<D>();
  auto kernel = flash_dq_tc_kernel<D, Tout, kRecord>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.t + kDqBlockQ - 1) / kDqBlockQ);
  kernel<<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<Tout*>(a.out0), static_cast<bf16*>(a.p_rec), static_cast<bf16*>(a.ds_rec),
      a.t, a.causal, dtx::fold_scale<D>(), static_cast<float>(dtx::rsqrt_d<D>()));
  return cudaGetLastError();
}

template <int D, typename Tout, bool kRecord>
cudaError_t launch_dkv_tc(const Args& a) {
  const size_t smem = dkv_tc_smem_bytes<D>();
  auto kernel = flash_dkv_tc_kernel<D, Tout, kRecord>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.t + kDkvGroupK - 1) / kDkvGroupK);
  kernel<<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<Tout*>(a.out0), static_cast<Tout*>(a.out1), static_cast<bf16*>(a.p_rec),
      static_cast<bf16*>(a.ds_rec), a.t, a.causal, dtx::fold_scale<D>());
  return cudaGetLastError();
}

// The tensor-core kernel at head dim d, storing Tout.
template <bool kDq, typename Tout>
cudaError_t launch_tc_d(const Args& a, int d) {
  switch (d) {
    case 32: return kDq ? launch_dq_tc<32, Tout, false>(a) : launch_dkv_tc<32, Tout, false>(a);
    case 64: return kDq ? launch_dq_tc<64, Tout, false>(a) : launch_dkv_tc<64, Tout, false>(a);
    case 128: return kDq ? launch_dq_tc<128, Tout, false>(a) : launch_dkv_tc<128, Tout, false>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The check-only recording instance (f32 out) at head dim d: 32 and 64,
// the shapes its check runs at (the records are T^2 a head).
template <bool kDq>
cudaError_t launch_record_d(const Args& a, int d) {
  switch (d) {
    case 32: return kDq ? launch_dq_tc<32, float, true>(a) : launch_dkv_tc<32, float, true>(a);
    case 64: return kDq ? launch_dq_tc<64, float, true>(a) : launch_dkv_tc<64, float, true>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The CUDA-core kernel at head dim d.
template <bool kDq, typename Tin, typename Tout>
cudaError_t launch_d(const Args& a, int d) {
  switch (d) {
    case 32: return kDq ? launch_dq<Tin, Tout, 32>(a) : launch_dkv<Tin, Tout, 32>(a);
    case 64: return kDq ? launch_dq<Tin, Tout, 64>(a) : launch_dkv<Tin, Tout, 64>(a);
    case 128: return kDq ? launch_dq<Tin, Tout, 128>(a) : launch_dkv<Tin, Tout, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

// bf16 in: the tensor-core kernel, storing bf16 or f32; f32 in: the
// CUDA-core kernel, storing f32 or bf16.
template <bool kDq>
int dispatch(const Args& a, int d, int in_dtype, int out_dtype) {
  if (a.bh < 1 || a.t < 1) return cudaErrorInvalidValue;
  if (dtx::tc_route(in_dtype, out_dtype))
    return out_dtype == 1 ? launch_tc_d<kDq, bf16>(a, d) : launch_tc_d<kDq, float>(a, d);
  if (in_dtype == 0 && out_dtype == 0) return launch_d<kDq, float, float>(a, d);
  if (in_dtype == 0 && out_dtype == 1) return launch_d<kDq, float, __nv_bfloat16>(a, d);
  return cudaErrorInvalidValue;
}

}  // namespace

// The kernel a launch with these dtype codes (0 = float32, 1 = bfloat16)
// takes: 1, the tensor-core kernel (bf16 in, bf16 or f32 out), or 0, the
// CUDA-core one (f32 in).  tiles gets that kernel's {q rows, k rows} tile:
// for dq the q rows a block owns and the k rows a streamed tile, for dk/dv
// the q rows a streamed tile and the k rows a block owns.  The wrappers
// count tensor-core launches by it; the checks hold the plain versions'
// tiles to it.
extern "C" int dtx_flash_dq_route(int in_dtype, int out_dtype, int* tiles) {
  const int tc = dtx::tc_route(in_dtype, out_dtype);
  tiles[0] = tc ? kDqBlockQ : kBlock;
  tiles[1] = tc ? kDqBlockK : kBlock;
  return tc;
}

extern "C" int dtx_flash_dkv_route(int in_dtype, int out_dtype, int* tiles) {
  const int tc = dtx::tc_route(in_dtype, out_dtype);
  tiles[0] = tc ? kDkvBlockQ : kBlock;
  tiles[1] = tc ? kDkvGroupK : kBlock;
  return tc;
}

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and do share in_dtype).
// bf16 operands must be 16-byte aligned (the wrappers check).  Each
// returns the launch's cudaError_t (0 = success); the caller raises on
// anything else.
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

// The check-only instances: bf16 in, f32 out, head dim 32 or 64, the same
// arithmetic as the f32-out tensor-core kernels, and besides every visited
// (q row, key) pair's bf16-rounded p and ds written to p_rec and ds_rec
// [BH, T, T] (zeroed by the caller).
extern "C" int dtx_flash_dq_record(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, void* p_rec, void* ds_rec, int bh, int t, int d,
                                   int causal, void* stream) {
  if (bh < 1 || t < 1 || !p_rec || !ds_rec) return cudaErrorInvalidValue;
  Args a{q, k, v, dout, lse, delta, dq, nullptr, bh, t, causal,
         static_cast<cudaStream_t>(stream)};
  a.p_rec = p_rec;
  a.ds_rec = ds_rec;
  return launch_record_d<true>(a, d);
}

extern "C" int dtx_flash_dkv_record(const void* q, const void* k, const void* v,
                                    const void* dout, const void* lse, const void* delta,
                                    void* dk, void* dv, void* p_rec, void* ds_rec, int bh,
                                    int t, int d, int causal, void* stream) {
  if (bh < 1 || t < 1 || !p_rec || !ds_rec) return cudaErrorInvalidValue;
  Args a{q, k, v, dout, lse, delta, dk, dv, bh, t, causal,
         static_cast<cudaStream_t>(stream)};
  a.p_rec = p_rec;
  a.ds_rec = ds_rec;
  return launch_record_d<false>(a, d);
}

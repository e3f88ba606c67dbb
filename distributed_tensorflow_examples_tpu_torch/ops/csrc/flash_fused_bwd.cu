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
// Sums are f32.  Any T (the ragged edge is masked, never padded), head dims
// 32/64/128, bf16 or f32 out, causal or not.
//
// What bounds it.  At the T 8192 training path's shape (BH = 16, T = 8192,
// D = 128, bf16, causal) it does five products over the causal half,
// 5*2*BH*T(T+1)/2*D = 687 GFLOP (0.695 ms at 989 TFLOP/s bf16), against
// the split pair's seven; it reads q, k, v, do, lse, delta and writes dq,
// dk, dv once: 0.2 GB (0.06 ms at 3.35 TB/s).  Compute-bound, so the
// products have to run on the tensor cores; and then the f32 dq traffic
// below, not the products, is the next floor.
//
// Where dq accumulates: the point a Hopper port has to re-derive.  The TPU
// kernel keeps a full-length [T, D] f32 dq in VMEM (4 MiB here) and relies
// on its grid running in order on one core.  Blocks on Hopper run in no
// order, 227 KB of shared memory cannot hold 4 MiB, and the reference's
// gate (tools/flash_parity.py) demands the same bits run to run, which
// float atomics on dq would not give.  So each block adds its dq
// contributions into its OWN f32 slice of an [S, BH, T, D] workspace with
// plain loads and stores, and fused_dq_reduce_kernel sums, for each dq
// row, the slices that hold it (causal: those whose first k group is at or
// below the row) in the fixed order 0..S-1, then casts.  No atomics
// anywhere: the same inputs give the same bits on every run.  A block's
// first k group visits every q tile its slice will ever hold, so it STORES
// and later groups add: the workspace needs no memset.
//
// bf16 in, bf16 out (the T 8192 training path) or f32 out (every hop of
// the fused flash ring, ops/attention.py): flash_fused_bwd_tc_kernel, the
// products on the tensor cores.  The output type is a template parameter
// that touches the dk/dv epilogue and the reduction's store alone (the dq
// workspace is f32 in both): the bf16 instance rounds each f32 value to
// bf16 (round to nearest even), the f32 instance stores it as it is, so the
// f32 result rounded to bf16 is the bf16 result bit for bit.
// - One block of 256 threads (8 warps) per (bh, s), s in 0..S-1.  Block s
//   owns the 128-row k GROUPS r*S + s (even rounds r) and r*S + S-1-s (odd
//   rounds): a snake, so under a causal mask, where group j meets nq - 2j
//   q tiles, the S blocks of a bh get the same work to within one round.
//   S = min(groups, floor(132 / BH)), from the shape alone: 8 at BH = 16,
//   T = 8192 (128 blocks, one an SM).
// - A group's k and v (128 rows, bf16) sit in shared memory; warp w owns
//   keys 16w..16w+15 and keeps their dk and dv (16 x D f32 each) in
//   registers over the q loop, which starts at the group's diagonal when
//   causal.  The q and do tiles (64 rows, bf16) with their lse and delta
//   rows stream through a two-stage ring filled by cp.async (16-byte
//   copies, 4-byte ones for lse/delta; zero fill past T): q tile i+1 lands
//   while tile i is in the products.  Each thread folds the q chunks it
//   copied itself (x round(qscale), rounded to bf16: the f32 kernel's and
//   the JAX wrapper's rounding) once they land.  Rows are padded by 16
//   bytes, so ldmatrix reads hit 32 distinct banks.
// - s^T = k.q^T and dp^T = v.do^T by mma.sync.m16n8k16 (bf16 in, f32
//   accumulate), in chunks of 16 q columns at D = 128 (32 below), so that
//   s^T and dp^T take 8 registers each beside dk and dv's 128.  p^T and ds^T are
//   rounded to bf16 in registers and are the A operands of dv += p^T.do and
//   dk += ds^T.q as they stand (the C layout of two 16x8 tiles is the A
//   layout of one 16x16 tile); do and q enter as B through ldmatrix.trans,
//   so no tile is transposed by hand.
// - ds^T also goes to shared memory (bf16, 128 x 64), and after one barrier
//   the eight warps compute the q tile's dq contribution for the WHOLE
//   group, ds.k = [64 q x 128 keys] . [128 keys x D] (ds through
//   ldmatrix.trans, each warp 16 q rows x D/2 columns), scale it, and add
//   it to the slice in ONE read-modify-write per (q tile, k group), 16-byte
//   vectors (a shuffle pairs the lanes that hold two halves of four
//   neighbouring columns); the slice's values are loaded before the product
//   so that their latency hides behind it.  Against one read-modify-write per 64-row k
//   tile, as the f32 kernel does, that halves the workspace traffic a
//   product: at [16, 8192, 128] causal the block walk reads and writes
//   3.85 GB of the slices (8.13 GB with 64-row tiles; the count is
//   fused_dq_workspace_bytes in ops/flash_attention.py), and the reduction
//   reads 0.51 GB more.
// - Registers: dk, dv 128 + s^T, dp^T 16 a thread in the q loop at
//   D = 128; dq 32 and the slice's 32 values in its product.  158,720
//   bytes of shared memory at D = 128: one block an SM.
// - mma.sync rather than wgmma: its fragments live in registers with a
//   documented layout, so the masks, the exp2, the bf16 rounding of p and
//   ds and the pairing of ds^T's C tiles into A tiles stay plain
//   per-thread code.  Its cost is shared-memory traffic: each warp stages
//   its own ldmatrix fragments (~0.75 ldmatrix.x4 an mma here), the likely
//   limit of the s^T/dp^T/dv/dk phase.  The same structure on wgmma (two
//   warpgroups of 64 keys, no-swizzle shared operands, a wait after each
//   product) ran no faster on the card and spilled at D = 128; the gain
//   needs the elementwise work of one warpgroup to overlap the other's
//   products, TMA and warp specialisation (ROADMAP B4).
//
// How the f32-out instance is checked.  Its sums run in another order than
// the plain version's, which moves s and dp by ~1e-7 relative; now and then
// a p or a ds then rounds to the other neighbouring bf16 value, which moves
// one product term by 2^-8 of itself (seen on the CUDA-core route's
// predecessor: 1.7e-4 at [8, 2048, 128]), more than the f32 tolerance
// (2e-5) allows.  So the check-only instance (kRecord, D = 32 and 64;
// dtx_flash_fused_bwd_record) writes the bf16 p (which feeds dv) and ds
// (which feeds dk and dq) it used, and the plain version fed those
// reproduces its f32 dq, dk and dv within the f32 tolerance; each recorded
// p is held within one bf16 step and each ds within its stated bound of the
// plain version's own (tools/flash_rounding.py).
//
// f32 in (any out): flash_fused_bwd_kernel, products on the CUDA cores in
// f32 with 64-row k tiles in the same snake over the same S slices.  Only
// tests ask for f32 operands (the tensor cores would need TF32), held to
// the f32 tolerance (2e-5).  The dq contribution is computed and written in
// chunks of 4 x 4 values a thread from the ds^T and k tiles in shared
// memory.

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

// The f32 kernel's shared memory: 165,888 bytes at D = 128, one block per SM.
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


// ---------------------------------------------------------------------------
// bf16 in: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kGroup = 128;             // k rows a block holds (FUSED_GROUP_K), 16 a warp
constexpr int kQTile = 64;              // q rows a visit streams (FUSED_BLOCK_Q)
constexpr int kDsStride = kQTile + 8;   // ds^T row, bf16 elements (16-byte pad)
using dtx::kTcThreads;
using dtx::tc_stride;

template <int D>
constexpr size_t tc_smem_bytes() {
  return (2 * size_t(kGroup) + 4 * size_t(kQTile)) * tc_stride<D>() * sizeof(dtx::bf16)
         + size_t(kGroup) * kDsStride * sizeof(dtx::bf16)
         + 4 * size_t(kQTile) * sizeof(float);
}

// Tout: bf16 or float, the type dk and dv are stored in (the f32 instance
// stores the same accumulators unrounded).  kRecord: the check-only
// instance, which also writes every (q row, key) pair's p and ds, rounded
// to bf16 as they entered the products, to p_rec and ds_rec [BH, T, T] at
// [bh, q row, key] (zeroed by the caller; pairs a warp skips stay 0); no
// training or serving path launches it.
template <int D, typename Tout, bool kRecord>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fused_bwd_tc_kernel(const dtx::bf16* __restrict__ q, const dtx::bf16* __restrict__ k,
                          const dtx::bf16* __restrict__ v, const dtx::bf16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          float* __restrict__ ws, Tout* __restrict__ dk, Tout* __restrict__ dv,
                          dtx::bf16* __restrict__ p_rec, dtx::bf16* __restrict__ ds_rec, int t,
                          int causal, float qscale, float scale) {
  static_assert(D % 32 == 0, "head dim must be 32, 64 or 128");
  using dtx::bf16;
  constexpr int S = tc_stride<D>();
  // q columns of s^T and dp^T held at once: 16 at D = 128, where dk and dv
  // already take 128 registers a thread, 32 below.
  constexpr int kQChunk = D == 128 ? 16 : 32;
  constexpr int kChunks = D / 8;          // 16-byte chunks a row
  constexpr int kDepth = D / 16;          // k-steps of s^T and dp^T
  constexpr int kDTiles = D / 8;          // 16x8 tiles of dk, dv a warp
  constexpr int kSTiles = kQChunk / 8;    // 16x8 tiles of s^T a chunk
  constexpr int kDqTiles = D / 16;        // 16x8 tiles of dq a warp (16 rows x D/2)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kGroup][S]
  bf16* vs = ks + kGroup * S;                    // [kGroup][S]
  bf16* qs = vs + kGroup * S;                    // [2][kQTile][S], folded
  bf16* dos = qs + 2 * kQTile * S;               // [2][kQTile][S]
  bf16* dst = dos + 2 * kQTile * S;              // ds^T [kGroup][kDsStride]
  float* lse_s = reinterpret_cast<float*>(dst + kGroup * kDsStride);  // [2][kQTile]
  float* delta_s = lse_s + 2 * kQTile;                                // [2][kQTile]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int bh = blockIdx.x;
  const int n_bh = gridDim.x;
  const int slice = blockIdx.y;
  const int n_slices = gridDim.y;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const size_t row_base = static_cast<size_t>(bh) * t;
  float* my_ws = ws + (static_cast<size_t>(slice) * n_bh + bh) * t * D;

  const float qc = __bfloat162float(__float2bfloat16_rn(qscale));
  const float log2e = static_cast<float>(kLog2eD);
  const float inv_log2e = static_cast<float>(1.0 / kLog2eD);
  const int nq = (t + kQTile - 1) / kQTile;
  const int ng = (t + kGroup - 1) / kGroup;
  const int rounds = (ng + n_slices - 1) / n_slices;

  // q, do, lse, delta of q tile qi into ring stage `stage`.
  auto load_q = [&](int qi, int stage) {
    const int q0 = qi * kQTile;
    for (int i = tid; i < kQTile * kChunks; i += kTcThreads) {
      const int r = i / kChunks, col = (i % kChunks) * 8, row = q0 + r;
      const bool in = row < t;
      const size_t off = base + static_cast<size_t>(in ? row : 0) * D + col;
      const int at = (stage * kQTile + r) * S + col;
      dtx::cp_async16(qs + at, q + off, in);
      dtx::cp_async16(dos + at, dout + off, in);
    }
    if (tid < 2 * kQTile) {
      const int r = tid % kQTile, row = q0 + r;
      const bool in = row < t;
      const float* src = (tid < kQTile ? lse : delta) + row_base + (in ? row : 0);
      float* to = (tid < kQTile ? lse_s : delta_s) + stage * kQTile + r;
      dtx::cp_async4(to, src, in);
    }
  };
  // The q chunks this thread copied, folded in place once they have landed.
  auto fold_q = [&](int stage) {
    for (int i = tid; i < kQTile * kChunks; i += kTcThreads) {
      const int r = i / kChunks, col = (i % kChunks) * 8;
      uint4* p = reinterpret_cast<uint4*>(qs + (stage * kQTile + r) * S + col);
      *p = dtx::fold8(*p, qc);
    }
  };

  for (int r = 0; r < rounds; ++r) {
    const int gk = r * n_slices + ((r & 1) ? n_slices - 1 - slice : slice);
    if (gk >= ng) continue;
    const bool first = r == 0;  // stores into the slice; later groups add
    const int k0 = gk * kGroup;
    const int q_begin = causal ? k0 / kQTile : 0;  // start at the diagonal
    __syncthreads();  // the previous group's reads of ks, vs, dst are done
    for (int i = tid; i < kGroup * kChunks; i += kTcThreads) {
      const int rr = i / kChunks, col = (i % kChunks) * 8, row = k0 + rr;
      const bool in = row < t;
      const size_t off = base + static_cast<size_t>(in ? row : 0) * D + col;
      dtx::cp_async16(ks + rr * S + col, k + off, in);
      dtx::cp_async16(vs + rr * S + col, v + off, in);
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
      __syncthreads();  // the tile (and on a group's first visit k, v) landed, folded

      const int q0 = qi * kQTile;
      const bf16* qt = qs + stage * kQTile * S;
      const bf16* dot = dos + stage * kQTile * S;
      const float* lse_t = lse_s + stage * kQTile;
      const float* delta_t = delta_s + stage * kQTile;
      // A warp whose keys all lie past T or above the tile's last query
      // contributes exactly 0; only tiles that straddle the diagonal or a
      // ragged edge carry masked scores.
      const bool dead = key0 >= t || (causal && key0 > q0 + kQTile - 1);
      const bool masked = (causal && key0 + 15 > q0) || q0 + kQTile > t || key0 + 16 > t;
      if (dead) {
        for (int i = lane; i < 16 * kQTile / 8; i += 32) {
          const int rr = i / (kQTile / 8), col = (i % (kQTile / 8)) * 8;
          *reinterpret_cast<uint4*>(dst + (warp * 16 + rr) * kDsStride + col) =
              make_uint4(0u, 0u, 0u, 0u);
        }
      } else {
#pragma unroll 1
        for (int qc0 = 0; qc0 < kQTile; qc0 += kQChunk) {
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
              if constexpr (kRecord) {  // p^T and ds^T, written at [bh, q row, key]
                if (qpos < t && key < t) {
                  const size_t at = (row_base + qpos) * static_cast<size_t>(t) + key;
                  p_rec[at] = __float2bfloat16_rn(p);
                  ds_rec[at] = __float2bfloat16_rn(dpt[n][e]);
                }
              }
            }
          // dv += p^T.do and dk += ds^T.q, p and ds rounded to bf16 in
          // registers; ds^T also to shared memory for the dq product.
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
            bf16* drow = dst + (warp * 16 + g) * kDsStride + qc0 + kk * 16 + 2 * c;
            *reinterpret_cast<uint32_t*>(drow) = ad[0];
            *reinterpret_cast<uint32_t*>(drow + 8 * kDsStride) = ad[1];
            *reinterpret_cast<uint32_t*>(drow + 8) = ad[2];
            *reinterpret_cast<uint32_t*>(drow + 8 * kDsStride + 8) = ad[3];
          }
        }
      }
      __syncthreads();  // ds^T is whole, and every warp is done with the stage

      // dq[q rows] (+)= (ds.k) * scale for the whole group: warp w takes q
      // rows 16 (w % 4).., columns (w / 4) D/2..; one read-modify-write of
      // the slice a (q tile, k group).
      {
        const int m0 = (warp % 4) * 16, n0 = (warp / 4) * (D / 2);
        float dq[kDqTiles][4];
#pragma unroll
        for (int n = 0; n < kDqTiles; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
        // Lanes c and c ^ 1 will swap halves so that each holds four
        // neighbouring columns of one row: even c row g, odd c row g + 8.
        // The slice's running values for those columns are loaded first,
        // so their latency hides behind the product.
        const bool odd = c & 1;
        const int row = q0 + m0 + g + (odd ? 8 : 0);
        float4* out = reinterpret_cast<float4*>(my_ws + static_cast<size_t>(row) * D + n0 +
                                                2 * (c & ~1));
        float4 was[kDqTiles];
#pragma unroll
        for (int n = 0; n < kDqTiles; ++n)
          was[n] = !first && row < t ? out[2 * n] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int kk = 0; kk < kGroup / 16; ++kk) {
          uint32_t a[4];
          dtx::ldsm_x4_trans(a, dst + (kk * 16 + lane % 8 + 8 * (lane / 16)) * kDsStride + m0 +
                                    8 * ((lane / 8) % 2));
          const int brow = kk * 16 + lane % 8 + 8 * ((lane / 8) % 2);
#pragma unroll
          for (int np = 0; np < kDqTiles / 2; ++np) {
            uint32_t b[4];
            dtx::ldsm_x4_trans(b, ks + brow * S + n0 + np * 16 + 8 * (lane / 16));
            dtx::mma_bf16(dq[2 * np], a, b[0], b[1]);
            dtx::mma_bf16(dq[2 * np + 1], a, b[2], b[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < kDqTiles; ++n) {
          const float x0 = dq[n][0] * scale, x1 = dq[n][1] * scale;
          const float x2 = dq[n][2] * scale, x3 = dq[n][3] * scale;
          const float y0 = __shfl_xor_sync(0xffffffffu, odd ? x0 : x2, 1);
          const float y1 = __shfl_xor_sync(0xffffffffu, odd ? x1 : x3, 1);
          float4 val = odd ? make_float4(y0, y1, x2, x3) : make_float4(x0, x1, y0, y1);
          if (!first)
            val = make_float4(was[n].x + val.x, was[n].y + val.y, was[n].z + val.z,
                              was[n].w + val.w);
          if (row < t) out[2 * n] = val;
        }
      }
    }

#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      const int key = key0 + g + 8 * r2;
      if (key >= t) continue;
      const size_t off = base + static_cast<size_t>(key) * D + 2 * c;
#pragma unroll
      for (int n = 0; n < kDTiles; ++n) {
        dtx::store2(dk + off + n * 8, dk_acc[n][2 * r2] * inv_log2e,
                    dk_acc[n][2 * r2 + 1] * inv_log2e);
        dtx::store2(dv + off + n * 8, dv_acc[n][2 * r2], dv_acc[n][2 * r2 + 1]);
      }
    }
  }
}

// dq = sum over the slices that hold each row, in the order 0..S-1, cast
// to Tout.  A slice holds the rows from its first k tile or group on
// (own_rows rows each: 64 for the CUDA-core kernel, kGroup for the
// tensor-core one) when causal, all rows otherwise.  Four consecutive
// elements (one row, D % 4 == 0) a thread.
template <typename Tout>
__global__ void __launch_bounds__(256)
fused_dq_reduce_kernel(const float* __restrict__ ws, Tout* __restrict__ dq,
                       long long n4, long long stride, int t, int d, int slices,
                       int causal, int own_rows) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       i < n4; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long e = 4 * i;
    const int row = static_cast<int>((e / d) % t);
    const int last = causal ? min(slices - 1, row / own_rows) : slices - 1;
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
  void* p_rec = nullptr;   // the check-only instance's [BH, T, T] bf16 records
  void* ds_rec = nullptr;
};

template <typename Tout, int D>
cudaError_t launch_reduce(const Args& a, int own_rows) {
  const long long n4 = static_cast<long long>(a.bh) * a.t * D / 4;
  const long long blocks = (n4 + 255) / 256;
  const int grid_r = static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
  fused_dq_reduce_kernel<Tout><<<grid_r, 256, 0, a.stream>>>(
      static_cast<const float*>(a.ws), static_cast<Tout*>(a.dq), n4,
      static_cast<long long>(a.bh) * a.t * D, a.t, D, a.slices, a.causal, own_rows);
  return cudaGetLastError();
}

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
  const dim3 grid(a.bh, a.slices);
  kernel<<<grid, kThreads, smem, a.stream>>>(
      static_cast<const Tin*>(a.q), static_cast<const Tin*>(a.k),
      static_cast<const Tin*>(a.v), static_cast<const Tin*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.ws), static_cast<Tout*>(a.dk), static_cast<Tout*>(a.dv),
      a.t, a.causal, dtx::fold_scale<D>(),
      static_cast<float>(dtx::rsqrt_d<D>()));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<Tout, D>(a, kBlock);
}

template <int D, typename Tout, bool kRecord>
cudaError_t launch_tc(const Args& a) {
  const size_t smem = tc_smem_bytes<D>();
  auto kernel = flash_fused_bwd_tc_kernel<D, Tout, kRecord>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, a.slices);
  kernel<<<grid, kTcThreads, smem, a.stream>>>(
      static_cast<const dtx::bf16*>(a.q), static_cast<const dtx::bf16*>(a.k),
      static_cast<const dtx::bf16*>(a.v), static_cast<const dtx::bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.ws), static_cast<Tout*>(a.dk), static_cast<Tout*>(a.dv),
      static_cast<dtx::bf16*>(a.p_rec), static_cast<dtx::bf16*>(a.ds_rec), a.t, a.causal,
      dtx::fold_scale<D>(), static_cast<float>(dtx::rsqrt_d<D>()));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce<Tout, D>(a, kGroup);
}

// The tensor-core kernel at head dim d, storing Tout.
template <typename Tout>
cudaError_t launch_tc_d(const Args& a, int d) {
  switch (d) {
    case 32: return launch_tc<32, Tout, false>(a);
    case 64: return launch_tc<64, Tout, false>(a);
    case 128: return launch_tc<128, Tout, false>(a);
    default: return cudaErrorInvalidValue;
  }
}

// The CUDA-core kernel at head dim d.
template <typename Tin, typename Tout>
cudaError_t launch_d(const Args& a, int d) {
  switch (d) {
    case 32: return launch<Tin, Tout, 32>(a);
    case 64: return launch<Tin, Tout, 64>(a);
    case 128: return launch<Tin, Tout, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

// Whether slices fits the kernel these dtypes take: at least 1, at most
// the number of its k groups (bf16 in: 128 rows; f32 in: 64-row tiles).
bool slices_fit(int t, int slices, bool tc) {
  const int own_rows = tc ? kGroup : kBlock;
  return slices >= 1 && slices <= (t + own_rows - 1) / own_rows;
}

}  // namespace

// The kernel a launch with these dtype codes (0 = float32, 1 = bfloat16)
// takes: 1, the tensor-core kernel (bf16 in, bf16 or f32 out), or 0, the
// CUDA-core one (f32 in).  tiles gets that kernel's {q rows a visit, k rows
// a block owns at once}: the k rows are also what a workspace slice's first
// group covers.  The wrapper counts tensor-core launches by it; the checks
// hold the plain version's tiles to it.
extern "C" int dtx_flash_fused_bwd_route(int in_dtype, int out_dtype, int* tiles) {
  const int tc = dtx::tc_route(in_dtype, out_dtype);
  tiles[0] = tc ? kQTile : kBlock;
  tiles[1] = tc ? kGroup : kBlock;
  return tc;
}

// dtype codes: 0 = float32, 1 = bfloat16 (q, k, v and do share in_dtype;
// dq, dk and dv share out_dtype).  ws is an f32 [slices, bh, t, d]
// workspace the caller allocates; it needs no initial value.  slices is at
// most the number of k groups (bf16 in: 128 rows; f32 in: 64-row tiles).
// bf16 operands must be 16-byte aligned (the wrapper checks).  Returns the
// launches' cudaError_t (0 = success); the caller raises on anything else.
extern "C" int dtx_flash_fused_bwd(const void* q, const void* k, const void* v,
                                   const void* dout, const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, void* ws, int bh, int t,
                                   int d, int slices, int in_dtype, int out_dtype,
                                   int causal, void* stream) {
  const bool tc = dtx::tc_route(in_dtype, out_dtype);
  if (bh < 1 || t < 1 || !slices_fit(t, slices, tc)) return cudaErrorInvalidValue;
  const Args a{q, k, v, dout, lse, delta, dq, dk, dv, ws, bh, t, slices, causal,
               static_cast<cudaStream_t>(stream)};
  if (tc) return out_dtype == 1 ? launch_tc_d<dtx::bf16>(a, d) : launch_tc_d<float>(a, d);
  if (in_dtype == 0 && out_dtype == 0) return launch_d<float, float>(a, d);
  if (in_dtype == 0 && out_dtype == 1) return launch_d<float, __nv_bfloat16>(a, d);
  return cudaErrorInvalidValue;
}

// The check-only instance: bf16 in, f32 out, head dim 32 or 64 (the shapes
// its check runs at: the records are T^2 a head), the f32-out tensor-core
// kernel's arithmetic (the same slices and reduction), and besides every
// visited (q row, key) pair's bf16-rounded p and ds written to p_rec and
// ds_rec [BH, T, T] (zeroed by the caller).
extern "C" int dtx_flash_fused_bwd_record(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dq, void* dk, void* dv, void* ws, void* p_rec,
                                          void* ds_rec, int bh, int t, int d, int slices,
                                          int causal, void* stream) {
  if (bh < 1 || t < 1 || !slices_fit(t, slices, true) || !p_rec || !ds_rec)
    return cudaErrorInvalidValue;
  Args a{q, k, v, dout, lse, delta, dq, dk, dv, ws, bh, t, slices, causal,
         static_cast<cudaStream_t>(stream)};
  a.p_rec = p_rec;
  a.ds_rec = ds_rec;
  switch (d) {
    case 32: return launch_tc<32, float, true>(a);
    case 64: return launch_tc<64, float, true>(a);
    default: return cudaErrorInvalidValue;
  }
}

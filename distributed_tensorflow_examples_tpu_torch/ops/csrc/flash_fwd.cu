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
// What bounds it.  At the serving shape [16, 2048, 128] bf16 causal one
// call does 2 products x 2*BH*T(T+1)/2*D = 17.2 GFLOP, 17.4 us at
// 989 TFLOP/s bf16, and moves 33.6 MB of q/k/v/o, 10 us at 3.35 TB/s:
// compute-bound, and only the tensor cores reach that rate (the CUDA
// cores' f32 peak, 67 TFLOP/s, puts the same work at 0.26 ms).
//
// bf16 in and out (every serving and training path): flash_fwd_tc_kernel,
// the products on the tensor cores.
// - A block of 256 threads (8 warps) per (bh, 128-row q block); warp w owns
//   q rows 16w..16w+15.  The q block is loaded once, folded (x the scale,
//   rounded to bf16, exactly as the f32 kernel and the JAX fold round it)
//   and kept in registers as mma A fragments for the whole k loop.
// - k and v stream in 64-row bf16 tiles through a two-stage ring filled by
//   16-byte cp.async (zero fill past T): tile j+1 lands while tile j is in
//   the products, and each k/v byte loaded serves 128 q rows.  Rows are
//   padded by 16 bytes so ldmatrix reads hit 32 distinct banks.
// - s = q.k^T by mma.sync.m16n8k16 (bf16 in, f32 accumulate) into
//   registers; the row max and row sum stay in registers, reduced across
//   the four lanes that share a row with __shfl_xor_sync; p is rounded to
//   bf16 in registers and is the A operand of p.v as it stands (the C
//   layout of two 16x8 score tiles is the A layout of one 16x16 tile); v's
//   B fragments come from ldmatrix.trans, so no tile is transposed.  o
//   stays in f32 registers until the epilogue.
// - Causal: tiles above the diagonal are never visited (the block's loop
//   stops at its last row's tile, a warp skips the tiles above its own
//   rows); only tiles that straddle a warp's diagonal and a ragged last
//   tile are masked.  Heavy q blocks (high index) are scheduled first.
// - Registers: o 64 + s 32 + q 32 f32/b32 a thread at D = 128; one block
//   (8 warps) an SM.  104,448 bytes of shared memory at D = 128.
// - mma.sync (the Ampere instruction, which Hopper runs at a fraction of
//   its wgmma rate) rather than wgmma: its fragments live in registers
//   with a documented layout, so the online softmax, the masks and the
//   rounding of p stay plain per-thread code.  The same structure on
//   wgmma (two warpgroups of 64 rows, q and k as no-swizzle shared
//   operands, p from registers, a wait after each product) ran no faster
//   on the card: each warpgroup waits on its products between softmax
//   steps.  The gain needs the softmax of one tile to overlap the next
//   tile's products, swizzled TMA tiles and warp specialisation (ROADMAP
//   B1).
//
// f32 in, or f32 out: flash_fwd_kernel, products on the CUDA cores in f32
// (4x4 register tiles from f32 shared memory), 64x64 tiles.  No training
// or serving path asks for either (ring partials and tests do), and both
// are held to the f32 tolerance (1e-4 on o), which only scores equal to
// the plain version's bit for bit can meet: TF32 products would miss it
// outright, and bf16 tensor-core sums, whose order differs from a
// sequential f32 one, move s by ~1e-7 relative, enough to flip a p across
// a bf16 rounding boundary now and then, and each flip moves o by 2^-8 of
// that term (up to ~5e-4 at [8, 2048, 128]).  The CUDA-core kernel's
// sequential f32 sums give the plain version's s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "tc_sm90.cuh"

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

// The f32 kernel's shared memory.  At D = 128 this is 115,712 bytes: two
// blocks fill an SM's 228 KB exactly (with the 1 KB each block reserves).
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


// ---------------------------------------------------------------------------
// bf16 in: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kTcBlockQ = 128;  // q rows a block (FWD_BLOCK_Q), 16 a warp
constexpr int kTcBlockK = 64;   // k/v rows a tile (FWD_BLOCK_K)
using dtx::kTcThreads;
using dtx::tc_stride;

template <int D>
constexpr size_t tc_smem_bytes() {
  return (size_t(kTcBlockQ) + 4 * size_t(kTcBlockK)) * tc_stride<D>() * sizeof(dtx::bf16);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const dtx::bf16* __restrict__ q, const dtx::bf16* __restrict__ k,
                    const dtx::bf16* __restrict__ v, dtx::bf16* __restrict__ o,
                    float* __restrict__ lse, int t, int causal, float qscale) {
  static_assert(D % 32 == 0, "head dim must be 32, 64 or 128");
  using dtx::bf16;
  constexpr int S = tc_stride<D>();
  constexpr int kChunks = D / 8;           // 16-byte chunks a row
  constexpr int kDepth = D / 16;           // k-steps of q.k^T
  constexpr int kOTiles = D / 8;           // 16x8 tiles of o a warp
  constexpr int kSTiles = kTcBlockK / 8;   // 16x8 tiles of s a warp

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kTcBlockQ][S]
  bf16* ks = qs + kTcBlockQ * S;                 // [2][kTcBlockK][S]
  bf16* vs = ks + 2 * kTcBlockK * S;             // [2][kTcBlockK][S]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, c = lane % 4;
  const int bh = blockIdx.x;
  const int qb = static_cast<int>(gridDim.y) - 1 - static_cast<int>(blockIdx.y);  // heavy first
  const int q0 = qb * kTcBlockQ;
  const size_t base = static_cast<size_t>(bh) * t * D;
  const int nk = (t + kTcBlockK - 1) / kTcBlockK;
  const int q_last = min(t, q0 + kTcBlockQ) - 1;
  const int k_end = causal ? min(nk, q_last / kTcBlockK + 1) : nk;  // never above the diagonal

  auto load_kv = [&](int j, int stage) {
    const int k0 = j * kTcBlockK;
    for (int i = tid; i < kTcBlockK * kChunks; i += kTcThreads) {
      const int r = i / kChunks, col = (i % kChunks) * 8, row = k0 + r;
      const bool in = row < t;
      const size_t off = base + static_cast<size_t>(in ? row : 0) * D + col;
      const int dst = (stage * kTcBlockK + r) * S + col;
      dtx::cp_async16(ks + dst, k + off, in);
      dtx::cp_async16(vs + dst, v + off, in);
    }
  };
  load_kv(0, 0);
  dtx::cp_async_commit();

  // The q block, folded once: x * round(qscale), rounded to bf16 (zero
  // past T), as the f32 kernel and the JAX wrapper fold it.
  const float qc = __bfloat162float(__float2bfloat16_rn(qscale));
  for (int i = tid; i < kTcBlockQ * kChunks; i += kTcThreads) {
    const int r = i / kChunks, col = (i % kChunks) * 8, row = q0 + r;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row < t) raw = *reinterpret_cast<const uint4*>(q + base + static_cast<size_t>(row) * D + col);
    *reinterpret_cast<uint4*>(qs + r * S + col) = dtx::fold8(raw, qc);
  }
  __syncthreads();

  const int wrow = warp * 16;  // the warp's first row in the block
  uint32_t qf[kDepth][4];
#pragma unroll
  for (int kk = 0; kk < kDepth; ++kk)
    dtx::ldsm_x4(qf[kk], qs + (wrow + lane % 8 + 8 * ((lane / 8) % 2)) * S + kk * 16 + 8 * (lane / 16));

  float acc[kOTiles][4];
#pragma unroll
  for (int n = 0; n < kOTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {kNegInf, kNegInf};  // rows g and g + 8
  float l_r[2] = {0.f, 0.f};          // this lane's part of the row sums
  const int row_a = q0 + wrow + g;    // row of c0, c1; row_a + 8 holds c2, c3
  const int warp_last = q0 + wrow + 15;
  const bool warp_live = q0 + wrow < t;

  for (int j = 0; j < k_end; ++j) {
    if (j + 1 < k_end) {
      load_kv(j + 1, (j + 1) & 1);
      dtx::cp_async_commit();
      dtx::cp_async_wait<1>();
    } else {
      dtx::cp_async_wait<0>();
    }
    __syncthreads();  // tile j has landed for every thread
    const int k0 = j * kTcBlockK;
    if (warp_live && !(causal && k0 > warp_last)) {
      const bf16* kt = ks + (j & 1) * kTcBlockK * S;
      const bf16* vt = vs + (j & 1) * kTcBlockK * S;

      // s = q.k^T (base-2 logits), 16 rows x 64 keys a warp.
      float s[kSTiles][4];
#pragma unroll
      for (int n = 0; n < kSTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kDepth; ++kk) {
#pragma unroll
        for (int np = 0; np < kSTiles / 2; ++np) {
          uint32_t b[4];
          dtx::ldsm_x4(b, kt + (np * 16 + lane % 8 + 8 * (lane / 16)) * S + kk * 16 +
                              8 * ((lane / 8) % 2));
          dtx::mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
          dtx::mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
        }
      }
      // Only tiles that straddle this warp's diagonal and a ragged last
      // tile carry masked scores.
      const bool masked = (causal && k0 + kTcBlockK - 1 > q0 + wrow) || (k0 + kTcBlockK > t);
      if (masked) {
#pragma unroll
        for (int n = 0; n < kSTiles; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kpos = k0 + n * 8 + 2 * c + (e & 1);
            const int row = row_a + 8 * (e / 2);
            if (kpos >= t || (causal && kpos > row)) s[n][e] = kNegInf;
          }
      }
      // Online softmax: the row max over the four lanes of a row.
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kSTiles; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
      float alpha[2], m_new[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        m_new[r] = fmaxf(m_r[r], mx[r]);
        alpha[r] = exp2f(m_r[r] - m_new[r]);
        m_r[r] = m_new[r];
      }
#pragma unroll
      for (int n = 0; n < kSTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[n][e];
          float p = exp2f(x - m_new[e / 2]);
          if (masked && !(x > 0.5f * kNegInf)) p = 0.f;  // fully masked rows add 0
          sum[e / 2] += p;
          s[n][e] = p;
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + sum[r];
#pragma unroll
      for (int n = 0; n < kOTiles; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      // o += p.v: p rounded to bf16 in registers, v through ldmatrix.trans.
#pragma unroll
      for (int kk = 0; kk < kTcBlockK / 16; ++kk) {
        const uint32_t a[4] = {
            dtx::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
            dtx::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
            dtx::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            dtx::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]),
        };
#pragma unroll
        for (int np = 0; np < kOTiles / 2; ++np) {
          uint32_t b[4];
          dtx::ldsm_x4_trans(b, vt + (kk * 16 + lane % 8 + 8 * ((lane / 8) % 2)) * S + np * 16 +
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
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(0xffffffffu, l_r[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= t) continue;
    const float l = fmaxf(l_r[r], 1e-30f);
    bf16* orow = o + base + static_cast<size_t>(row) * D;
#pragma unroll
    for (int n = 0; n < kOTiles; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * c) =
          dtx::pack_bf16(acc[n][2 * r] / l, acc[n][2 * r + 1] / l);
    if (c == 0) lse[static_cast<size_t>(bh) * t + row] = m_r[r] * kLn2 + logf(l);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                      int t, int causal, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<D>();
  auto kernel = flash_fwd_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (t + kTcBlockQ - 1) / kTcBlockQ);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const dtx::bf16*>(q), static_cast<const dtx::bf16*>(k),
      static_cast<const dtx::bf16*>(v), static_cast<dtx::bf16*>(o), static_cast<float*>(lse), t,
      causal, dtx::fold_scale<D>());
  return cudaGetLastError();
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
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const Tin*>(q), static_cast<const Tin*>(k), static_cast<const Tin*>(v),
      static_cast<Tout*>(o), static_cast<float*>(lse), t, causal, dtx::fold_scale<D>());
  return cudaGetLastError();
}

// The tensor-core kernel at head dim d.
cudaError_t launch_tc_d(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                        int t, int d, int causal, cudaStream_t stream) {
  switch (d) {
    case 32: return launch_tc<32>(q, k, v, o, lse, bh, t, causal, stream);
    case 64: return launch_tc<64>(q, k, v, o, lse, bh, t, causal, stream);
    case 128: return launch_tc<128>(q, k, v, o, lse, bh, t, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The CUDA-core kernel at head dim d.
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

// The kernel a launch with these dtype codes (0 = float32, 1 = bfloat16)
// takes: 1, the tensor-core kernel (bf16 in and out), or 0, the CUDA-core
// one.  tiles gets that kernel's {q rows a block, k rows a tile}.  The
// wrapper counts tensor-core launches by it; the checks hold the plain
// version's tiles to it.
extern "C" int dtx_flash_fwd_route(int in_dtype, int out_dtype, int* tiles) {
  const int tc = dtx::tc_route(in_dtype, out_dtype);
  tiles[0] = tc ? kTcBlockQ : kBlockQ;
  tiles[1] = tc ? kTcBlockK : kBlockK;
  return tc;
}

// dtype codes: 0 = float32, 1 = bfloat16.  bf16 operands must be 16-byte
// aligned (the wrapper checks).  Returns the launch's cudaError_t
// (0 = success); the caller raises on anything else.
extern "C" int dtx_flash_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, int bh, int t, int d, int in_dtype,
                             int out_dtype, int causal, void* stream) {
  if (bh < 1 || t < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtx::tc_route(in_dtype, out_dtype))
    return launch_tc_d(q, k, v, o, lse, bh, t, d, causal, s);
  if (in_dtype == 0 && out_dtype == 0)
    return launch_d<float, float>(q, k, v, o, lse, bh, t, d, causal, s);
  if (in_dtype == 1 && out_dtype == 0)
    return launch_d<__nv_bfloat16, float>(q, k, v, o, lse, bh, t, d, causal, s);
  if (in_dtype == 0 && out_dtype == 1)
    return launch_d<float, __nv_bfloat16>(q, k, v, o, lse, bh, t, d, causal, s);
  return cudaErrorInvalidValue;
}

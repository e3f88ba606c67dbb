// BatchNorm statistics for Hopper (sm_90a), with a plain C interface.
//
// Replaces the Pallas TPU kernels of
// distributed_tensorflow_examples_tpu/ops/bn.py:
// - _stats_kernel (bn_stats, B6): per-channel sum(x) and sum(x*x) in f32,
//   one pass over x;
// - _bwd_stats_kernel (bn_bwd_stats, B7): s1 = sum(dy) and s2 = sum(dy*xhat)
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
// [256, 112, 112, 64] bf16 the forward reads 411 MB (0.1227 ms at
// 3.35 TB/s), the backward 822 MB (0.245 ms).  Over the 53 BatchNorm shapes
// of a training step the forward's bound is 1.70 ms, and 28 of the shapes
// are bound under 16 us each: there a call's fixed costs (a second launch,
// the tail after the stream, the wrapper's host work) weigh as much as
// the stream itself.
//
// B6: one launch a call (bn_stats_onepass).
// - A persistent grid: one block of 1024 threads on each SM (the wrapper
//   sizes the grid to the card's SMs), the blocks being channel strips x
//   row ranges.  A strip is gs <= 32 groups of VEC channels: with 16-byte
//   loads a 512-byte slice of a row, all of it for C <= 256 bf16 or
//   C <= 128 f32, so that there a block's rows are one contiguous range of
//   memory.  Thread t takes group t % gs of the strip and row lane t / gs;
//   a step of the block reads lanes = 1024 / gs consecutive rows, 16 KB,
//   one 16-byte chunk a thread.
// - The read streams through a shared-memory ring of kStages 16 KB
//   stages (seven in flight while one is summed: 112 KB an SM, about four
//   times what 3.35 TB/s x ~1 us of latency over 132 SMs asks), filled by
//   cp.async: every thread copies its own chunk of each step with a
//   16-byte cp.async, one commit group a step, and waits for its own
//   oldest group, so the loop has no block-wide barrier.  (A ring filled
//   by 1-D TMA bulk copies, warp 0 issuing them against "full" and
//   "empty" mbarriers, tied at the stem and took 40% more kernel time over
//   a training step's 53 shapes; PERF.md keeps its times.)
//   Where C is not a multiple of 16 bytes' worth of the dtype the loads
//   fall back to one element, four rows in flight, from registers.
// - The tail.  Sums stay in f32 registers.  The row lanes of a warp fold
//   by shuffles (a fixed xor tree), the 32 warps through shared memory in
//   order, and the block writes one partial a (quantity, channel) to the
//   f32 workspace ws[S][2][C] at its row range's index.  Every writer
//   fences, then thread 0 draws a ticket for the strip; the block that
//   draws the last one sums the strip's partials in a fixed order (the
//   lanes of a quad of channels each add every per-th row range, eight
//   16-byte loads issued before any is added, then the lanes in order;
//   one channel a lane without 16-byte loads) and writes out[2][C].  The
//   eight float4 take 32 of the 64 registers a thread has in a block of
//   1024 (chip_smoke.py's build check fails on a spill here).  With one block on each
//   SM that read is up to S x 2 x 256 f32 (270 KB at S = 132) from L2 into
//   one SM, a fixed cost that the small wide shapes feel most.  The atomic
//   picks which block sums, never the order, and no atomic touches a sum:
//   a run gives the bits of the last one.
// - The tickets: one unsigned a strip, in a buffer the wrapper keeps for
//   each (device, stream), zero when made; the block that draws the last
//   ticket of a strip sets it back to 0 before it ends.  Calls on one
//   stream run one after another, so each starts from zeros; calls on two
//   streams use two buffers, so no ticket is shared without an order
//   between its users.  (A CUDA graph replayed on another stream while
//   eager calls run on its capture stream would break that; the port
//   captures none.)
// - Any M and any C: the ragged channel strip is masked (its idle threads
//   add nothing) and the last step of a row range reads only its rows.
//
// B7: two launches a call, as ported (simple first; the TPU's (bn, bh, W,
// C) VMEM blocking is not carried over).
// - Pass 1 (bn_bwd_stats_partial): a block of 256 threads owns a strip of
//   channels and a range of rows.  Threads along the strip read
//   neighbouring channels, VEC at a time (16-byte loads when C and the
//   pointers allow: 8 bf16 or 4 f32), so a warp reads whole contiguous
//   rows; threads across the strip take every ty_n-th row of the range,
//   four rows per iteration with the loads issued first.  Sums stay in f32
//   registers, then the block combines its row lanes in shared memory in a
//   fixed order and writes one partial per channel to an [S, C] f32
//   workspace (S = row ranges).
// - Pass 2 (bn_stats_finalize): one thread per (channel, lane) sums every
//   8th partial, and the 8 lanes combine in a fixed order.  No atomics
//   anywhere, so a run gives the same bits as the last one.
// - Any M and any C: the ragged channel strip is masked, VEC falls back to
//   1 where C is not a multiple of it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kFinalLanes = 8;
constexpr int kFinalChannels = kThreads / kFinalLanes;  // 32
constexpr int kUnroll = 4;

// B6's block and its ring.
constexpr int kStatsThreads = 1024;
constexpr int kStatsWarps = kStatsThreads / 32;
constexpr int kStages = 8;
constexpr int kStageBytes = kStatsThreads * 16;  // one 16-byte chunk a thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of T widened to f32.  A bf16 widens exactly by moving its 16
// bits to the top of an f32; element 2i is the low half of word i.
template <typename T, int VEC>
__device__ __forceinline__ void widen(const uint4 raw, float (&out)[VEC]) {
  static_assert(sizeof(T) * VEC == 16, "vector loads are 16 bytes");
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

// VEC consecutive elements at p, widened to f32 (p is 16-byte aligned
// when VEC > 1: the wrapper checks).
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, float (&out)[VEC]) {
  if constexpr (VEC == 1) {
    out[0] = to_f32(p[0]);
  } else {
    widen<T, VEC>(__ldg(reinterpret_cast<const uint4*>(p)), out);
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (src must still
// be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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

// B6's dynamic shared memory: the ring (16-byte loads), which then holds
// the warps' sums; without the ring, the warps' sums alone
// (2 x 32 warps x 32 * VEC channels, f32).
template <int VEC>
__host__ __device__ constexpr int stats_smem_bytes() {
  return VEC > 1 ? kStages * kStageBytes : 2 * kStatsWarps * 32 * VEC * 4;
}

// B6: sum(x) and sum(x*x) of one (channel strip, row range) of x, then,
// in the block that finishes its strip last, the strip's sums over every
// row range into out[0][ch] and out[1][ch].
template <typename T, int VEC>
__global__ void __launch_bounds__(kStatsThreads, 1)
bn_stats_onepass(const T* __restrict__ x, float* __restrict__ ws, unsigned* __restrict__ tickets,
                 float* __restrict__ out, long long m, int c, int gs, long long rows_per_split) {
  static_assert(VEC == 1 || 2 * kStatsWarps * 32 * VEC * 4 <= stats_smem_bytes<VEC>(),
                "the warps' sums fit in the ring");
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ unsigned last;
  const int t = threadIdx.x, g = t % gs, lane = t / gs, lanes = kStatsThreads / gs;
  const int warp = t / 32, wl = t % 32;
  const int strip = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int groups = (c + VEC - 1) / VEC;
  const int strip_groups = min(gs, groups - strip * gs);
  const int strip_c0 = strip * gs * VEC;
  const bool live = g < strip_groups;
  const long long r0 = static_cast<long long>(split) * rows_per_split;
  const long long r1 = r0 + rows_per_split < m ? r0 + rows_per_split : m;
  const long long steps = r1 > r0 ? (r1 - r0 + lanes - 1) / lanes : 0;
  const T* mine = x + (r0 + lane) * c + strip_c0 + g * VEC;  // this thread's row at step 0
  float s[VEC], ss[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) s[i] = ss[i] = 0.f;
  auto add = [&](const float (&v)[VEC]) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s[i] += v[i];
      ss[i] = fmaf(v[i], v[i], ss[i]);
    }
  };
  auto has_row = [&](long long k) { return live && r0 + k * lanes + lane < r1; };

  if constexpr (VEC == 1) {
    const long long step = static_cast<long long>(lanes) * c;
    long long k = 0;
    for (; has_row(k + kUnroll - 1); k += kUnroll) {
      float v[kUnroll][1];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) load_vec<T, 1>(mine + (k + u) * step, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add(v[u]);
    }
    for (; has_row(k); ++k) {
      float v[1];
      load_vec<T, 1>(mine + k * step, v);
      add(v);
    }
  } else {
    uint4* ring = reinterpret_cast<uint4*>(smem);
    const long long step = static_cast<long long>(lanes) * c;
    auto issue = [&](long long k) {
      if (k < steps) {
        const bool in = has_row(k);
        cp_async16(ring + (k % kStages) * kStatsThreads + t, in ? mine + k * step : x, in);
      }
      cp_async_commit();  // every step, so that wait_group counts steps
    };
#pragma unroll
    for (int k = 0; k < kStages - 1; ++k) issue(k);
    for (long long k = 0; k < steps; ++k) {
      issue(k + kStages - 1);
      cp_async_wait<kStages - 1>();  // this thread's copy of step k has landed
      if (has_row(k)) {
        float v[VEC];
        widen<T, VEC>(ring[(k % kStages) * kStatsThreads + t], v);
        add(v);
      }
    }
    cp_async_wait<0>();
  }

  // The warp's row lanes (lanes gs, 2gs, ... apart) by a fixed xor tree.
#pragma unroll
  for (int off = 16; off >= 1; off >>= 1) {
    if (off < gs) break;
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
      ss[i] += __shfl_xor_sync(0xffffffffu, ss[i], off);
    }
  }
  __syncthreads();  // the ring is drained: its memory takes the warps' sums
  // red[q][warp][u], u = i * gs + lane: a warp's stores hit 32 banks.
  const int w = gs * VEC;  // channels in a strip
  float* red = reinterpret_cast<float*>(smem);
  if (wl < gs) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      red[warp * w + i * gs + wl] = s[i];
      red[(kStatsWarps + warp) * w + i * gs + wl] = ss[i];
    }
  }
  __syncthreads();
  // The block's partial of column (q, u): its 32 warps in order, into
  // ws[split][q][ch].
  if (t < 2 * w) {
    const int q = t / w, u = t % w, ch = strip_c0 + (u % gs) * VEC + u / gs;
    float a = 0.f;
#pragma unroll 8
    for (int k = 0; k < kStatsWarps; ++k) a += red[(q * kStatsWarps + k) * w + u];
    if (ch < c) {
      ws[(static_cast<size_t>(split) * 2 + q) * c + ch] = a;
      __threadfence();  // visible to every block before the ticket
    }
  }
  __syncthreads();
  if (t == 0) last = atomicAdd(&tickets[strip], 1u) == static_cast<unsigned>(splits - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();

  // The last block of the strip: `per` lanes a quad of columns (a column
  // without 16-byte loads), lane p adding the partials of row ranges p,
  // p + per, ... in order, kBatch loads from L2 issued at once; then the
  // lanes in order.  kBatch float4 fit beside the sums in the 64 registers
  // of a thread of a 1024-thread block.
  constexpr int kBatch = 8;
  if constexpr (VEC > 1) {
    const int quads = w / 2, per = kStatsThreads / quads;  // 2w columns
    const int qd = t % quads, p = t / quads;
    const int q = qd / (w / 4), ch = strip_c0 + (qd % (w / 4)) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ch < c) {
      const float4* src = reinterpret_cast<const float4*>(ws + static_cast<size_t>(q) * c + ch);
      const size_t step = static_cast<size_t>(c) / 2;  // a row range's 2c floats
      for (int r = p; r < splits; r += kBatch * per) {
        float4 v[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          v[b] = r + b * per < splits ? __ldcg(src + (r + b * per) * step)
                                      : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          a.x += v[b].x;
          a.y += v[b].y;
          a.z += v[b].z;
          a.w += v[b].w;
        }
      }
    }
    float4* fold = reinterpret_cast<float4*>(smem);
    fold[p * quads + qd] = a;
    __syncthreads();
    if (t < quads && ch < c) {
      float4 total = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = 0; k < per; ++k) {
        const float4 f = fold[k * quads + t];
        total.x += f.x;
        total.y += f.y;
        total.z += f.z;
        total.w += f.w;
      }
      *reinterpret_cast<float4*>(out + static_cast<size_t>(q) * c + ch) = total;
    }
  } else {
    const int per = kStatsThreads / (2 * w);
    const int col = t % (2 * w), p = t / (2 * w);
    const int q = col / w, ch = strip_c0 + col % w;
    float a = 0.f;
    if (ch < c) {
      const float* src = ws + static_cast<size_t>(q) * c + ch;
      const size_t step = static_cast<size_t>(2) * c;
      for (int r = p; r < splits; r += kBatch * per) {
        float v[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          v[b] = r + b * per < splits ? __ldcg(src + (r + b * per) * step) : 0.f;
#pragma unroll
        for (int b = 0; b < kBatch; ++b) a += v[b];
      }
    }
    red[p * 2 * w + col] = a;
    __syncthreads();
    if (t < 2 * w && ch < c) {
      float total = 0.f;
      for (int k = 0; k < per; ++k) total += red[k * 2 * w + col];
      out[static_cast<size_t>(q) * c + ch] = total;
    }
  }
  if (t == 0) tickets[strip] = 0u;  // for the next call on this stream
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

// B7, pass 2: out_a[ch] = sum over splits of ws[0][.][ch], out_b from
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

// B6's launch geometry as the wrapper chose it (bn.py::stats_plan),
// checked before anything runs.
bool bad_stats_shape(long long m, int c, int vec, int gs, int splits, long long rows_per_split) {
  if (m < 1 || c < 1 || splits < 1 || splits > 65535 || rows_per_split < 1) return true;
  if (gs < 1 || gs > 32 || (gs & (gs - 1)) != 0 || c % vec != 0) return true;
  return rows_per_split * splits < m;
}

template <typename T, int VEC>
cudaError_t stats(const void* x, void* ws, void* tickets, void* out, long long m, int c, int gs,
                  int splits, long long rows_per_split, cudaStream_t stream) {
  auto kernel = bn_stats_onepass<T, VEC>;
  constexpr int smem = stats_smem_bytes<VEC>();
  // Above 48 KB of dynamic shared memory a kernel must be allowed it, once
  // on each device.
  static std::atomic<unsigned long long> allowed{0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (device & 63);
  if (!(allowed.load() & bit)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed.fetch_or(bit);
  }
  const int groups = (c + VEC - 1) / VEC;
  const int strips = (groups + gs - 1) / gs;
  kernel<<<dim3(strips, splits), kStatsThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(ws), static_cast<unsigned*>(tickets),
      static_cast<float*>(out), m, c, gs, rows_per_split);
  return cudaGetLastError();
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

// B6.  dtype codes: 0 = float32, 1 = bfloat16.  vec: 1, or 16 bytes' worth
// of the dtype (4 float32, 8 bfloat16).  gs: channel groups of vec a strip
// (a power of two, at most 32); the grid is (ceil(c / vec / gs), splits)
// blocks, block (strip, split) taking rows [split * rows_per_split, ...).
// ws: f32 [splits, 2, c] scratch.  tickets: one unsigned a strip, zero on
// entry and left zero (see the note).  out: f32 [2, c], sum(x) then
// sum(x*x).  Returns the launch's cudaError_t (0 = success); the caller
// raises on anything else.
extern "C" int dtx_bn_stats(const void* x, void* ws, void* tickets, void* out, long long m,
                            int c, int dtype, int vec, int gs, int splits,
                            long long rows_per_split, void* stream) {
  if (bad_stats_shape(m, c, vec, gs, splits, rows_per_split)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && vec == 1)
    return stats<float, 1>(x, ws, tickets, out, m, c, gs, splits, rows_per_split, s);
  if (dtype == 0 && vec == 4)
    return stats<float, 4>(x, ws, tickets, out, m, c, gs, splits, rows_per_split, s);
  if (dtype == 1 && vec == 1)
    return stats<__nv_bfloat16, 1>(x, ws, tickets, out, m, c, gs, splits, rows_per_split, s);
  if (dtype == 1 && vec == 8)
    return stats<__nv_bfloat16, 8>(x, ws, tickets, out, m, c, gs, splits, rows_per_split, s);
  return cudaErrorInvalidValue;
}

// B7.  do and x share the dtype and the [m, c] layout; mean, inv, scale,
// bias are f32 [c]; s1, s2 f32 [c]; ws f32 [2, splits, c] scratch; tx_n,
// splits and rows_per_split from bn.py::launch_shape.  dtype and vec as
// for dtx_bn_stats.
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

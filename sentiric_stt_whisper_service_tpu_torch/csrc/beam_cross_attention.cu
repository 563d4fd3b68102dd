// K6: beam cross-attention, the K beam queries of an item against its shared
// KF-layout cross slab [B, H, 64, F], in one of three forms:
//   * bf16 slab
//   * int8 slab with per-position scales
//   * packed int4 slab with per-position scales: byte j of a row holds
//     position j in its low nibble and position j + F/2 in its high nibble
//
// Replaces the Pallas TPU kernel ops/beam_attention.py:_cross_kernel, launched
// by beam_cross_attention (pallas_call at ops/beam_attention.py:333). The
// plain PyTorch version is ops/beam_attention.py:beam_cross_attention_reference
// in this package. It follows the numerics of the JAX package's
// models/whisper.py:_attend_xa, the function its beam step calls:
//   score[m, f] = (q[m] . k[:, f]) * scale * k_scale[f]
//   w[m, f]     = softmax_f(score[m])[f] * v_scale[f]        (fp32)
//   out[m, d]   = sum_f w[m, f] * v[d, f]                     (fp32, stored bf16)
//
// Bound on the H100: device memory. An (item, head) reads its slab once for
// 4 * K flops per slab element, far below the ridge point; at the beam
// slice's shape (4 items x 20 heads, 5 beams, packed int4 at F = 1500) that
// is 3.9 MB of carrier plus 1 MB of scales, 0.0026 ms at 3.35 TB/s. What
// keeps a kernel from that is too few bytes in flight: one block per
// (item, head) is 80 blocks on 132 SMs, each loading a byte per thread.
//
// Design: a cluster of four blocks per (item, head), 320 blocks, which split d,
// not positions. Block r owns rows d in [16r, 16r + 16) of K and of V: for each
// tensor one contiguous, 16-byte aligned run (16 rows x 750 bytes for the int4
// carrier at F = 1500), loaded with one cp.async.bulk each into shared memory
// while the block stages its 16-wide slice of the queries and the two scale
// rows, so the whole slab is in flight at once. The kernel is a template on the
// live row count K (1 to 8), so 5 beams cost 5 rows and every per-row loop
// unrolls with registers for K rows only: a runtime K with 8-row arrays spilled
// three times the bytes and took 1.7x the time at K = 5 (PERF.md), which is
// worth the longer build of 24 instances. Pass 1: each thread takes slab
// columns (byte j of the carrier: positions j and j + F/2), unpacks its 16 d
// values to fp32 four at a time (int8 and int4 by the 2^23 magic-number trick,
// no integer-to-float conversion) and writes K partial scores over its 16 d.
// Combine, over
// distributed shared memory, in three cluster barriers: block r sums the four
// partials of its quarter of the positions in a fixed order, applies scale *
// k_scale and takes the quarter's softmax statistics (row max, sum of
// exponentials, the exponentials in place); each block then merges the four
// quarters' statistics and gathers the other quarters' exponentials as weights
// (v_scale folded in), so the exp work is not repeated across the cluster and
// all four blocks hold the same weights. Pass 2 writes out[m, d] for the
// block's own 16 d only: two d rows per warp, lanes across positions, no
// reduction across blocks. One launch per call.
//
// Beam sizes above 8: each beam's query is independent of the others, so a
// cluster takes a group of at most 8 of an item's Kt beams, the template's K
// = ceil(Kt / groups) for groups = ceil(Kt / 8), and the launch has B x H x
// groups clusters, each reading the slab for its group. The last group's rows
// past Kt read the item's last query and are not stored. Up to 8 beams there
// is one group and the kernel is as before.

#include <cooperative_groups.h>

#include "slab_attention.cuh"

namespace cg = cooperative_groups;

namespace {

using slab::HD;
using slab::kBf16;
using slab::kInt4;
using slab::kInt8;
using slab::MAX_DYNAMIC_SMEM;
using slab::THREADS;
using slab::WARPS;

constexpr int CLUSTER = 4;         // blocks per (item, head)
constexpr int DQ = HD / CLUSTER;   // d rows per block
constexpr int DW = DQ / WARPS;     // d rows per warp in pass 2
constexpr int KMAX = 8;            // most beams a cluster takes (a template instance each)
constexpr int MAX_BEAMS = 32;      // most beams an item has
constexpr int MIN_BLOCKS = 3;      // an SM (<= 85 registers a thread): the beam
                                   // slice's 320 blocks in one wave on 132 SMs
constexpr float LOG2E = 1.4426950408889634f;

// Reduce K values per thread over the block (max or sum); every thread gets
// the results. Row order and warp order are fixed, so a run is reproducible.
template <int K>
__device__ __forceinline__ void block_reduce(float (&x)[K], float (*red)[K], bool is_max) {
#pragma unroll
  for (int m = 0; m < K; ++m) {
    for (int off = 16; off > 0; off >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x[m], off);
      x[m] = is_max ? fmaxf(x[m], y) : x[m] + y;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red[] free from any earlier reduction
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < K; ++m) red[warp][m] = x[m];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < K; ++m) {
    x[m] = red[0][m];
    for (int w = 1; w < WARPS; ++w) x[m] = is_max ? fmaxf(x[m], red[w][m]) : x[m] + red[w][m];
  }
}

// Signed nibble / byte -> fp32: bias the value into the low mantissa bits of
// 2^23 and subtract (exact).
__device__ __forceinline__ float nib_lo(uint32_t b) {
  return __int_as_float(0x4B000000 | ((b & 0xFu) ^ 8u)) - 8388616.f;
}
__device__ __forceinline__ float nib_hi(uint32_t b) {
  return __int_as_float(0x4B000000 | (((b >> 4) & 0xFu) ^ 8u)) - 8388616.f;
}
__device__ __forceinline__ float i8_f(uint32_t b) {
  return __int_as_float(0x4B000000 | ((b & 0xFFu) ^ 0x80u)) - 8388736.f;
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One-dimensional bulk copy global -> this block's shared memory, completing
// on the mbarrier; bytes and both addresses multiples of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wait_phase0(uint32_t bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar)
        : "memory");
  }
}

template <int FORM, int K>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, MIN_BLOCKS)
beam_cross_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [BH, Kt, HD]
                            const void* __restrict__ k,  // [BH, HD, row], row = F (F/2 int4)
                            const void* __restrict__ v,
                            const float* __restrict__ k_scale,  // [BH, F] (int8, int4)
                            const float* __restrict__ v_scale,
                            __nv_bfloat16* __restrict__ out,  // [BH, Kt, HD]
                            int F, int Kt, float scale) {
  constexpr int ESZ = FORM == kBf16 ? 2 : 1;
  // [K, V quarters][DQ][row] slab elements, [K][Fs] fp32 scores (partial
  // sums, then full scores, then softmax weights), then k_scale and v_scale
  // [F] (int8, int4).
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(16) float qs[K][DQ];
  __shared__ float red[WARPS][K];
  __shared__ float stat[2][K];      // this quarter's row max (log2 units) and sum
  __shared__ float fac[CLUSTER][K];  // each quarter's weight factor per row
  __shared__ __align__(8) uint64_t bar;
  __shared__ int out_row0, out_rows;  // the group's first output row and its rows below Kt

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int groups = (Kt + K - 1) / K;
  const int bh = blockIdx.x / CLUSTER / groups;
  const int m0 = blockIdx.x / CLUSTER % groups * K;  // the group's first beam
  const int row = FORM == kInt4 ? F / 2 : F;
  const uint32_t quarter = static_cast<uint32_t>(DQ * row * ESZ);
  const unsigned char* kq = smem;
  const unsigned char* vq = smem + quarter;
  const int Fs = (F + 3) & ~3;  // score row stride: rows 16-byte aligned
  float* sc = reinterpret_cast<float*>(smem + 2 * quarter);
  float* kss = sc + K * Fs;
  float* vss = kss + F;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  const uint32_t bar_a = smem_u32(&bar);
  if (tid == 0) {
    // read back only at the end: no register holds them through the passes
    out_row0 = bh * Kt + m0;
    out_rows = min(K, Kt - m0);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const size_t off = (static_cast<size_t>(bh) * HD + rank * DQ) * row * ESZ;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_a),
                 "r"(2 * quarter)
                 : "memory");
    bulk_load(smem_u32(kq), static_cast<const unsigned char*>(k) + off, quarter, bar_a);
    bulk_load(smem_u32(vq), static_cast<const unsigned char*>(v) + off, quarter, bar_a);
  }
  for (int i = tid; i < K * DQ; i += THREADS) {
    const int m = i / DQ, dd = i % DQ;
    const int mq = min(m0 + m, Kt - 1);
    qs[m][dd] = __bfloat162float(q[(static_cast<size_t>(bh) * Kt + mq) * HD + rank * DQ + dd]);
  }
  if constexpr (FORM != kBf16) {
#pragma unroll 4
    for (int f = tid; f < F; f += THREADS) {
      kss[f] = k_scale[static_cast<size_t>(bh) * F + f] * scale;
      vss[f] = v_scale[static_cast<size_t>(bh) * F + f];
    }
  }
  __syncthreads();  // qs and scales written, the barrier initialised
  wait_phase0(bar_a);

  // Pass 1: partial scores over this block's 16 d, the K rows' sums
  // independent of each other; the d values are unpacked four at a time, so
  // few registers stay live under the three-blocks-an-SM budget.
  for (int j = tid; j < row; j += THREADS) {
    float a[K], c[K];  // c: the high nibbles (positions j + F/2), int4 only
#pragma unroll
    for (int m = 0; m < K; ++m) a[m] = c[m] = 0.f;
#pragma unroll
    for (int d4 = 0; d4 < DQ; d4 += 4) {
      float x[4], y[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int at = (d4 + u) * row + j;
        if constexpr (FORM == kInt4) {
          x[u] = nib_lo(kq[at]);
          y[u] = nib_hi(kq[at]);
        } else if constexpr (FORM == kInt8) {
          x[u] = i8_f(kq[at]);
        } else {
          x[u] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(kq)[at]);
        }
      }
#pragma unroll
      for (int m = 0; m < K; ++m) {
        const float4 qv = *reinterpret_cast<const float4*>(&qs[m][d4]);
        a[m] = fmaf(qv.w, x[3], fmaf(qv.z, x[2], fmaf(qv.y, x[1], fmaf(qv.x, x[0], a[m]))));
        if constexpr (FORM == kInt4) {
          c[m] = fmaf(qv.w, y[3], fmaf(qv.z, y[2], fmaf(qv.y, y[1], fmaf(qv.x, y[0], c[m]))));
        }
      }
    }
#pragma unroll
    for (int m = 0; m < K; ++m) {
      sc[m * Fs + j] = a[m];
      if constexpr (FORM == kInt4) sc[m * Fs + j + row] = c[m];
    }
  }

  // Combine over distributed shared memory, in 16-byte remote reads. Block r
  // owns positions [r * per, (r + 1) * per), per a multiple of 4: it sums the
  // four partials there (fixed order), applies scale * k_scale, and takes its
  // quarter's softmax statistics: the row max mb (log2 units) and the sum of
  // e = 2^(s log2(e) - mb), e in place. A quarter's last float4 may reach
  // into the row padding past F, which no position reads.
  float* peer[CLUSTER];
  float* peer_stat[CLUSTER];
#pragma unroll
  for (int p = 0; p < CLUSTER; ++p) {
    peer[p] = cluster.map_shared_rank(sc, p);
    peer_stat[p] = cluster.map_shared_rank(&stat[0][0], p);
  }
  const int per = (F + 4 * CLUSTER - 1) / (4 * CLUSTER) * 4;
  const int f0 = min(F, rank * per), f1 = min(F, f0 + per);
  cluster.sync();  // 1: every partial written
  float mx[K], sum[K];
#pragma unroll
  for (int m = 0; m < K; ++m) {
    mx[m] = -INFINITY;
    sum[m] = 0.f;
  }
  for (int f = f0 + 4 * tid; f < f1; f += 4 * THREADS) {
    float ks[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) ks[u] = FORM == kBf16 ? scale : (f + u < F ? kss[f + u] : 0.f);
#pragma unroll
    for (int m = 0; m < K; ++m) {
      float4 x[CLUSTER];
#pragma unroll
      for (int p = 0; p < CLUSTER; ++p) x[p] = *reinterpret_cast<const float4*>(peer[p] + m * Fs + f);
      float4 y;
      y.x = (((x[0].x + x[1].x) + x[2].x) + x[3].x) * ks[0];
      y.y = (((x[0].y + x[1].y) + x[2].y) + x[3].y) * ks[1];
      y.z = (((x[0].z + x[1].z) + x[2].z) + x[3].z) * ks[2];
      y.w = (((x[0].w + x[1].w) + x[2].w) + x[3].w) * ks[3];
      *reinterpret_cast<float4*>(sc + m * Fs + f) = y;
      const float yy[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (f + u < F) mx[m] = fmaxf(mx[m], yy[u]);
      }
    }
  }
  block_reduce<K>(mx, red, true);  // -inf for a quarter with no positions
#pragma unroll
  for (int m = 0; m < K; ++m) mx[m] *= LOG2E;
  for (int f = f0 + tid; f < f1; f += THREADS) {
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const float e = ex2(fmaf(sc[m * Fs + f], LOG2E, -mx[m]));
      sc[m * Fs + f] = e;
      sum[m] += e;
    }
  }
  block_reduce<K>(sum, red, false);
  if (tid == 0) {
#pragma unroll
    for (int m = 0; m < K; ++m) {
      stat[0][m] = mx[m];
      stat[1][m] = sum[m];
    }
  }
  cluster.sync();  // 2: every quarter's e and statistics written
  // The weight of quarter p's e in row m: 2^(mb_p - M) / Z, with M the
  // largest mb and Z the sum of the quarters' sums brought to M.
  if (tid < K) {
    float mb[CLUSTER], big = -INFINITY, z = 0.f;
#pragma unroll
    for (int p = 0; p < CLUSTER; ++p) {
      mb[p] = peer_stat[p][tid];
      big = fmaxf(big, mb[p]);
    }
#pragma unroll
    for (int p = 0; p < CLUSTER; ++p) z += peer_stat[p][K + tid] * ex2(mb[p] - big);
#pragma unroll
    for (int p = 0; p < CLUSTER; ++p) fac[p][tid] = ex2(mb[p] - big) / z;
  }
  __syncthreads();
  // Gather the other quarters as weights, v_scale folded in: one pass over
  // the (quarter, float4) slots, all K rows' reads in flight together.
  for (int i = tid; i < CLUSTER * (per / 4); i += THREADS) {
    const int p = i / (per / 4), f = p * per + 4 * (i % (per / 4));
    if (p == rank || f >= F) continue;
    float vs[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) vs[u] = FORM == kBf16 ? 1.f : (f + u < F ? vss[f + u] : 0.f);
    float4 x[K];
#pragma unroll
    for (int m = 0; m < K; ++m) x[m] = *reinterpret_cast<const float4*>(peer[p] + m * Fs + f);
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const float w = fac[p][m];
      x[m].x *= w * vs[0];
      x[m].y *= w * vs[1];
      x[m].z *= w * vs[2];
      x[m].w *= w * vs[3];
      *reinterpret_cast<float4*>(sc + m * Fs + f) = x[m];
    }
  }
  cluster.sync();  // 3: no block reads another's shared memory after this
  for (int f = f0 + tid; f < f1; f += THREADS) {
    const float vs = FORM == kBf16 ? 1.f : vss[f];
#pragma unroll
    for (int m = 0; m < K; ++m) sc[m * Fs + f] *= fac[rank][m] * vs;
  }
  __syncthreads();

  // Pass 2: out[m, d] for this block's 16 d, DW d rows per warp sharing each
  // weight read, lanes across the slab columns.
  float acc[DW][K];
#pragma unroll
  for (int r = 0; r < DW; ++r) {
#pragma unroll
    for (int m = 0; m < K; ++m) acc[r][m] = 0.f;
  }
  const int d0 = warp * DW;
#pragma unroll 2
  for (int j = lane; j < row; j += 32) {
    float lo[DW], hi[DW];
#pragma unroll
    for (int r = 0; r < DW; ++r) {
      const int at = (d0 + r) * row + j;
      if constexpr (FORM == kInt4) {
        lo[r] = nib_lo(vq[at]);
        hi[r] = nib_hi(vq[at]);
      } else if constexpr (FORM == kInt8) {
        lo[r] = i8_f(vq[at]);
      } else {
        lo[r] = __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(vq)[at]);
      }
    }
#pragma unroll
    for (int m = 0; m < K; ++m) {
      const float w = sc[m * Fs + j];
#pragma unroll
      for (int r = 0; r < DW; ++r) acc[r][m] = fmaf(w, lo[r], acc[r][m]);
      if constexpr (FORM == kInt4) {
        const float w2 = sc[m * Fs + j + row];
#pragma unroll
        for (int r = 0; r < DW; ++r) acc[r][m] = fmaf(w2, hi[r], acc[r][m]);
      }
    }
  }
  const int row0 = out_row0, rows = out_rows;
#pragma unroll
  for (int m = 0; m < K; ++m) {
#pragma unroll
    for (int r = 0; r < DW; ++r) {
      float a = acc[r][m];
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0 && m < rows) {
        out[(static_cast<size_t>(row0) + m) * HD + rank * DQ + d0 + r] = __float2bfloat16(a);
      }
    }
  }
}

// Launch over B*H*groups clusters of four blocks; each block takes its K and
// V quarters, K padded rows of fp32 scores and (int8, int4) the two scale
// rows of dynamic shared memory, opted in once per instance.
template <int FORM, int K>
int launch_k(const void* q, const void* k, const void* v, const void* k_scale,
             const void* v_scale, void* out, int BH, int F, int Kt, float scale, size_t smem,
             cudaStream_t stream) {
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(beam_cross_attention_kernel<FORM, K>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYNAMIC_SMEM);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int groups = (Kt + K - 1) / K;
  beam_cross_attention_kernel<FORM, K><<<BH * groups * CLUSTER, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<__nv_bfloat16*>(out), F, Kt, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int FORM>
int launch(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
           void* out, int BH, int F, int Kt, float scale, void* stream) {
  if (Kt < 1 || Kt > MAX_BEAMS) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (Kt + KMAX - 1) / KMAX;
  const int K = (Kt + groups - 1) / groups;  // beams a cluster takes
  const size_t row = FORM == kInt4 ? F / 2 : F;
  const size_t Fs = (F + 3) & ~3;
  const size_t smem = 2 * DQ * row * (FORM == kBf16 ? 2 : 1) +
                      (K * Fs + (FORM == kBf16 ? 0 : 2 * F)) * 4;
  const uintptr_t align = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  if (BH < 1 || F < 1 || (FORM == kInt4 && F % 2) || align % 16 ||
      smem > MAX_DYNAMIC_SMEM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch_k<FORM, 1>(q, k, v, k_scale, v_scale, out, BH, F, Kt, scale, smem, st);
    case 2: return launch_k<FORM, 2>(q, k, v, k_scale, v_scale, out, BH, F, Kt, scale, smem, st);
    case 3: return launch_k<FORM, 3>(q, k, v, k_scale, v_scale, out, BH, F, Kt, scale, smem, st);
    case 4: return launch_k<FORM, 4>(q, k, v, k_scale, v_scale, out, BH, F, Kt, scale, smem, st);
    case 5: return launch_k<FORM, 5>(q, k, v, k_scale, v_scale, out, BH, F, Kt, scale, smem, st);
    case 6: return launch_k<FORM, 6>(q, k, v, k_scale, v_scale, out, BH, F, Kt, scale, smem, st);
    case 7: return launch_k<FORM, 7>(q, k, v, k_scale, v_scale, out, BH, F, Kt, scale, smem, st);
    default: return launch_k<FORM, 8>(q, k, v, k_scale, v_scale, out, BH, F, Kt, scale, smem, st);
  }
}

}  // namespace

extern "C" int sstw_beam_cross_attention_bf16(const void* q, const void* k, const void* v,
                                              void* out, int B, int H, int F, int K, float scale,
                                              void* stream) {
  return launch<kBf16>(q, k, v, nullptr, nullptr, out, B * H, F, K, scale, stream);
}

extern "C" int sstw_beam_cross_attention_i8(const void* q, const void* k, const void* v,
                                            const void* k_scale, const void* v_scale, void* out,
                                            int B, int H, int F, int K, float scale,
                                            void* stream) {
  return launch<kInt8>(q, k, v, k_scale, v_scale, out, B * H, F, K, scale, stream);
}

extern "C" int sstw_beam_cross_attention_i4(const void* q, const void* k_packed,
                                            const void* v_packed, const void* k_scale,
                                            const void* v_scale, void* out, int B, int H, int F,
                                            int K, float scale, void* stream) {
  return launch<kInt4>(q, k_packed, v_packed, k_scale, v_scale, out, B * H, F, K, scale, stream);
}

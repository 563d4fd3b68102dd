// K4: single-token (q_len = 1) attention over a packed int4 KF slab, the
// greedy decode step's cross read under the default int4 cross slab.
//
// Replaces the Pallas TPU kernel ops/decode_attention.py:_i4_kernel, launched
// by decode_attention_i4 (pallas_call at ops/decode_attention.py:227). The
// plain PyTorch version is ops/decode_attention.py:decode_attention_reference
// in this package on the unpacked slab (fp32 weights, not the Pallas
// _i4_kernel's bf16 weights), which is also what the JAX production path
// computes for this step. Per (item s, head h):
//   score[f] = (q . k[:, f]) * scale * k_scale[f]
//   w[f]     = softmax(score)[f] * v_scale[f]
//   out[d]   = sum_f w[f] * v[d, f]                  (fp32, stored as bf16)
// with k, v the packed carrier [S, H, 64, F/2] int8: byte j of a row holds
// position j in its low nibble and position j + F/2 in its high nibble
// (ops/quant._pack_nibbles), and the scales [S, H, F] fp32.
//
// Bound on the H100: device memory. An (s, h) reads 2 x 64 x F/2 carrier
// bytes and 2 x F scales once for 4 flops per slab element; at the greedy
// slice's shape (4 x 20 heads, F = 1500) that is 8.6 MB, 0.0026 ms at
// 3.35 TB/s.
//
// Design: a cluster of eight blocks per (s, h), 640 blocks, all resident at
// once (64 registers a thread), which split the carrier columns: block r
// owns bytes [j0, j1) of all 64 rows of K and of V (positions j and j + F/2
// for j in that range) and their four scale runs. A carrier row is F/2 bytes
// (750 at F = 1500), so rows start on 2-byte boundaries only and no tensor
// map or aligned vector load describes a block's piece; each row's piece is
// copied with 16-byte cp.async from the aligned address at or below its
// start (a piece's bytes keep their offset mod 16 in shared memory), eight
// lanes a row so a warp's requests are contiguous runs, K first and V in a
// second group that lands while the scores are formed. The arithmetic is
// bound by turning nibbles into floats, so it works on words of four
// columns, realigned by a funnel shift: the 2^23 trick turns eight nibbles
// into fp32 in 19 instructions. Scores: thread (word, quarter of the rows)
// sums 16 rows, a reduce-scatter over the four quarter lanes combines them
// (log2(e) folded into the query, exp2). Values: warp w takes 16 rows in
// two passes of eight, lane g a word's eight positions with their weights
// read once, and a reduce-scatter over the warp sums each row. The cluster
// merges the eight blocks' (m, l, o): each block pushes them to the owners
// of their channels over distributed shared memory, one cluster barrier
// later block r writes channels [8 r, 8 r + 8) (csrc/split_softmax.cuh). One
// launch per call; any even F with F/2 a multiple of nothing. (Tensor-core
// products, with the nibbles turned into bf16 pairs, measured slower here:
// PERF.md.)

#include "split_softmax.cuh"

namespace {

using split::ex2;

constexpr int HD = 64;
constexpr int CLUSTER = 8;   // blocks per (item, head), a column range each
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int DW = HD / WARPS;     // K and V rows each warp takes in the values phase
constexpr int DQ = HD / CLUSTER;   // output channels each block merges and writes
constexpr int MIN_BLOCKS = 8;      // an SM (<= 64 registers a thread), so the greedy
                                   // slice's 640 blocks fit in one wave on 132 SMs
constexpr int MAX_DYNAMIC_SMEM = 200 * 1024;

__host__ __device__ inline int columns_per_block(int R) { return (R + CLUSTER - 1) / CLUSTER; }
__host__ __device__ inline int groups(int per) { return (per + 3) / 4; }  // 4-column words
// Shared-memory row stride: a row's piece starts at offset < 16 of its
// first 16-byte unit, and the last word read (two aligned words, funnel-
// shifted) ends at most 7 bytes past the piece's last group.
__host__ __device__ inline int piece_stride(int per) { return (4 * groups(per) + 19 + 15) & ~15; }
// Dynamic shared memory: the K and V pieces [64][stride] bytes, then the
// scores, the K and the V scales, each [2][4 groups] fp32 (low nibbles, then
// high).
__host__ __device__ inline size_t smem_bytes(int R) {
  const int per = columns_per_block(R);
  return 2 * static_cast<size_t>(HD) * piece_stride(per) + 3 * 2 * 4 * groups(per) * 4;
}

// The four carrier bytes of columns [jl, jl + 4) of a row whose piece
// starts at byte `off` of `row` in shared memory (jl a multiple of 4).
__device__ __forceinline__ uint32_t word_at(const unsigned char* row, int off, int jl) {
  const int a = off + jl;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (a & ~3));
  return __funnelshift_r(w[0], w[1], 8 * (a & 3));
}

__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, MIN_BLOCKS)
decode_attention_i4_kernel(const __nv_bfloat16* __restrict__ q,  // [S, H, HD]
                           const int8_t* __restrict__ kp,        // [S, H, HD, R], R = F/2
                           const int8_t* __restrict__ vp,
                           const float* __restrict__ k_scale,    // [S, H, F]
                           const float* __restrict__ v_scale,
                           __nv_bfloat16* __restrict__ out,      // [S, H, HD]
                           int R, float qscale) {                // qscale: scale * log2(e)
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float qs[HD];
  __shared__ float part_o[CLUSTER][DQ];  // pushed by block p: its o of my channels
  __shared__ float part_ml[CLUSTER][2];  // pushed by block p: its max and sum
  __shared__ float red[2][WARPS];

  split::cluster_arrive_relaxed();
  const int rank = static_cast<int>(blockIdx.x % CLUSTER);
  const int sh = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int per = columns_per_block(R), ng = groups(per), P4 = 4 * ng, stride = piece_stride(per);
  const int j0 = min(R, rank * per), n = min(R, j0 + per) - j0;
  unsigned char* ks = smem;
  unsigned char* vs = smem + HD * stride;
  float* sc = reinterpret_cast<float*>(smem + 2 * HD * stride);  // [2][P4]
  float* kss = sc + 2 * P4;
  float* vss = kss + 2 * P4;

  // Row d's piece starts at byte (k0 + d R) mod 16 of its shared-memory row
  // (split::copy_pieces). Two groups: K with both scale runs, then V, which
  // lands while the scores are formed.
  const uintptr_t k0 = reinterpret_cast<uintptr_t>(kp) + static_cast<size_t>(sh) * HD * R + j0;
  const uintptr_t v0 = reinterpret_cast<uintptr_t>(vp) + static_cast<size_t>(sh) * HD * R + j0;
  split::copy_pieces<HD, THREADS>(k0, R, n, ks, stride);
  const size_t srow = static_cast<size_t>(sh) * 2 * R + j0;
  for (int jl = tid; jl < n; jl += THREADS) {
    split::cp_async4(kss + jl, k_scale + srow + jl);
    split::cp_async4(kss + P4 + jl, k_scale + srow + R + jl);
    split::cp_async4(vss + jl, v_scale + srow + jl);
    split::cp_async4(vss + P4 + jl, v_scale + srow + R + jl);
  }
  split::cp_async_commit();
  split::copy_pieces<HD, THREADS>(v0, R, n, vs, stride);
  split::cp_async_commit();
  if (tid < HD) qs[tid] = __bfloat162float(q[static_cast<size_t>(sh) * HD + tid]) * qscale;
  split::cp_async_wait<1>();  // this thread's K copies
  __syncthreads();

  // Scores: thread (word g, quarter qd) sums 16 rows of the word's four
  // columns' eight positions; a reduce-scatter over the four quarter lanes
  // (6 shuffles) leaves two positions' scores in each.
  const int ko = static_cast<int>(k0 & 15), vo = static_cast<int>(v0 & 15);
  float mx = -INFINITY;
  for (int g0 = 0; g0 < ng; g0 += THREADS / 4) {
    const int g = g0 + tid / 4, qd = tid % 4;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // 4 low, then 4 high nibbles
    if (g < ng) {
#pragma unroll 4
      for (int d = 16 * qd; d < 16 * qd + 16; ++d) {
        float lo[4], hi[4];
        split::nib4(word_at(ks + d * stride, (ko + d * R) & 15, 4 * g), lo, hi);
        const float qd_ = qs[d];
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          x[t] = fmaf(qd_, lo[t], x[t]);
          x[4 + t] = fmaf(qd_, hi[t], x[4 + t]);
        }
      }
    }
    split::scatter_step<4>(x, qd & 2, 2);
    split::scatter_step<2>(x, qd & 1, 1);
    if (g < ng) {  // lane qd: positions 2 (qd & 1) + {0, 1} of the word, low (qd < 2) or high
      const int jl = 4 * g + 2 * (qd & 1), half = qd >> 1;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const float y = jl + u < n ? x[u] * kss[half * P4 + jl + u] : -INFINITY;
        sc[half * P4 + jl + u] = y;
        mx = fmaxf(mx, y);
      }
    }
  }
  mx = split::block_reduce<WARPS>(mx, red[0], true);  // -inf for a block with no columns
  float sum = 0.f;
  for (int jl = tid; jl < P4; jl += THREADS) {  // columns past n: weight 0
    const bool valid = jl < n;
    const float e0 = valid ? ex2(sc[jl] - mx) : 0.f, e1 = valid ? ex2(sc[P4 + jl] - mx) : 0.f;
    sum += e0 + e1;
    sc[jl] = valid ? e0 * vss[jl] : 0.f;
    sc[P4 + jl] = valid ? e1 * vss[P4 + jl] : 0.f;
  }
  split::cp_async_wait<0>();  // this thread's V copies
  sum = split::block_reduce<WARPS>(sum, red[1], false);  // its barrier publishes the weights and V

  // Values: warp w takes rows [16 w, 16 w + 16) in two passes of eight, lane
  // g a word's four columns (eight positions); a reduce-scatter over the
  // warp (7 shuffles, then 2 adds) sums each row's 32 lanes, leaving row
  // 16 w + 8 pass + (lane >> 2) in res[pass].
  float res[2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float acc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] = 0.f;
    for (int g = lane; g < ng; g += 32) {
      const float4 wl = *reinterpret_cast<const float4*>(sc + 4 * g);
      const float4 wh = *reinterpret_cast<const float4*>(sc + P4 + 4 * g);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int d = warp * DW + 8 * pass + r;
        float lo[4], hi[4];
        split::nib4(word_at(vs + d * stride, (vo + d * R) & 15, 4 * g), lo, hi);
        float a = acc[r];
        a = fmaf(wl.x, lo[0], a);
        a = fmaf(wl.y, lo[1], a);
        a = fmaf(wl.z, lo[2], a);
        a = fmaf(wl.w, lo[3], a);
        a = fmaf(wh.x, hi[0], a);
        a = fmaf(wh.y, hi[1], a);
        a = fmaf(wh.z, hi[2], a);
        acc[r] = fmaf(wh.w, hi[3], a);
      }
    }
    res[pass] = split::warp_row_sums(acc, lane);
  }
  split::push_merge_store<CLUSTER, HD>(res, mx, sum, part_o, part_ml, rank,
                                       out + static_cast<size_t>(sh) * HD);
}

}  // namespace

extern "C" int sstw_decode_attention_i4(const void* q, const void* k_packed,
                                        const void* v_packed, const void* k_scale,
                                        const void* v_scale, void* out, int S, int H, int F,
                                        float scale, void* stream) {
  // Above 48 KB a block's dynamic shared memory needs this opt-in, once.
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(decode_attention_i4_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYNAMIC_SMEM);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int R = F / 2;
  if (S < 1 || H < 1 || F < 2 || F % 2 || smem_bytes(R) > MAX_DYNAMIC_SMEM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  decode_attention_i4_kernel<<<S * H * CLUSTER, THREADS, smem_bytes(R),
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k_packed),
      static_cast<const int8_t*>(v_packed), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<__nv_bfloat16*>(out), R,
      scale * split::LOG2E);
  return static_cast<int>(cudaGetLastError());
}

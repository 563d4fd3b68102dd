// K3: single-token (q_len = 1) attention over a KF-layout slab
// [S, H, 64, F], one templated kernel for two slab forms:
//   * bf16 slab, optional causal bound pos[s]  (plain form)
//   * int8 slab with per-position scales       (int8 form)
// K4, the packed int4 form, is csrc/decode_attention_i4.cu.
//
// Replaces the Pallas TPU kernels ops/decode_attention.py:_plain_kernel and
// _quant_kernel, launched by decode_attention (pallas_call at
// ops/decode_attention.py:146). The plain PyTorch version is
// ops/decode_attention.py:decode_attention_reference in this package, which
// is also what the JAX production path calls for this step. Per (item s,
// head h):
//   score[f] = (q . k[:, f]) * scale * k_scale[f]    (f <= pos[s] if given)
//   w[f]     = softmax(score)[f] * v_scale[f]
//   out[d]   = sum_f w[f] * v[d, f]                  (fp32, stored as bf16)
//
// Bound on the H100: device memory. An (s, h) reads 2 x 64 x F slab
// elements (and 2 x F scales) once for 4 flops per element; at the greedy
// slice's shape (4 x 20 heads, F = 1500) that is 30.7 MB in bf16 (0.0092 ms
// at 3.35 TB/s) and 16.3 MB in int8 (0.0049 ms).
//
// Design (K4's): a cluster of eight blocks per (s, h), 640 blocks, which
// split the positions: block r owns positions [f0, f0 + per) of all 64 rows
// of K and of V, and its two scale runs. A bf16 row is 2F bytes and an int8
// row F bytes, so rows start on 2- or 1-byte boundaries and each row's piece
// is copied with 16-byte cp.async from the aligned address at or below its
// start (a piece's bytes keep their offset mod 16 in shared memory), eight
// lanes a row, K first, then V into the same buffer while the softmax
// weights are formed. Under a causal bound a block copies only its live
// positions (f <= pos[s]); a block with none keeps m = -inf and l = 0 and
// adds nothing to the merge. With pos[s] >= 0 position 0 is live, so the
// result is the reference's -1e30 masking; with pos[s] < 0 the reference
// masks every position alike and weighs them evenly, so every position is
// live with the score 0. Scores: thread (group of four positions, quarter
// of the rows) sums 16 rows, log2(e) and the scale folded into the query; a
// reduce-scatter over the four quarter lanes leaves one position's score in
// each. Values: warp w takes 16 rows in two passes of eight, lane g a group
// of four positions with their weights read once, and a reduce-scatter over
// the warp sums each row. The cluster merges the eight blocks' (m, l, o)
// over distributed shared memory (csrc/split_softmax.cuh). The V pieces go
// into K's buffer once the scores are taken, so a block holds 27 KB (bf16)
// or 16 KB (int8) and the 640 blocks run in one wave (both pieces held, a
// bf16 block would take 53 KB, four an SM: two waves).

#include "slab_attention.cuh"
#include "split_softmax.cuh"

namespace {

using slab::HD;
using slab::kBf16;
using slab::kInt8;
using slab::MAX_DYNAMIC_SMEM;
using split::ex2;

constexpr int CLUSTER = 8;   // blocks per (item, head), a position range each
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int DW = HD / WARPS;    // K and V rows each warp takes in the values phase
constexpr int DQ = HD / CLUSTER;  // output channels each block merges and writes
constexpr int MIN_BLOCKS = 8;     // an SM (<= 64 registers a thread)

template <int FORM>
constexpr int kBytes = FORM == kBf16 ? 2 : 1;  // bytes a slab element

__host__ __device__ inline int positions_per_block(int F) { return (F + CLUSTER - 1) / CLUSTER; }
__host__ __device__ inline int groups(int per) { return (per + 3) / 4; }  // 4-position groups
// Shared-memory row stride: a row's piece starts at offset < 16 of its
// first 16-byte unit, and the last group's read (aligned words, funnel-
// shifted) ends at most 19 bytes past the piece's last whole group.
template <int FORM>
__host__ __device__ inline int piece_stride(int per) {
  return (4 * kBytes<FORM> * groups(per) + 19 + 15) & ~15;
}
// Dynamic shared memory: the K, then V, pieces [64][stride] bytes, then the
// weights [4 groups] fp32 and, for int8, the K and the V scales.
template <int FORM>
__host__ __device__ inline size_t smem_bytes(int F) {
  const int per = positions_per_block(F);
  return static_cast<size_t>(HD) * piece_stride<FORM>(per) +
         (FORM == kInt8 ? 3 : 1) * 4 * groups(per) * sizeof(float);
}

// Positions [jl, jl + 4) of a row whose piece starts at byte `off` of `row`
// in shared memory, as fp32: two (bf16) or one (int8) words realigned by a
// funnel shift; int8 through the 2^23 trick (split::byte_at).
template <int FORM>
__device__ __forceinline__ void load4(const unsigned char* row, int off, int jl, float (&x)[4]) {
  if constexpr (FORM == kBf16) {
    const int a = off + 2 * jl;  // even
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (a & ~3));
    const int sh = 8 * (a & 3);
    const uint32_t lo = __funnelshift_r(w[0], w[1], sh), hi = __funnelshift_r(w[1], w[2], sh);
    x[0] = __uint_as_float(lo << 16);
    x[1] = __uint_as_float(lo & 0xFFFF0000u);
    x[2] = __uint_as_float(hi << 16);
    x[3] = __uint_as_float(hi & 0xFFFF0000u);
  } else {
    const int a = off + jl;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (a & ~3));
    const uint32_t b = __funnelshift_r(w[0], w[1], 8 * (a & 3)) ^ 0x80808080u;  // s + 128
#pragma unroll
    for (int t = 0; t < 4; ++t) x[t] = split::byte_at(b, t, 8388736.f);  // 2^23 + 128
  }
}

template <int FORM>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, MIN_BLOCKS)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [S, H, HD]
                        const void* __restrict__ k,           // [S, H, HD, F]
                        const void* __restrict__ v,
                        const float* __restrict__ k_scale,    // [S, H, F] (int8)
                        const float* __restrict__ v_scale,
                        const int* __restrict__ pos,          // [S] or null
                        __nv_bfloat16* __restrict__ out,      // [S, H, HD]
                        int H, int F, float qscale) {         // qscale: scale * log2(e)
  constexpr int E = kBytes<FORM>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float qs[HD];
  __shared__ float part_o[CLUSTER][DQ];  // pushed by block p: its o of my channels
  __shared__ float part_ml[CLUSTER][2];  // pushed by block p: its max and sum
  __shared__ float red[2][WARPS];

  split::cluster_arrive_relaxed();
  const int rank = static_cast<int>(blockIdx.x % CLUSTER);
  const int sh = blockIdx.x / CLUSTER;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int per = positions_per_block(F), stride = piece_stride<FORM>(per);
  const int f0 = min(F, rank * per), n = min(F, f0 + per) - f0;
  const int last = pos ? pos[sh / H] : F - 1;  // the last position attended
  const bool even = last < 0;  // no position attended: every one weighed alike
  const int live = even ? n : max(0, min(n, last + 1 - f0));  // positions read
  const int ngl = groups(live);
  unsigned char* rows = smem;  // K's pieces, then V's
  float* sc = reinterpret_cast<float*>(smem + HD * stride);
  float* kss = sc + 4 * groups(per);
  float* vss = kss + 4 * groups(per);

  // Row d's piece starts at byte (k0 + d F E) mod 16 of its shared-memory
  // row (split::copy_pieces).
  const size_t row0 = (static_cast<size_t>(sh) * HD * F + f0) * E;
  const uintptr_t k0 = reinterpret_cast<uintptr_t>(k) + row0;
  const uintptr_t v0 = reinterpret_cast<uintptr_t>(v) + row0;
  split::copy_pieces<HD, THREADS>(k0, static_cast<size_t>(F) * E, live * E, rows, stride);
  if constexpr (FORM == kInt8) {
    const size_t srow = static_cast<size_t>(sh) * F + f0;
    for (int jl = tid; jl < live; jl += THREADS) {
      split::cp_async4(kss + jl, k_scale + srow + jl);
      split::cp_async4(vss + jl, v_scale + srow + jl);
    }
  }
  split::cp_async_commit();
  if (tid < HD) qs[tid] = __bfloat162float(q[static_cast<size_t>(sh) * HD + tid]) * qscale;
  split::cp_async_wait<0>();  // this thread's K copies
  __syncthreads();

  // Scores: thread (group g, quarter qd) sums 16 rows of the group's four
  // positions; a reduce-scatter over the four quarter lanes (4 shuffles)
  // leaves position qd's score in lane qd. Positions past `live` (read from
  // bytes that were not copied) get -inf.
  const int ko = static_cast<int>(k0 & 15), vo = static_cast<int>(v0 & 15);
  float mx = -INFINITY;
  for (int g0 = 0; g0 < ngl; g0 += THREADS / 4) {
    const int g = g0 + tid / 4, qd = tid % 4;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (g < ngl) {
#pragma unroll 4
      for (int d = 16 * qd; d < 16 * qd + 16; ++d) {
        float kv[4];
        load4<FORM>(rows + d * stride, (ko + d * F * E) & 15, 4 * g, kv);
        const float qd_ = qs[d];
#pragma unroll
        for (int t = 0; t < 4; ++t) x[t] = fmaf(qd_, kv[t], x[t]);
      }
    }
    split::scatter_step<2>(x, qd & 2, 2);
    split::scatter_step<1>(x, qd & 1, 1);
    if (g < ngl) {
      const int jl = 4 * g + qd;
      const float y = jl >= live ? -INFINITY : even ? 0.f : FORM == kInt8 ? x[0] * kss[jl] : x[0];
      sc[jl] = y;
      mx = fmaxf(mx, y);
    }
  }
  mx = split::block_reduce<WARPS>(mx, red[0], true);  // -inf for a block with no live position
  // every thread is past its K reads
  split::copy_pieces<HD, THREADS>(v0, static_cast<size_t>(F) * E, live * E, rows, stride);
  split::cp_async_commit();
  float sum = 0.f;
  for (int jl = tid; jl < 4 * ngl; jl += THREADS) {  // positions past live: weight 0
    const bool valid = jl < live;
    const float e = valid ? ex2(sc[jl] - mx) : 0.f;
    sum += e;
    sc[jl] = FORM == kInt8 && valid ? e * vss[jl] : e;
  }
  split::cp_async_wait<0>();  // this thread's V copies
  sum = split::block_reduce<WARPS>(sum, red[1], false);  // its barrier publishes the weights and V

  // Values: warp w takes rows [16 w, 16 w + 16) in two passes of eight, lane
  // g a group's four positions; a reduce-scatter over the warp (7 shuffles,
  // then 2 adds) sums each row's 32 lanes, leaving row 16 w + 8 pass +
  // (lane >> 2) in res[pass]. Past `live` a bf16 value may be any bit
  // pattern (not copied), so it is replaced by 0 before its zero weight.
  float res[2];
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    float acc[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[r] = 0.f;
    for (int g = lane; g < ngl; g += 32) {
      const float4 w = *reinterpret_cast<const float4*>(sc + 4 * g);
      const int nv = live - 4 * g;  // live positions of the group, >= 1
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int d = warp * DW + 8 * pass + r;
        float vv[4];
        load4<FORM>(rows + d * stride, (vo + d * F * E) & 15, 4 * g, vv);
        if constexpr (FORM == kBf16) {
          vv[1] = nv > 1 ? vv[1] : 0.f;
          vv[2] = nv > 2 ? vv[2] : 0.f;
          vv[3] = nv > 3 ? vv[3] : 0.f;
        }
        float a = acc[r];
        a = fmaf(w.x, vv[0], a);
        a = fmaf(w.y, vv[1], a);
        a = fmaf(w.z, vv[2], a);
        acc[r] = fmaf(w.w, vv[3], a);
      }
    }
    res[pass] = split::warp_row_sums(acc, lane);
  }
  split::push_merge_store<CLUSTER, HD>(res, mx, sum, part_o, part_ml, rank,
                                       out + static_cast<size_t>(sh) * HD);
}

template <int FORM>
int launch(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
           const void* pos, void* out, int S, int H, int F, float scale, void* stream) {
  // Above 48 KB a block's dynamic shared memory needs this opt-in, once.
  static const cudaError_t opt_in =
      cudaFuncSetAttribute(decode_attention_kernel<FORM>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYNAMIC_SMEM);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  if (S < 1 || H < 1 || F < 1 || smem_bytes<FORM>(F) > MAX_DYNAMIC_SMEM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  decode_attention_kernel<FORM><<<S * H * CLUSTER, THREADS, smem_bytes<FORM>(F),
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(pos),
      static_cast<__nv_bfloat16*>(out), H, F, scale * split::LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sstw_decode_attention_bf16(const void* q, const void* k, const void* v,
                                          const void* pos, void* out, int S, int H, int F,
                                          float scale, void* stream) {
  return launch<kBf16>(q, k, v, nullptr, nullptr, pos, out, S, H, F, scale, stream);
}

extern "C" int sstw_decode_attention_i8(const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale,
                                        const void* pos, void* out, int S, int H, int F,
                                        float scale, void* stream) {
  return launch<kInt8>(q, k, v, k_scale, v_scale, pos, out, S, H, F, scale, stream);
}

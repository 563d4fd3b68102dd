// K5: ancestry-masked beam self-attention, the self read of the beam-search
// decode step (K6, its cross read, is csrc/beam_cross_attention.cu).
//
// K5 replaces the Pallas TPU kernel ops/beam_attention.py:_kernel, launched by
// beam_attention (pallas_call at ops/beam_attention.py:214): ancestry-masked
// beam self-attention over per-beam slot caches. The plain PyTorch version is
// ops/beam_attention.py:beam_attention_reference in this package.
//
// K5 computes, per (item b, head h) and destination beam kd < K:
//   score[kd, s, c] = (q[b*K+kd] . k[b*K+s, c]) * scale * k_scale[b*K+s, c]
//                     where anc[b, kd, s, c], else -1e30       (c < cv)
//   w[kd, :, :]     = softmax over (s, c) jointly, times v_scale
//   out[b*K+kd]     = sum_{s,c} w[kd, s, c] * v[b*K+s, c]       (fp32, stored bf16)
// with k, v [B*K, H, C, 64] position-major (slot s of item b at row b*K+s),
// bf16, or int8 with per-row scales [B*K, H, C]. A beam whose every entry is
// masked gets the uniform average of all K * cv rows, as the -1e30 mask
// (not -inf) gives in the JAX package.
//
// Bound on the H100: device memory. A step reads each live (slot, position)
// row of K and V once for K destination beams: 4 * K flops per element, far
// below the ridge point. What kept the first version (one block per (b, h),
// a warp walking one row at a time) at 6 % of that bound was too few blocks
// (80 for 132 SMs) and too few loads in flight (about 8 per SM); what keeps
// this one from it is the chain of dependent phases inside a block.
//
// Design: a cluster of four blocks per (b, h), 320 blocks, which share the
// live rows equally. Each block
//   1. copies the item's whole ancestry [K, K, C] (a few KB, shared by all
//      heads, so mostly from L2) into shared memory, and marks the beams
//      with no entry below cv ("full": every row counts, with equal scores);
//   2. numbers the live (position, slot) rows, those some beam reads (all
//      rows if a beam is full), position-major, with a block scan (every
//      block computes the same numbering), and takes its quarter of them;
//   3. requests every one of its rows of K (with the scales) and then of V
//      with cp.async before it uses any, in two groups, so V lands while the
//      scores are formed;
//   4. forms S = Q K^T on the tensor cores (mma.m16n8k16, bf16 products
//      exact, fp32 sums; the queries are A, 8 rows of K a B tile), masks it
//      and applies scale x k_scale x log2(e), so the softmax runs on exp2;
//   5. gives each destination beam a warp for its online-softmax statistics
//      and its weights (v_scale folded in), stored as a bf16 high part and
//      the bf16 of the rest;
//   6. forms O = P V on the tensor cores from both parts (16 mantissa bits of
//      each weight), warp w owning channels [8 w, 8 w + 8) of every beam;
// and the cluster merges the four blocks' (m, l, o): each block pushes them
// to the owners of their channels over distributed shared memory, one
// cluster barrier later block r merges channels [16 r, 16 r + 16)
// (csrc/split_softmax.cuh). Rows are staged in chunks of at most CHUNK_MAX
// with the online softmax carried across chunks; at the beam slice's shapes
// (5 beams, cv = 128 or 160) a block has at most 200 rows and one chunk.
// K is a runtime value: no per-thread array is sized by it, so a template
// on K would save no registers. A cluster serves a group of at most 8 query
// beams (one warp each in step 5, the tensor cores' A rows in steps 4 and
// 6) against all K slots of its item; up to 8 beams that is every beam, one
// launch of B x H clusters. Above 8 the K beams split into
// ceil(K / groups) sized groups, as few as fit the shared memory
// (group_size), one launch of B x H x groups clusters: each stages its
// group's rows of the ancestry and numbers the rows its beams read. Each
// query beam's output depends on its own ancestry row only, so the split is
// exact. Slot masks are 32 bits: at most MAX_BEAMS = 32 beams.

#include "slab_attention.cuh"
#include "split_softmax.cuh"

namespace {

using slab::HD;
using slab::MAX_DYNAMIC_SMEM;
using slab::NEG;
using slab::THREADS;
using slab::WARPS;
using split::ex2;

constexpr int CLUSTER = 4;        // blocks per (item, head), an equal share of the live rows each
constexpr int KMAX = WARPS;       // most query beams a cluster takes: a warp per beam
constexpr int MAX_BEAMS = 32;     // slots an item has: one bit each in a slot mask
constexpr int CHUNK_MAX = 256;    // (position, slot) rows staged at once
constexpr int DQ = HD / CLUSTER;  // output channels each block merges and writes

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~static_cast<size_t>(15); }

// Live rows a block takes: at most an equal share of K * cv, rounded up.
__host__ __device__ inline int rows_per_block(int K, int cv) {
  return (K * cv + CLUSTER - 1) / CLUSTER;
}
__host__ __device__ inline int chunk_rows(int K, int cv) {
  const int rows = rows_per_block(K, cv);
  return rows < CHUNK_MAX ? rows : CHUNK_MAX;
}

// Dynamic shared memory of one block of a group of KG query beams, byte
// offsets: the group's ancestry rows [KG, K, C] (with room for the 16-byte
// cover of an unaligned start), per position the number of its first row and
// the 32-bit mask of the slots read there, the block's list of live rows, K
// and V rows of a chunk, the chunk's KG x rows scores, its weights as bf16
// high and low parts [KG][rows, padded to 16], then (int8) its scales.
struct Layout {
  size_t anc, first, slots, list, krow, vrow, sc, wh, wl, ksc, vsc, total;
};

__host__ __device__ inline Layout layout(int KG, int K, int C, int cv, bool int8) {
  const int chunk = chunk_rows(K, cv);
  const size_t row_bytes = HD * (int8 ? 1 : 2);
  Layout s;
  s.anc = 0;
  s.first = align16(static_cast<size_t>(KG) * K * C + 32);
  s.slots = s.first + static_cast<size_t>(cv) * 4;
  s.list = align16(s.slots + static_cast<size_t>(cv) * 4);
  s.krow = align16(s.list + static_cast<size_t>(rows_per_block(K, cv)) * 4);
  // K rows are read in whole tiles of 8 (the tail's stale rows feed only
  // scores that are never stored), so the buffer has a multiple of 8 rows.
  s.vrow = s.krow + ((chunk + 7) & ~7) * row_bytes;
  s.sc = s.vrow + chunk * row_bytes;
  const size_t w_bytes = static_cast<size_t>(KG) * ((chunk + 15) & ~15) * 2;
  s.wh = align16(s.sc + static_cast<size_t>(KG) * chunk * 4);
  s.wl = s.wh + w_bytes;
  s.ksc = s.wl + w_bytes;
  s.vsc = s.ksc + (int8 ? chunk * 4 : 0);
  s.total = s.vsc + (int8 ? chunk * 4 : 0);
  return s;
}

// Query beams a cluster takes: ceil(K / groups) for the fewest groups (at
// least ceil(K / KMAX)) whose blocks fit the shared memory.
__host__ inline int group_size(int K, int C, int cv, bool int8) {
  for (int groups = (K + KMAX - 1) / KMAX;; ++groups) {
    const int kg = (K + groups - 1) / groups;
    if (kg == 1 || layout(kg, K, C, cv, int8).total <= MAX_DYNAMIC_SMEM) return kg;
  }
}

// D = A B + D on the tensor cores, one warp: A 16 x 16 bf16 (row-major), B
// 16 x 8 bf16 (column-major), D 16 x 8 fp32; fragments as the PTX ISA lays
// them out for mma.m16n8k16 (g = lane / 4, t = lane % 4: a[0] holds A[g][2t,
// 2t + 1], a[1] A[g + 8][..], a[2] A[g][2t + 8, 2t + 9], a[3] A[g + 8][..];
// b[0] B[2t, 2t + 1][g], b[1] B[2t + 8, 2t + 9][g]; d[0..1] D[g][2t, 2t + 1],
// d[2..3] D[g + 8][..]).
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
template <bool INT8>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS)
beam_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [B*K, H, HD]
                      const void* __restrict__ k,           // [B*K, H, C, HD]
                      const void* __restrict__ v,
                      const float* __restrict__ k_scale,    // [B*K, H, C] (int8 only)
                      const float* __restrict__ v_scale,
                      const bool* __restrict__ anc,         // [B, K, K, C]
                      __nv_bfloat16* __restrict__ out,      // [B*K, H, HD]
                      int H, int C, int K, int KG, int cv,
                      float qscale) {  // qscale: scale * log2(e)
  constexpr int ROWB = HD * (INT8 ? 1 : 2);  // bytes of one K or V row
  constexpr int CH = ROWB / 16;              // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float part_o[CLUSTER][KMAX][DQ];  // pushed by block p: its o of my channels
  __shared__ float part_ml[CLUSTER][2][KMAX];  // pushed by block p: its row max and sum
  __shared__ float alpha_s[KMAX];              // a chunk's rescale factor per beam
  __shared__ int warp_total[WARPS];
  __shared__ int any_bits;  // bit kd: the group's beam kd reads some position below cv
  __shared__ int out_row0;  // b * K + k0, read back only at the end (no register holds it)

  split::cluster_arrive_relaxed();
  const int rank = static_cast<int>(blockIdx.x % CLUSTER);
  const int groups = (K + KG - 1) / KG;
  const int bhg = blockIdx.x / CLUSTER, bh = bhg / groups, b = bh / H, h = bh % H;
  const int k0 = (bhg % groups) * KG;  // the group's first query beam
  const int kn = min(KG, K - k0);      // and its beams; kd below is k0 + the local index
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // tensor-core fragment coordinates
  const int chunk = chunk_rows(K, cv);
  const Layout L = layout(KG, K, C, cv, INT8);
  int* first = reinterpret_cast<int*>(smem + L.first);
  uint32_t* slots_at = reinterpret_cast<uint32_t*>(smem + L.slots);
  uint32_t* list = reinterpret_cast<uint32_t*>(smem + L.list);
  unsigned char* krow = smem + L.krow;
  unsigned char* vrow = smem + L.vrow;
  float* sc = reinterpret_cast<float*>(smem + L.sc);
  uint16_t* wh = reinterpret_cast<uint16_t*>(smem + L.wh);
  uint16_t* wl = reinterpret_cast<uint16_t*>(smem + L.wl);
  const int chunk16 = (chunk + 15) & ~15;  // row stride of wh, wl
  float* ksc = reinterpret_cast<float*>(smem + L.ksc);
  float* vsc = reinterpret_cast<float*>(smem + L.vsc);

  // 1. The group's rows of the item's ancestry, in 16-byte pieces from the
  // aligned address at or below their start (their bytes keep their offset
  // mod 16); and the queries as the A operand of S = Q K^T, bf16 as they come
  // (the group's beam g, zero for g >= kn and rows 8..15), the score scale
  // applied to S.
  const uintptr_t anc_at =
      reinterpret_cast<uintptr_t>(anc) + (static_cast<size_t>(b) * K + k0) * K * C;
  const uintptr_t anc0 = anc_at & ~static_cast<uintptr_t>(15);
  const int pieces = static_cast<int>((anc_at + static_cast<size_t>(kn) * K * C - anc0 + 15) / 16);
  for (int i = tid; i < pieces; i += THREADS) {
    split::cp_async16(smem + L.anc + 16 * i, reinterpret_cast<const void*>(anc0 + 16 * i));
  }
  const unsigned char* as = smem + L.anc + (anc_at - anc0);  // as[(kd * K + s) * C + c], kd < kn
  uint32_t qa[HD / 16][2];  // k-step kk: {q[g][16 kk + 2t, + 1]}, {q[g][16 kk + 2t + 8, + 9]}
  {
    const uint32_t* qrow = reinterpret_cast<const uint32_t*>(
        q + (static_cast<size_t>(b * K + k0 + min(g, kn - 1)) * H + h) * HD);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      qa[kk][0] = g < kn ? qrow[8 * kk + t] : 0u;
      qa[kk][1] = g < kn ? qrow[8 * kk + 4 + t] : 0u;
    }
  }
  if (tid == 0) {
    any_bits = 0;
    out_row0 = b * K + k0;
  }
  split::cp_async_commit();
  split::cp_async_wait<0>();
  __syncthreads();

  // 2. A thread per position: the slots some beam of the group reads there,
  // and the group's beams that read anything below cv.
  uint32_t beams = 0;
  for (int c = tid; c < cv; c += THREADS) {
    uint32_t slots = 0;
    for (int kd = 0; kd < kn; ++kd) {
      uint32_t mine = 0;
      for (int s = 0; s < K; ++s) {
        mine |= static_cast<uint32_t>(as[(kd * K + s) * C + c] != 0) << s;
      }
      slots |= mine;
      beams |= static_cast<uint32_t>(mine != 0) << kd;
    }
    slots_at[c] = slots;
  }
  beams = __reduce_or_sync(0xffffffffu, beams);
  if (lane == 0 && beams) atomicOr(&any_bits, static_cast<int>(beams));
  __syncthreads();
  // Beams that read nothing get the uniform average: every row, equal scores.
  const int full = ~any_bits & ((1 << kn) - 1);
  const uint32_t all_slots = K == 32 ? 0xffffffffu : (1u << K) - 1;

  // 3. Number the live rows, position-major then slot, every row if a beam
  // is full (first[c]: the number of position c's first row); this block
  // takes the rows numbered [lo, hi), an equal share of them.
  int total = 0;
  for (int base = 0; base < cv; base += THREADS) {
    const int c = base + tid;
    const int n_c = c < cv ? __popc(full ? all_slots : slots_at[c]) : 0;
    int incl = n_c;  // inclusive scan over the warp
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += y;
    }
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    int at = total + incl - n_c;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      at += w < warp ? warp_total[w] : 0;
      total += warp_total[w];
    }
    if (c < cv) first[c] = at;
    __syncthreads();  // warp_total free for the next pass
  }
  const int lo = total * rank / CLUSTER, hi = total * (rank + 1) / CLUSTER, n = hi - lo;
  for (int c = tid; c < cv; c += THREADS) {
    int at = first[c];
    const uint32_t slots = full ? all_slots : slots_at[c];
    if (at >= hi || at + __popc(slots) <= lo) continue;
    for (int s = 0; s < K; ++s) {
      if (!((slots >> s) & 1)) continue;
      if (at >= lo && at < hi) list[at - lo] = (static_cast<uint32_t>(s) << 16) | static_cast<uint32_t>(c);
      ++at;
    }
  }
  __syncthreads();
  auto row_of = [&](uint32_t code) {  // row of slot s, head h, position c in [B*K, H, C]
    return (static_cast<size_t>(b * K + static_cast<int>(code >> 16)) * H + h) * C + (code & 0xffffu);
  };

  // Beam `warp`'s running softmax (row max in log2 units, sum), and this
  // lane's running output O[g][8 warp + 2t, + 1] (o[2..3]: rows 8..15, zero).
  float m_run = NEG, l_run = 0.f;
  float o[4] = {0.f, 0.f, 0.f, 0.f};
  const unsigned char* kg = static_cast<const unsigned char*>(k);
  const unsigned char* vg = static_cast<const unsigned char*>(v);
  for (int i0 = 0; i0 < n; i0 += chunk) {
    const int nr = min(chunk, n - i0);
    // Two groups: K rows with both scales, then V rows, which land while
    // the scores and the softmax are formed.
    for (int i = tid; i < nr * CH; i += THREADS) {
      split::cp_async16(krow + i * 16, kg + row_of(list[i0 + i / CH]) * ROWB + 16 * (i % CH));
    }
    if constexpr (INT8) {
      for (int r = tid; r < nr; r += THREADS) {
        const size_t at = row_of(list[i0 + r]);
        split::cp_async4(ksc + r, k_scale + at);
        split::cp_async4(vsc + r, v_scale + at);
      }
    }
    split::cp_async_commit();
    for (int i = tid; i < nr * CH; i += THREADS) {
      split::cp_async16(vrow + i * 16, vg + row_of(list[i0 + i / CH]) * ROWB + 16 * (i % CH));
    }
    split::cp_async_commit();
    split::cp_async_wait<1>();  // this thread's K copies
    __syncthreads();

    // 4. Scores S = Q K^T on the tensor cores (bf16 products are exact, fp32
    // sums): warp w takes tiles w, w + WARPS, ... of 8 rows, lane (g, t) the
    // scores of beam g at rows 2t, 2t + 1 of the tile. Rows past nr hold
    // stale bytes and only feed scores that are never stored.
    for (int r0 = 8 * warp; r0 < nr; r0 += 8 * WARPS) {
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      const unsigned char* kr = krow + (r0 + g) * ROWB;  // B column g: the tile's row g
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t b0, b1;
        if constexpr (INT8) {  // int8 -> bf16 is exact: the top half of the fp32
          const uint32_t x = *reinterpret_cast<const uint16_t*>(kr + 16 * kk + 2 * t);
          const uint32_t y = *reinterpret_cast<const uint16_t*>(kr + 16 * kk + 2 * t + 8);
          b0 = __byte_perm(__float_as_uint(split::byte_at(x ^ 0x80u, 0, 8388736.f)),
                           __float_as_uint(split::byte_at(x ^ 0x8000u, 1, 8388736.f)), 0x7632);
          b1 = __byte_perm(__float_as_uint(split::byte_at(y ^ 0x80u, 0, 8388736.f)),
                           __float_as_uint(split::byte_at(y ^ 0x8000u, 1, 8388736.f)), 0x7632);
        } else {
          b0 = *reinterpret_cast<const uint32_t*>(kr + 2 * (16 * kk + 2 * t));
          b1 = *reinterpret_cast<const uint32_t*>(kr + 2 * (16 * kk + 2 * t + 8));
        }
        mma_bf16(d, qa[kk][0], 0u, qa[kk][1], 0u, b0, b1);
      }
      if (g < kn) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int r = r0 + 2 * t + u;
          if (r < nr) {
            const uint32_t code = list[i0 + r];
            const bool on = as[(g * K + static_cast<int>(code >> 16)) * C + (code & 0xffffu)] != 0;
            const float ksr = INT8 ? ksc[r] * qscale : qscale;
            sc[g * chunk + r] = (full >> g) & 1 ? 0.f : (on ? d[u] * ksr : NEG);
          }
        }
      }
    }
    __syncthreads();

    // 5. Warp kd: beam kd's chunk max and rescale factor, and its weights
    // (v_scale folded in) as a bf16 high part and the bf16 of the rest, so
    // the tensor cores' products keep 16 mantissa bits of each; rows past nr
    // up to the next 16 get zero weight.
    if (warp < kn) {
      const float* s_row = sc + warp * chunk;
      float cm = NEG;
      for (int r = lane; r < nr; r += 32) cm = fmaxf(cm, s_row[r]);
      const float m_new = fmaxf(m_run, split::warp_max(cm));
      const float alpha = ex2(m_run - m_new);
      float ls = 0.f;
      for (int r = lane; r < ((nr + 15) & ~15); r += 32) {
        float x = 0.f;
        if (r < nr) {
          const float e = ex2(s_row[r] - m_new);
          ls += e;
          x = INT8 ? e * vsc[r] : e;
        }
        const __nv_bfloat16 hi = __float2bfloat16(x);
        wh[warp * chunk16 + r] = __bfloat16_as_ushort(hi);
        wl[warp * chunk16 + r] = __bfloat16_as_ushort(__float2bfloat16(x - __bfloat162float(hi)));
      }
      l_run = fmaf(l_run, alpha, split::warp_sum(ls));
      m_run = m_new;
      if (lane == 0) alpha_s[warp] = alpha;
    }
    split::cp_async_wait<0>();  // this thread's V copies
    __syncthreads();

    // 6. O = O alpha + P V on the tensor cores (bf16 products, fp32 sums),
    // once for the weights' high parts and once for their low parts: warp w
    // owns channels [8 w, 8 w + 8) of every beam (B column g: channel ch),
    // 16 rows a step; lane (g, t) reads rows 2t, 2t + 1, 2t + 8, 2t + 9.
    if (g < kn) {
      const float alpha = alpha_s[g];
      o[0] *= alpha;
      o[1] *= alpha;
    }
    const int ch = 8 * warp + g;
    auto v_at = [&](int r) -> uint32_t {  // bf16 bits of V[r][ch]; zero past nr
      if (r >= nr) return 0u;
      if constexpr (INT8) {
        const float x = split::byte_at(static_cast<uint32_t>(vrow[r * ROWB + ch]) ^ 0x80u, 0, 8388736.f);
        return __float_as_uint(x) >> 16;  // int8 -> bf16 is exact
      } else {
        return reinterpret_cast<const uint16_t*>(vrow + r * ROWB)[ch];
      }
    };
    const uint32_t* wh2 = reinterpret_cast<const uint32_t*>(wh + min(g, kn - 1) * chunk16);
    const uint32_t* wl2 = reinterpret_cast<const uint32_t*>(wl + min(g, kn - 1) * chunk16);
    float o_lo[4] = {0.f, 0.f, 0.f, 0.f};  // the low parts' products: a second chain
    for (int r0 = 0; r0 < nr; r0 += 16) {
      const int i = r0 / 2 + t;  // bf16 pair of rows r0 + 2t, r0 + 2t + 1
      const uint32_t ah0 = g < kn ? wh2[i] : 0u, ah1 = g < kn ? wh2[i + 4] : 0u;
      const uint32_t al0 = g < kn ? wl2[i] : 0u, al1 = g < kn ? wl2[i + 4] : 0u;
      const uint32_t b0 = v_at(r0 + 2 * t) | v_at(r0 + 2 * t + 1) << 16;
      const uint32_t b1 = v_at(r0 + 2 * t + 8) | v_at(r0 + 2 * t + 9) << 16;
      mma_bf16(o, ah0, 0u, ah1, 0u, b0, b1);
      mma_bf16(o_lo, al0, 0u, al1, 0u, b0, b1);
    }
    o[0] += o_lo[0];
    o[1] += o_lo[1];
    __syncthreads();  // the chunk's buffers free
  }

  // 7. Push this block's partials to the blocks that own their channels,
  // then merge the ones pushed here and write channels [DQ rank, DQ rank + DQ).
  split::cluster_wait();  // every block of the cluster is running
  if (g < kn) {
    const int d0 = 8 * warp + 2 * t;  // d0 and d0 + 1 have one owner: DQ is even
    float* dst = split::remote(&part_o[rank][g][d0 % DQ], d0 / DQ);
    dst[0] = o[0];
    dst[1] = o[1];
  }
  if (warp < kn && lane < CLUSTER) {
    float* ml = split::remote(&part_ml[rank][0][warp], lane);
    ml[0] = m_run;
    ml[KMAX] = l_run;
  }
  split::cluster_sync();
  if (tid < kn * DQ) {
    const int kd = tid / DQ, dd = tid % DQ;
    const float y = split::merge<CLUSTER>(&part_ml[0][0][kd], &part_ml[0][1][kd],
                                          &part_o[0][kd][dd], 2 * KMAX, KMAX * DQ);
    out[(static_cast<size_t>(out_row0 + kd) * H + h) * HD + rank * DQ + dd] = __float2bfloat16(y);
  }
}

template <bool INT8>
int launch_beam(const void* q, const void* k, const void* v, const void* k_scale,
                const void* v_scale, const void* anc, void* out, int B, int H, int C, int K,
                int cv, float scale, void* stream) {
  // Above 48 KB a block's dynamic shared memory needs this opt-in, once.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      beam_attention_kernel<INT8>, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYNAMIC_SMEM);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const uintptr_t align = reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v);
  if (B < 1 || H < 1 || K < 1 || K > MAX_BEAMS || cv < 1 || cv > C || C > 0xffff ||
      align % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int kg = group_size(K, C, cv, INT8);
  const size_t smem = layout(kg, K, C, cv, INT8).total;
  if (smem > MAX_DYNAMIC_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (K + kg - 1) / kg;
  beam_attention_kernel<INT8>
      <<<B * H * groups * CLUSTER, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const float*>(k_scale),
          static_cast<const float*>(v_scale), static_cast<const bool*>(anc),
          static_cast<__nv_bfloat16*>(out), H, C, K, kg, cv, scale * split::LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int sstw_beam_attention_bf16(const void* q, const void* k, const void* v,
                                        const void* anc, void* out, int B, int H, int C, int K,
                                        int cv, float scale, void* stream) {
  return launch_beam<false>(q, k, v, nullptr, nullptr, anc, out, B, H, C, K, cv, scale, stream);
}

extern "C" int sstw_beam_attention_i8(const void* q, const void* k, const void* v,
                                      const void* k_scale, const void* v_scale, const void* anc,
                                      void* out, int B, int H, int C, int K, int cv, float scale,
                                      void* stream) {
  return launch_beam<true>(q, k, v, k_scale, v_scale, anc, out, B, H, C, K, cv, scale, stream);
}

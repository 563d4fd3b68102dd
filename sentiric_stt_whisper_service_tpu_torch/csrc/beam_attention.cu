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
// bf16, or int8 with per-row scales [B*K, H, C].
//
// Bound on the H100: device memory. A step reads each item's K slot caches
// once for K destination beams: 4 * K flops per slab element, far below the
// ridge point. The TPU kernel streams the K slots through VMEM with an online
// softmax over the slots; shared memory cannot hold 2*K*C*64 bf16 at large C,
// but it does hold the K x (K*C) fp32 scores (16 KB at K = 5, C = 160;
// 45 KB at C = 448), so K5 takes the two-pass form of K3 instead, which also
// reads each row once. Design (simple first): one block of 256 threads per
// (b, h). Pass 1: a thread per (slot, position) reads its ancestry bits for
// the K destination beams straight from the bool mask (no transposed float
// copy as the TPU wrapper makes) and, if any beam reads that row, its 64-wide
// K row in 16-byte loads, and writes K masked scores to shared memory, with
// k_scale folded in; rows on no beam's path are never read. Then a per-beam
// block max and sum turn the scores into weights in place, v_scale folded in.
// Pass 2: a warp per (slot, position), each lane owning two of the 64 output
// channels, so a warp reads one V row in one coalesced load; rows whose
// weights are all zero are skipped. The 8 warps' partial outputs are summed
// through shared memory. c_valid bounds the positions read and need not be a
// multiple of anything. At B = 4, 20 heads that is 80 blocks on 132 SMs (the
// same under-fill as K3/K4); splitting slots or positions across blocks is
// later work.

#include "slab_attention.cuh"

namespace {

using slab::HD;
using slab::MAX_DYNAMIC_SMEM;
using slab::NEG;
using slab::THREADS;
using slab::WARPS;

constexpr int KMAX = 8;  // most beams a launch takes

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float i8_at(uint32_t w, int t) {
  return static_cast<float>(static_cast<int8_t>(w >> (8 * t)));
}

template <bool INT8>
__global__ void __launch_bounds__(THREADS)
beam_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [B*K, H, HD]
                      const void* __restrict__ k,           // [B*K, H, C, HD]
                      const void* __restrict__ v,
                      const float* __restrict__ k_scale,    // [B*K, H, C] (int8 only)
                      const float* __restrict__ v_scale,
                      const bool* __restrict__ anc,         // [B, K, K, C]
                      __nv_bfloat16* __restrict__ out,      // [B*K, H, HD]
                      int H, int C, int K, int cv, float scale) {
  // [K, K*cv] scores, then weights; after pass 2, [WARPS, KMAX, HD] partial outputs.
  extern __shared__ float sc[];
  __shared__ float qs[KMAX][HD];
  __shared__ float red[WARPS][KMAX];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int nj = K * cv;  // (source slot s, position c) pairs, j = s * cv + c
  auto row_of = [&](int j) {  // row of slot s, head h, position c in [B*K, H, C]
    return (static_cast<size_t>(b * K + j / cv) * H + h) * C + j % cv;
  };

  for (int i = threadIdx.x; i < KMAX * HD; i += THREADS) {
    const int kd = i / HD, d = i % HD;
    const size_t at = (static_cast<size_t>(b * K + kd) * H + h) * HD + d;
    qs[kd][d] = kd < K ? __bfloat162float(q[at]) * scale : 0.f;
  }
  __syncthreads();

  float mx[KMAX];
#pragma unroll
  for (int kd = 0; kd < KMAX; ++kd) mx[kd] = NEG;
  for (int j = threadIdx.x; j < nj; j += THREADS) {
    const int s = j / cv, c = j % cv;
    bool on[KMAX];
    bool any = false;
#pragma unroll
    for (int kd = 0; kd < KMAX; ++kd) {
      on[kd] = kd < K && anc[(static_cast<size_t>(b * K + kd) * K + s) * C + c];
      any |= on[kd];
    }
    float acc[KMAX];
#pragma unroll
    for (int kd = 0; kd < KMAX; ++kd) acc[kd] = 0.f;
    if (any) {
      const size_t r = row_of(j);
      // The 16-byte chunks stay a real loop: unrolled, the compiler hoists
      // all KMAX x 64 query values out of the j loop into registers and spills.
      if constexpr (INT8) {
        const uint4* kr = reinterpret_cast<const uint4*>(static_cast<const int8_t*>(k) + r * HD);
#pragma unroll 1
        for (int u = 0; u < HD / 16; ++u) {
          const uint4 p = kr[u];
          const uint32_t words[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int t = 0; t < 16; ++t) {
            const float kv = i8_at(words[t / 4], t % 4);
#pragma unroll
            for (int kd = 0; kd < KMAX; ++kd) acc[kd] = fmaf(qs[kd][u * 16 + t], kv, acc[kd]);
          }
        }
        const float ksc = k_scale[r];
#pragma unroll
        for (int kd = 0; kd < KMAX; ++kd) acc[kd] *= ksc;
      } else {
        const uint4* kr =
            reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(k) + r * HD);
#pragma unroll 1
        for (int u = 0; u < HD / 8; ++u) {
          const uint4 p = kr[u];
          const uint32_t words[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int t = 0; t < 8; ++t) {
            const float kv = (t % 2) ? bf16_hi(words[t / 2]) : bf16_lo(words[t / 2]);
#pragma unroll
            for (int kd = 0; kd < KMAX; ++kd) acc[kd] = fmaf(qs[kd][u * 8 + t], kv, acc[kd]);
          }
        }
      }
    }
#pragma unroll
    for (int kd = 0; kd < KMAX; ++kd) {
      if (kd >= K) break;
      const float score = on[kd] ? acc[kd] : NEG;
      sc[kd * nj + j] = score;
      mx[kd] = fmaxf(mx[kd], score);
    }
  }
  slab::block_reduce<KMAX>(mx, red, true);

  float sum[KMAX];
#pragma unroll
  for (int kd = 0; kd < KMAX; ++kd) {
    sum[kd] = 0.f;
    if (kd >= K) continue;
    for (int j = threadIdx.x; j < nj; j += THREADS) {
      const float e = expf(sc[kd * nj + j] - mx[kd]);
      sc[kd * nj + j] = e;
      sum[kd] += e;
    }
  }
  slab::block_reduce<KMAX>(sum, red, false);
#pragma unroll
  for (int kd = 0; kd < KMAX; ++kd) {
    if (kd >= K) break;
    const float inv = 1.f / sum[kd];
    for (int j = threadIdx.x; j < nj; j += THREADS) {
      float wgt = sc[kd * nj + j] * inv;
      if constexpr (INT8) {
        if (wgt != 0.f) wgt *= v_scale[row_of(j)];
      }
      sc[kd * nj + j] = wgt;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[KMAX][2];
#pragma unroll
  for (int kd = 0; kd < KMAX; ++kd) acc[kd][0] = acc[kd][1] = 0.f;
  for (int j = warp; j < nj; j += WARPS) {
    float wj[KMAX];
    bool any = false;
#pragma unroll
    for (int kd = 0; kd < KMAX; ++kd) {
      wj[kd] = kd < K ? sc[kd * nj + j] : 0.f;
      any |= wj[kd] != 0.f;
    }
    if (!any) continue;  // the same j across the warp: no divergence
    const size_t r = row_of(j);
    float v0, v1;
    if constexpr (INT8) {
      const char2 p = reinterpret_cast<const char2*>(static_cast<const int8_t*>(v) + r * HD)[lane];
      v0 = static_cast<float>(p.x);
      v1 = static_cast<float>(p.y);
    } else {
      const uint32_t p =
          reinterpret_cast<const uint32_t*>(static_cast<const __nv_bfloat16*>(v) + r * HD)[lane];
      v0 = bf16_lo(p);
      v1 = bf16_hi(p);
    }
#pragma unroll
    for (int kd = 0; kd < KMAX; ++kd) {
      acc[kd][0] = fmaf(wj[kd], v0, acc[kd][0]);
      acc[kd][1] = fmaf(wj[kd], v1, acc[kd][1]);
    }
  }
  __syncthreads();  // every weight read: sc now holds the partial outputs
  float* part = sc;
#pragma unroll
  for (int kd = 0; kd < KMAX; ++kd) {
    part[(warp * KMAX + kd) * HD + 2 * lane] = acc[kd][0];
    part[(warp * KMAX + kd) * HD + 2 * lane + 1] = acc[kd][1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K * HD; i += THREADS) {
    const int kd = i / HD, d = i % HD;
    float o = 0.f;
    for (int w = 0; w < WARPS; ++w) o += part[(w * KMAX + kd) * HD + d];
    out[(static_cast<size_t>(b * K + kd) * H + h) * HD + d] = __float2bfloat16(o);
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
  const int floats = K * K * cv > WARPS * KMAX * HD ? K * K * cv : WARPS * KMAX * HD;
  if (K < 1 || K > KMAX || static_cast<size_t>(floats) * sizeof(float) > MAX_DYNAMIC_SMEM) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  beam_attention_kernel<INT8><<<B * H, THREADS, floats * sizeof(float),
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const bool*>(anc),
      static_cast<__nv_bfloat16*>(out), H, C, K, cv, scale);
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

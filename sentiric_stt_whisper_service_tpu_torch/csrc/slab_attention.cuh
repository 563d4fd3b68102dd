// Attention of M <= 8 query rows over one KF-layout slab [S, H, 64, F] per
// (item s, head h): the kernel behind K3 (M = 1, csrc/decode_attention.cu).
// Only M = 1 is launched. The row template is kept, because a single-row
// rewrite of the same loops compiled K3's bf16 form 35 % slower on the H100
// (PERF.md); the multi-row support can go once an equally fast single-row
// version lands. K5 and K6 use its constants, K6 its block reduction and
// slab forms. Two slab forms here (K4's packed int4 form has its own kernel,
// csrc/decode_attention_i4.cu; K6 reads kInt4 too):
//   * bf16 slab, optional causal bound pos[s]
//   * int8 slab with per-position scales
//
// What it computes, per (s, h) and query row m:
//   score[m, f] = (q[m] . k[:, f]) * scale * k_scale[f]   (f <= pos[s] if given)
//   w[m, f]     = softmax_f(score[m])[f] * v_scale[f]
//   out[m, d]   = sum_f w[m, f] * v[d, f]                (fp32, stored as bf16)
//
// Bound on the H100: device memory. Each (s, h) reads its slab once for
// 4 * M flops per slab element, far below the ridge point at M <= 8. Design
// (simple first): one block of 256 threads per (s, h); the M query rows share
// every slab element read, so M rows cost one slab read. Pass 1: each thread
// takes positions f, f + 256, ...; for each of the 64 d it reads k[d][f], so
// consecutive threads read consecutive elements of one row of the KF layout,
// and multiplies it into M accumulators. Scores go to shared memory (M x F
// fp32, 30 KB at M = 5, F = 1500), then per-row block max and sum give the
// softmax weights in place, with v_scale folded in. Pass 2: each warp owns 8
// of the 64 output channels; its lanes stride the positions of one row of v,
// again shared by the M rows, and reduce with shuffles. What it lacks for
// speed is what K4's redesign has (csrc/decode_attention_i4.cu): a cluster
// of blocks per (s, h) splitting F (only S * H = 80 blocks at the slices'
// shapes for 132 SMs), all of a block's bytes requested at once, and one
// pass through the scores.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace slab {
namespace {  // internal linkage: each .cu that includes this has its own copy

constexpr int HD = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr float NEG = -1e30f;  // the JAX package's mask value
constexpr int MAX_DYNAMIC_SMEM = 200 * 1024;  // of the 227 KB a block may use

enum Form { kBf16 = 0, kInt8 = 1, kInt4 = 2 };  // kInt4: K6's packed carrier only

// Reduce MM values per thread over the block (max or sum); every thread gets
// the results. Row order and warp order are fixed, so a run is reproducible.
template <int MM>
__device__ __forceinline__ void block_reduce(float (&x)[MM], float (*red)[MM], bool is_max) {
#pragma unroll
  for (int m = 0; m < MM; ++m) {
    for (int off = 16; off > 0; off >>= 1) {
      const float y = __shfl_xor_sync(0xffffffffu, x[m], off);
      x[m] = is_max ? fmaxf(x[m], y) : x[m] + y;
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red[] free from any earlier reduction
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < MM; ++m) red[warp][m] = x[m];
  }
  __syncthreads();
#pragma unroll
  for (int m = 0; m < MM; ++m) {
    x[m] = red[0][m];
    for (int w = 1; w < WARPS; ++w) x[m] = is_max ? fmaxf(x[m], red[w][m]) : x[m] + red[w][m];
  }
}

template <int FORM>
__device__ __forceinline__ float slab_at(const void* slab, size_t i) {
  if constexpr (FORM == kBf16) {
    return __bfloat162float(static_cast<const __nv_bfloat16*>(slab)[i]);
  } else {
    return static_cast<float>(static_cast<const int8_t*>(slab)[i]);
  }
}

// MM is the compile-time row capacity, M <= MM the rows of this launch.
template <int FORM, int MM>
__global__ void __launch_bounds__(THREADS)
slab_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [S, H, M, HD]
                      const void* __restrict__ k,           // [S, H, HD, F] (F/2 for int4)
                      const void* __restrict__ v,
                      const float* __restrict__ k_scale,    // [S, H, F]
                      const float* __restrict__ v_scale,
                      const int* __restrict__ pos,          // [S] or null
                      __nv_bfloat16* __restrict__ out,      // [S, H, M, HD]
                      int H, int F, int M, float scale) {
  extern __shared__ float w[];  // [M, F]
  __shared__ float qs[MM][HD];
  __shared__ float red[WARPS][MM];

  const int sh = blockIdx.x;  // s * H + h
  const size_t slab = static_cast<size_t>(sh) * HD * F;
  const float* ks = (FORM == kBf16) ? nullptr : k_scale + static_cast<size_t>(sh) * F;
  const float* vs = (FORM == kBf16) ? nullptr : v_scale + static_cast<size_t>(sh) * F;
  const int limit = pos ? pos[sh / H] : F - 1;
  auto live = [M](int m) { return MM == 1 || m < M; };

  for (int i = threadIdx.x; i < MM * HD; i += THREADS) {
    const int m = i / HD;
    qs[m][i % HD] =
        live(m) ? __bfloat162float(q[static_cast<size_t>(sh) * M * HD + i]) * scale : 0.f;
  }
  __syncthreads();

  float mx[MM];
#pragma unroll
  for (int m = 0; m < MM; ++m) mx[m] = NEG;
  for (int f = threadIdx.x; f < F; f += THREADS) {
    float acc[MM];
#pragma unroll
    for (int m = 0; m < MM; ++m) acc[m] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float kv = slab_at<FORM>(k, slab + d * F + f);
#pragma unroll
      for (int m = 0; m < MM; ++m) acc[m] = fmaf(qs[m][d], kv, acc[m]);
    }
#pragma unroll
    for (int m = 0; m < MM; ++m) {
      if (!live(m)) continue;
      if constexpr (FORM == kInt8) acc[m] *= ks[f];
      if (f > limit) acc[m] = NEG;
      w[m * F + f] = acc[m];
      mx[m] = fmaxf(mx[m], acc[m]);
    }
  }
  block_reduce<MM>(mx, red, true);

  float sum[MM];
#pragma unroll
  for (int m = 0; m < MM; ++m) {
    sum[m] = 0.f;
    if (!live(m)) continue;
    for (int f = threadIdx.x; f < F; f += THREADS) {
      const float e = expf(w[m * F + f] - mx[m]);
      w[m * F + f] = e;
      sum[m] += e;
    }
  }
  block_reduce<MM>(sum, red, false);
#pragma unroll
  for (int m = 0; m < MM; ++m) {
    if (!live(m)) continue;
    const float inv = 1.f / sum[m];
    for (int f = threadIdx.x; f < F; f += THREADS) {
      w[m * F + f] = (FORM == kBf16) ? w[m * F + f] * inv : w[m * F + f] * inv * vs[f];
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int d = warp; d < HD; d += WARPS) {
    float acc[MM];
#pragma unroll
    for (int m = 0; m < MM; ++m) acc[m] = 0.f;
    for (int f = lane; f < F; f += 32) {
      const float vv = slab_at<FORM>(v, slab + static_cast<size_t>(d) * F + f);
#pragma unroll
      for (int m = 0; m < MM; ++m) {
        if (live(m)) acc[m] = fmaf(w[m * F + f], vv, acc[m]);
      }
    }
#pragma unroll
    for (int m = 0; m < MM; ++m) {
      for (int off = 16; off > 0; off >>= 1) acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
      if (lane == 0 && live(m)) out[(static_cast<size_t>(sh) * M + m) * HD + d] = __float2bfloat16(acc[m]);
    }
  }
}

// Launch over S * H blocks with M * F floats of dynamic shared memory. One
// row (K3/K4) stays under the 48 KB that needs no opt-in (the wrapper bounds
// F); more rows opt in once to MAX_DYNAMIC_SMEM.
template <int FORM, int MM>
int launch(const void* q, const void* k, const void* v, const void* k_scale, const void* v_scale,
           const void* pos, void* out, int S, int H, int F, int M, float scale, void* stream) {
  if constexpr (MM > 1) {
    static const cudaError_t opt_in =
        cudaFuncSetAttribute(slab_attention_kernel<FORM, MM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_DYNAMIC_SMEM);
    if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
    if (M < 1 || M > MM || static_cast<size_t>(M) * F * sizeof(float) > MAX_DYNAMIC_SMEM) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  slab_attention_kernel<FORM, MM>
      <<<S * H, THREADS, static_cast<size_t>(M) * F * sizeof(float),
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const __nv_bfloat16*>(q), k, v, static_cast<const float*>(k_scale),
          static_cast<const float*>(v_scale), static_cast<const int*>(pos),
          static_cast<__nv_bfloat16*>(out), H, F, M, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace slab

// Pieces shared by K3 (csrc/decode_attention.cu), K4
// (csrc/decode_attention_i4.cu) and K5 (csrc/beam_attention.cu): kernels
// that split the positions of one softmax row over the NB blocks of a
// thread-block cluster. Each block requests all of its bytes at once
// (cp.async into shared memory), takes a local softmax over its positions
// and keeps (m, l, o): the row max in log2 units, the sum
// of 2^(s - m) and the weighted sum of values. Block r owns an NB-th of the
// output channels: every block pushes its m, l and the o of those channels
// into block r's shared memory (remote stores over distributed shared
// memory), one cluster barrier later block r merges them from its own
// shared memory,
//   M = max_p m_p,   out = sum_p o_p 2^(m_p - M) / sum_p l_p 2^(m_p - M),
// the softmax over all positions in another rounding order. No block reads
// another's shared memory, so none waits for the others after the barrier.
// A block with no positions keeps m = -inf (or the mask value), l = 0, o = 0
// and adds nothing.
// K3 and K4 also share the copy of a block's piece of 64 rows that start on
// any byte boundary (copy_pieces) and the end of the kernel: the sums of the
// rows' partials over a warp (warp_row_sums), the pushes, the merge and the
// store of the block's channels (push_merge_store).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace split {
namespace {  // internal linkage: each .cu that includes this has its own copy

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = ex2(-1e30) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Asynchronous copies global -> shared: 16 bytes (both addresses 16-byte
// aligned) or 4 bytes. The calling thread's copies since the last commit
// form a group; cp_async_wait<N>() waits until at most N of its groups are
// still in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The cluster barrier in two halves. Every thread of every block of the
// cluster calls each, in the same order: arrive (relaxed) when the block
// starts and wait before its first remote store (so every block of the
// cluster is running), then sync (release, acquire) once the pushes are
// done.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// This thread's address of `p` in the shared memory of cluster block `rank`.
template <typename T>
__device__ __forceinline__ T* remote(T* p, uint32_t rank) {
  uint64_t out;
  asm volatile("mapa.u64 %0, %1, %2;\n" : "=l"(out) : "l"(p), "r"(rank));
  return reinterpret_cast<T*>(out);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// The max or sum of x over a block of NW warps, in every thread; red holds
// NW floats. One barrier: a block that reduces twice uses two red arrays.
template <int NW>
__device__ __forceinline__ float block_reduce(float x, float* red, bool is_max) {
  x = is_max ? warp_max(x) : warp_sum(x);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  x = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) x = is_max ? fmaxf(x, red[w]) : x + red[w];
  return x;
}

// One step of a reduce-scatter over lanes: partners `lane ^ lane_xor` each
// keep one half of x (the upper half where `upper`) and add the other's copy
// of it, so after log2(N) steps each lane holds one sum of N.
template <int HALF, int N>
__device__ __forceinline__ void scatter_step(float (&x)[N], bool upper, int lane_xor) {
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? x[i] : x[i + HALF];
    const float keep = upper ? x[i + HALF] : x[i];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, send, lane_xor);
  }
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }

// A small integer -> fp32 without an integer-to-float conversion: byte t of
// w, biased to be unsigned, goes into the low mantissa bits of 2^23 and the
// bias (2^23 plus the byte's) is subtracted (exact).
__device__ __forceinline__ float byte_at(uint32_t w, int t, float bias) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 | t)) - bias;
}
// The signed low and high nibbles of four carrier bytes (n ^ 8 = n + 8).
__device__ __forceinline__ void nib4(uint32_t w, float (&lo)[4], float (&hi)[4]) {
  const uint32_t l = (w & 0x0F0F0F0Fu) ^ 0x08080808u;
  const uint32_t h = ((w >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    lo[t] = byte_at(l, t, 8388616.f);
    hi[t] = byte_at(h, t, 8388616.f);
  }
}

// Requests a block's piece of ROWS rows: row d's `nbytes` bytes start at
// base + d * row_bytes, on any byte boundary, and are copied with 16-byte
// cp.async from the aligned address at or below that start into
// dst + d * stride (the piece's bytes keep their offset mod 16). Eight lanes
// a row, so a warp's requests cover four rows' contiguous runs.
template <int ROWS, int THREADS>
__device__ __forceinline__ void copy_pieces(uintptr_t base, size_t row_bytes, int nbytes,
                                            unsigned char* dst, int stride) {
  if (nbytes <= 0) return;
  for (int d = threadIdx.x / 8; d < ROWS; d += THREADS / 8) {
    const uintptr_t at = base + d * row_bytes;
    const uintptr_t unit0 = at & ~static_cast<uintptr_t>(15);
    for (int u = threadIdx.x % 8; 16 * u < static_cast<int>(at & 15) + nbytes; u += 8) {
      cp_async16(dst + d * stride + 16 * u, reinterpret_cast<const void*>(unit0 + 16 * u));
    }
  }
}

// The sums over a warp's 32 lanes of eight rows' partials acc[r]: a
// reduce-scatter (7 shuffles, then 2 adds) that leaves row (lane >> 2)'s sum
// in every lane of its quad.
__device__ __forceinline__ float warp_row_sums(float (&acc)[8], int lane) {
  scatter_step<4>(acc, lane & 16, 16);
  scatter_step<2>(acc, lane & 8, 8);
  scatter_step<1>(acc, lane & 4, 4);
  acc[0] += __shfl_xor_sync(0xffffffffu, acc[0], 2);
  return acc[0] + __shfl_xor_sync(0xffffffffu, acc[0], 1);
}

// The merge of NB blocks' partials pushed into this block: m[p * ms] and
// l[p * ms] are block p's row max and sum, o[p * os] its partial output.
template <int NB>
__device__ __forceinline__ float merge(const float* m, const float* l, const float* o, int ms,
                                       int os) {
  float big = -INFINITY;
#pragma unroll
  for (int p = 0; p < NB; ++p) big = fmaxf(big, m[p * ms]);
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int p = 0; p < NB; ++p) {
    const float f = ex2(m[p * ms] - big);
    den = fmaf(l[p * ms], f, den);
    num = fmaf(o[p * os], f, num);
  }
  return num / den;
}


// The end of a cluster of NB blocks over one (item, head) whose 4 warps each
// hold 16 of the HD = 64 output rows, row 16 w + 8 pass + (lane >> 2) in
// res[pass] of every lane of its quad: every block pushes m, l and its o of
// block r's channels [HD/NB r, HD/NB r + HD/NB) into block r's part_ml and
// part_o, and one cluster barrier later merges the partials pushed to it
// and writes its channels of `out` (the (item, head)'s HD outputs).
template <int NB, int HD>
__device__ __forceinline__ void push_merge_store(const float (&res)[2], float m, float l,
                                                 float (&part_o)[NB][HD / NB],
                                                 float (&part_ml)[NB][2], int rank,
                                                 __nv_bfloat16* out) {
  constexpr int DQ = HD / NB;
  static_assert(HD == 64, "four warps of 16 rows");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  cluster_wait();  // every block of the cluster is running
  if ((lane & 3) == 0) {
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int d = 16 * warp + 8 * pass + (lane >> 2);
      *remote(&part_o[rank][d % DQ], d / DQ) = res[pass];
    }
  }
  if (tid < NB) {
    float* ml = remote(&part_ml[rank][0], tid);
    ml[0] = m;
    ml[1] = l;
  }
  cluster_sync();
  if (tid < DQ) {
    out[rank * DQ + tid] =
        __float2bfloat16(merge<NB>(&part_ml[0][0], &part_ml[0][1], &part_o[0][tid], 2, DQ));
  }
}

}  // namespace
}  // namespace split

// P1: approximate int8 encoder attention in the style of SageAttention, bf16
// in and out.
//
// Replaces the Pallas TPU kernel tools/bench_flash_int8.py:_quant_kernel,
// launched by flash_q8 (pallas_call at tools/bench_flash_int8.py:105), a probe
// that no serving path of the JAX package calls. The plain PyTorch version is
// ops/flash_q8.py:flash_q8_plain in this package.
//
// What it computes, per (batch*head), with L the real length (see
// ops/flash_q8.py): q quantized per row (q8 = rint(q * (127 / qmax))), k per
// head over all of K (k8 = rint(k * (127 / kmax))); scores = (q8 . k8^T in
// int32) * (qmax * (kmax / 127^2)); e = exp(scores - rowmax), s = sum of e in
// fp32. Mode qk8: o = bf16(e) . v in fp32. Mode full8: v quantized per head and
// channel over L (v8 = rint(v * (127 / vmax))), p8 = rint(e * 127), o = (p8 .
// v8 in int32) * (vmax / 127^2). Then o / s in bf16. Every division is a true
// IEEE division and rint rounds half to even (no --use_fast_math), so the codes
// equal the plain version's bit for bit.
//
// Bound on the H100 at the probe's shape ([16, 20, 1500, 64]): QK^T is 9.2e10
// int8 operations (0.047 ms at 1,979 TOP/s), PV 9.2e10 bf16 FLOP in qk8 (0.093
// ms at 989 TFLOP/s) or int8 operations in full8 (0.047 ms), against 246 MB of
// q, k, v and output (0.073 ms at 3.35 TB/s): operations bound it, 0.140 ms
// (qk8) and 0.093 ms (full8).
//
// Design, a first kernel that is right (not yet fast):
//  * kmax and vmax depend on all of K and V, which no query tile sees alone:
//    a pre-pass, one block per (batch*head), reduces them and writes k8
//    [bh, lp, 64] and, for full8, v8 channel-major [bh, 64, lp] (through a
//    shared-memory transpose), both zero-padded to lp, a multiple of 64 keys.
//  * full8 quantizes e against the row's true max, which an online softmax's
//    running max would change, so the attention kernel makes two passes over
//    the key tiles per query tile: the first runs QK^T for the row maxima, the
//    second runs it again (exact in int32, so the same scores bit for bit)
//    and forms e, its sum s and the PV product.
//  * One block of four warps per (batch*head, 64 query rows), 16 rows a warp.
//    Each warp quantizes its rows into shared memory and keeps them in
//    registers as the A operand of QK^T on the int8 tensor cores
//    (mma.sync m16n8k32 s8 -> s32) against 64-key tiles of k8 in shared
//    memory. qk8's PV runs bf16(e) from the score fragments (the m16n8k16 A
//    layout is two m16n8 accumulator tiles) against the V tile on
//    mma.sync m16n8k16 bf16 -> fp32; full8's PV stages p8 through the warp's
//    own shared memory into the m16n8k32 A layout and runs it against the v8
//    tile on mma.sync s8 -> s32 (127 * 127 * 1500 < 2^31).
//  * Scores use __fmul_rn / __fsub_rn, so no FMA contraction rounds them
//    differently from the plain version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;             // head dim
constexpr int BQ = 64;            // query rows per block, 16 per warp
constexpr int BK = 64;            // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int PREP_THREADS = 256; // pre-pass block: 8 chunks of 8 channels x 32 rows
constexpr int PREP_ROWS = PREP_THREADS / 8;
constexpr int I8_STRIDE = D + 16;  // bytes per row of an int8 tile (80: conflict-free reads)
constexpr int BF_STRIDE = D + 8;   // elements per row of the bf16 V tile (144 bytes)
constexpr float Q127 = 127.f * 127.f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (static_cast<uint32_t>(a) & 0xff) | ((static_cast<uint32_t>(b) & 0xff) << 8) |
         ((static_cast<uint32_t>(c) & 0xff) << 16) | ((static_cast<uint32_t>(d) & 0xff) << 24);
}

__device__ __forceinline__ int code(float x, float scale) {
  return static_cast<int>(rintf(__fmul_rn(x, scale)));
}

// D = A B + D on the int8 tensor cores, one warp: A 16 x 32 s8 (row-major), B
// 32 x 8 s8 (column-major), D 16 x 8 s32; fragments as the PTX ISA lays them
// out for mma.m16n8k32 (g = lane / 4, t = lane % 4: a[0] holds A[g][4t..4t+3],
// a[1] A[g + 8][4t..], a[2] A[g][16 + 4t..], a[3] A[g + 8][16 + 4t..]; b0
// B[4t..4t+3][g], b1 B[16 + 4t..][g]; d[0..1] D[g][2t, 2t + 1], d[2..3]
// D[g + 8][..]). The lowest byte of a register holds the lowest index.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The same for bf16, m16n8k16 -> fp32 (a[0] A[g][2t, 2t + 1], a[1] A[g + 8][..],
// a[2] A[g][2t + 8, 2t + 9], a[3] A[g + 8][..]; b0 B[2t, 2t + 1][g], b1
// B[2t + 8, 2t + 9][g]; d as above).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Pre-pass, one block per (batch*head): kmax and k8 [lp, 64]; with full8 also
// vmax [64] and v8 channel-major [64, lp]. Rows L..lp-1 are zeros.
__global__ void __launch_bounds__(PREP_THREADS)
flash_q8_quant_kernel(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                      int8_t* __restrict__ k8, float* __restrict__ kmax_out,
                      int8_t* __restrict__ v8t, float* __restrict__ vmax_out, int L, int lp,
                      int full8) {
  __shared__ float vred[PREP_ROWS][D];
  __shared__ float kred[PREP_THREADS / 32];
  __shared__ float scale_s[D + 1];  // 127 / vmax per channel, then 127 / kmax
  __shared__ __align__(16) int8_t tile[D][I8_STRIDE];
  const int bh = blockIdx.x, tid = threadIdx.x, lane = tid % 32;
  const int c = tid & 7, r0 = tid >> 3;  // this thread's chunk of 8 channels, first row
  const __nv_bfloat16* kh = k + static_cast<size_t>(bh) * L * D;
  const __nv_bfloat16* vh = v + static_cast<size_t>(bh) * L * D;

  float km = 0.f, vm[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int r = r0; r < L; r += PREP_ROWS) {
    const uint4 kv = *reinterpret_cast<const uint4*>(kh + static_cast<size_t>(r) * D + c * 8);
    const __nv_bfloat16* kx = reinterpret_cast<const __nv_bfloat16*>(&kv);
#pragma unroll
    for (int j = 0; j < 8; ++j) km = fmaxf(km, fabsf(__bfloat162float(kx[j])));
    if (full8) {
      const uint4 vv = *reinterpret_cast<const uint4*>(vh + static_cast<size_t>(r) * D + c * 8);
      const __nv_bfloat16* vx = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) vm[j] = fmaxf(vm[j], fabsf(__bfloat162float(vx[j])));
    }
  }
  km = warp_max(km);
  if (lane == 0) kred[tid / 32] = km;
#pragma unroll
  for (int j = 0; j < 8; ++j) vred[r0][c * 8 + j] = vm[j];
  __syncthreads();
  if (tid < D && full8) {
    float m = 0.f;
    for (int i = 0; i < PREP_ROWS; ++i) m = fmaxf(m, vred[i][tid]);
    m = fmaxf(m, 1e-6f);
    vmax_out[static_cast<size_t>(bh) * D + tid] = m;
    scale_s[tid] = 127.f / m;
  }
  if (tid == D) {
    float m = 0.f;
    for (int i = 0; i < PREP_THREADS / 32; ++i) m = fmaxf(m, kred[i]);
    m = fmaxf(m, 1e-6f);
    kmax_out[bh] = m;
    scale_s[D] = 127.f / m;
  }
  __syncthreads();

  const float ks = scale_s[D];
  int8_t* k8h = k8 + static_cast<size_t>(bh) * lp * D;
  for (int r = r0; r < lp; r += PREP_ROWS) {
    uint2 packed = make_uint2(0u, 0u);
    if (r < L) {
      const uint4 kv = *reinterpret_cast<const uint4*>(kh + static_cast<size_t>(r) * D + c * 8);
      const __nv_bfloat16* kx = reinterpret_cast<const __nv_bfloat16*>(&kv);
      float x[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) x[j] = __bfloat162float(kx[j]);
      packed.x = pack4(code(x[0], ks), code(x[1], ks), code(x[2], ks), code(x[3], ks));
      packed.y = pack4(code(x[4], ks), code(x[5], ks), code(x[6], ks), code(x[7], ks));
    }
    *reinterpret_cast<uint2*>(k8h + static_cast<size_t>(r) * D + c * 8) = packed;
  }
  if (!full8) return;

  // v8 channel-major: each tile of 64 keys quantized into [channel][key] in
  // shared memory, then written out in rows of 64 bytes.
  int8_t* v8h = v8t + static_cast<size_t>(bh) * D * lp;
  for (int t0 = 0; t0 < lp; t0 += BK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * PREP_THREADS, r = idx >> 3, cc = idx & 7, key = t0 + r;
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < L) vv = *reinterpret_cast<const uint4*>(vh + static_cast<size_t>(key) * D + cc * 8);
      const __nv_bfloat16* vx = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int ch = cc * 8 + j;
        tile[ch][r] = static_cast<int8_t>(key < L ? code(__bfloat162float(vx[j]), scale_s[ch]) : 0);
      }
    }
    __syncthreads();
    const int ch = tid >> 2, part = tid & 3;
    *reinterpret_cast<uint4*>(v8h + static_cast<size_t>(ch) * lp + t0 + part * 16) =
        *reinterpret_cast<const uint4*>(&tile[ch][part * 16]);
    __syncthreads();
  }
}

// S = q8 . k8^T for the warp's 16 rows against the 64 keys of the tile:
// acc[j] is the m16n8 tile of keys 8j..8j+7.
__device__ __forceinline__ void tile_scores(int (&acc)[8][4], const uint32_t (&qa)[2][4],
                                            const int8_t (*k8s)[I8_STRIDE], int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      const int8_t* row = k8s[j * 8 + g] + kk * 32 + 4 * t;
      mma_s8(acc[j], qa[kk], *reinterpret_cast<const uint32_t*>(row),
             *reinterpret_cast<const uint32_t*>(row + 16));
    }
  }
}

template <bool FULL8>
__global__ void __launch_bounds__(THREADS)
flash_q8_kernel(const __nv_bfloat16* __restrict__ q,    // [bh, L, 64]
                const __nv_bfloat16* __restrict__ v,    // [bh, L, 64] (qk8)
                const int8_t* __restrict__ k8,          // [bh, lp, 64]
                const float* __restrict__ kmax,         // [bh]
                const int8_t* __restrict__ v8t,         // [bh, 64, lp] (full8)
                const float* __restrict__ vmax,         // [bh, 64] (full8)
                __nv_bfloat16* __restrict__ out,        // [bh, L, 64]
                int8_t* __restrict__ q8_out,            // [bh, L, 64] or null
                int L, int lp) {
  __shared__ __align__(16) int8_t q8s[BQ][I8_STRIDE];
  __shared__ __align__(16) int8_t k8s[BK][I8_STRIDE];
  // qk8: the V tile [key][channel] bf16; full8: the v8 tile [channel][key].
  __shared__ __align__(16) unsigned char vbuf[FULL8 ? D * I8_STRIDE : BK * BF_STRIDE * 2];
  __shared__ __align__(16) int8_t p8s[FULL8 ? WARPS : 1][16][I8_STRIDE];
  __shared__ float qmax_s[BQ];

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wr = warp * 16;  // the warp's first row in the block

  // Quantize the warp's 16 query rows, one row at a time across the warp.
  const __nv_bfloat16* qh = q + static_cast<size_t>(bh) * L * D;
  for (int rr = 0; rr < 16; ++rr) {
    const int row = q0 + wr + rr;
    float a = 0.f, b = 0.f;
    if (row < L) {
      const __nv_bfloat162 x =
          *reinterpret_cast<const __nv_bfloat162*>(qh + static_cast<size_t>(row) * D + 2 * lane);
      a = __low2float(x);
      b = __high2float(x);
    }
    const float qm = fmaxf(warp_max(fmaxf(fabsf(a), fabsf(b))), 1e-6f);
    const float scale = 127.f / qm;
    const int ca = code(a, scale), cb = code(b, scale);
    q8s[wr + rr][2 * lane] = static_cast<int8_t>(ca);
    q8s[wr + rr][2 * lane + 1] = static_cast<int8_t>(cb);
    if (q8_out != nullptr && row < L) {
      *reinterpret_cast<uint16_t*>(q8_out + (static_cast<size_t>(bh) * L + row) * D + 2 * lane) =
          static_cast<uint16_t>((ca & 0xff) | ((cb & 0xff) << 8));
    }
    if (lane == 0) qmax_s[wr + rr] = qm;
  }
  __syncwarp();
  uint32_t qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const int col = kk * 32 + 4 * t;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(&q8s[wr + g][col]);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(&q8s[wr + g + 8][col]);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(&q8s[wr + g][col + 16]);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(&q8s[wr + g + 8][col + 16]);
  }
  const float kscale = kmax[bh] / Q127;
  const float mult[2] = {__fmul_rn(qmax_s[wr + g], kscale), __fmul_rn(qmax_s[wr + g + 8], kscale)};

  const int8_t* k8h = k8 + static_cast<size_t>(bh) * lp * D;
  auto load_k8 = [&](int t0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * THREADS, r = idx >> 2, part = idx & 3;
      *reinterpret_cast<uint4*>(&k8s[r][part * 16]) =
          *reinterpret_cast<const uint4*>(k8h + static_cast<size_t>(t0 + r) * D + part * 16);
    }
  };

  // Pass 1: the row maxima of the scores over the real keys.
  int acc[8][4];
  float m[2] = {-INFINITY, -INFINITY};
  for (int t0 = 0; t0 < lp; t0 += BK) {
    __syncthreads();
    load_k8(t0);
    __syncthreads();
    tile_scores(acc, qa, k8s, g, t);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (t0 + j * 8 + 2 * t + (e & 1) < L) {
          m[e >> 1] = fmaxf(m[e >> 1], __fmul_rn(__int2float_rn(acc[j][e]), mult[e >> 1]));
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
  }

  // Pass 2: the same scores, e, its sum and PV.
  float s[2] = {0.f, 0.f};
  float oacc[8][4];
  int oacc_i[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      oacc[n][e] = 0.f;
      oacc_i[n][e] = 0;
    }
  }
  const __nv_bfloat16* vh = v + static_cast<size_t>(bh) * L * D;
  const int8_t* v8h = v8t + static_cast<size_t>(bh) * D * lp;
  for (int t0 = 0; t0 < lp; t0 += BK) {
    __syncthreads();
    load_k8(t0);
    if constexpr (FULL8) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int idx = tid + i * THREADS, ch = idx >> 2, part = idx & 3;
        *reinterpret_cast<uint4*>(vbuf + ch * I8_STRIDE + part * 16) =
            *reinterpret_cast<const uint4*>(v8h + static_cast<size_t>(ch) * lp + t0 + part * 16);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int idx = tid + i * THREADS, r = idx >> 3, c = idx & 7, key = t0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (key < L) val = *reinterpret_cast<const uint4*>(vh + static_cast<size_t>(key) * D + c * 8);
        *reinterpret_cast<uint4*>(vbuf + (r * BF_STRIDE + c * 8) * 2) = val;
      }
    }
    __syncthreads();
    tile_scores(acc, qa, k8s, g, t);
    float e[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int h = x >> 1;
        e[j][x] = 0.f;
        if (t0 + j * 8 + 2 * t + (x & 1) < L) {
          e[j][x] = expf(__fsub_rn(__fmul_rn(__int2float_rn(acc[j][x]), mult[h]), m[h]));
        }
        s[h] += e[j][x];
      }
    }
    if constexpr (FULL8) {
      int8_t (*p8w)[I8_STRIDE] = p8s[warp];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          p8w[g + 8 * (x >> 1)][j * 8 + 2 * t + (x & 1)] =
              static_cast<int8_t>(code(e[j][x], 127.f));
        }
      }
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int col = kk * 32 + 4 * t;
        const uint32_t pa[4] = {*reinterpret_cast<const uint32_t*>(&p8w[g][col]),
                                *reinterpret_cast<const uint32_t*>(&p8w[g + 8][col]),
                                *reinterpret_cast<const uint32_t*>(&p8w[g][col + 16]),
                                *reinterpret_cast<const uint32_t*>(&p8w[g + 8][col + 16])};
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const unsigned char* vrow = vbuf + (n * 8 + g) * I8_STRIDE + col;
          mma_s8(oacc_i[n], pa, *reinterpret_cast<const uint32_t*>(vrow),
                 *reinterpret_cast<const uint32_t*>(vrow + 16));
        }
      }
      __syncwarp();
    } else {
      const uint16_t* vs = reinterpret_cast<const uint16_t*>(vbuf);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint32_t pa[4] = {pack_bf16(e[2 * ks][0], e[2 * ks][1]),
                                pack_bf16(e[2 * ks][2], e[2 * ks][3]),
                                pack_bf16(e[2 * ks + 1][0], e[2 * ks + 1][1]),
                                pack_bf16(e[2 * ks + 1][2], e[2 * ks + 1][3])};
        const int k0 = ks * 16 + 2 * t;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int ch = n * 8 + g;
          const uint32_t b0 = static_cast<uint32_t>(vs[k0 * BF_STRIDE + ch]) |
                              (static_cast<uint32_t>(vs[(k0 + 1) * BF_STRIDE + ch]) << 16);
          const uint32_t b1 = static_cast<uint32_t>(vs[(k0 + 8) * BF_STRIDE + ch]) |
                              (static_cast<uint32_t>(vs[(k0 + 9) * BF_STRIDE + ch]) << 16);
          mma_bf16(oacc[n], pa, b0, b1);
        }
      }
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 1);
    s[h] += __shfl_xor_sync(0xffffffffu, s[h], 2);
  }

  __nv_bfloat16* oh = out + static_cast<size_t>(bh) * L * D;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int ch = n * 8 + 2 * t;
    float o[4];
    if constexpr (FULL8) {
      const float vs0 = vmax[static_cast<size_t>(bh) * D + ch] / Q127;
      const float vs1 = vmax[static_cast<size_t>(bh) * D + ch + 1] / Q127;
#pragma unroll
      for (int x = 0; x < 4; ++x) o[x] = __fmul_rn(__int2float_rn(oacc_i[n][x]), (x & 1) ? vs1 : vs0);
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) o[x] = oacc[n][x];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + wr + g + 8 * h;
      if (row < L) {
        *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<size_t>(row) * D + ch) =
            __floats2bfloat162_rn(o[2 * h] / s[h], o[2 * h + 1] / s[h]);
      }
    }
  }
}

}  // namespace

extern "C" int sstw_flash_q8(const void* q, const void* k, const void* v, void* o, void* k8,
                             void* kmax, void* v8t, void* vmax, void* q8, int bh, int L,
                             int full8, void* stream) {
  if (bh < 1 || bh > 65535 || L < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int lp = (L + BK - 1) / BK * BK;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  flash_q8_quant_kernel<<<bh, PREP_THREADS, 0, st>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<int8_t*>(k8), static_cast<float*>(kmax), static_cast<int8_t*>(v8t),
      static_cast<float*>(vmax), L, lp, full8);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + BQ - 1) / BQ, bh);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  if (full8) {
    flash_q8_kernel<true><<<grid, THREADS, 0, st>>>(
        qp, vp, static_cast<const int8_t*>(k8), static_cast<const float*>(kmax),
        static_cast<const int8_t*>(v8t), static_cast<const float*>(vmax),
        static_cast<__nv_bfloat16*>(o), static_cast<int8_t*>(q8), L, lp);
  } else {
    flash_q8_kernel<false><<<grid, THREADS, 0, st>>>(
        qp, vp, static_cast<const int8_t*>(k8), static_cast<const float*>(kmax),
        static_cast<const int8_t*>(v8t), static_cast<const float*>(vmax),
        static_cast<__nv_bfloat16*>(o), static_cast<int8_t*>(q8), L, lp);
  }
  return static_cast<int>(cudaGetLastError());
}

// W8: the weight-only int8 product at small M, y = x . W_q, for the int8
// dense layers and the tied int8 logits of the decode paths.
//
// Replaces no Pallas kernel: the JAX package leaves this product to XLA,
// which converts the int8 weight inside the matmul's operand fusion
// (models/whisper.py:dense, :tied_logits of the JAX package), so the int8
// bytes are what crosses HBM. Without this kernel the port cast the whole
// weight to bf16 (or the embedding to fp32) on every call and ran a library
// GEMM over the copy. The plain PyTorch version is ops/dense_w8.py:
// dense_w8_plain and logits_w8_plain. Per output (m, n):
//   acc      = sum_k bf16(x[m, k]) * bf16(W_q[k, n])      (fp32, exact products)
//   dense    : y = bf16(bf16(acc * scale[n]) + bias[n])   (bias optional)
//   logits   : y = acc * scale[n]                         (fp32)
// the JAX package's arithmetic: the scale on the fp32 sum, one rounding.
// Two weight layouts, the ones the weights already have: dense w_q [K, N]
// (N contiguous, "KN"), the token embedding [N, K] (K contiguous, "NK").
//
// Bound on the H100: device memory. At M <= 64 rows the product does 2 M
// operations per weight byte, against the bf16 ridge of about 295 per byte;
// one large-v3 decoder layer's six products read 22.9 MB of int8, 6.8 us at
// 3.35 TB/s, the logits 66 MB, 19.8 us.
//
// Design: a block takes 64 output channels x up to 64 rows of x (BM = 8 MT)
// x a range of K, with four warps: two along the channels (32 each), two
// along k (each two of a 64-k stage's four k16 steps). The weight panel and
// the x rows below M stream through a ring of STAGES stages with 16-byte
// cp.async (zero filled past K and N; the x rows at or past M are zeroed
// once), both XOR-swizzled so ldmatrix and the 8-byte x loads are free of
// bank conflicts. The int8 bytes enter the tensor cores
// as the A operand of mma.sync m16n8k16 (rows = output channels, so one
// token is one of the 8 columns and M = 1 wastes no weight bytes): ldmatrix
// loads them as b16 pairs (transposed for KN), and the 2^23 trick turns each
// byte into an exact bf16 in registers (XOR 0x80, byte_perm into 0x4B0000xx,
// subtract 2^23 + 128, keep the upper halves). The k order inside a k16 step
// is permuted (lane t's logical k 2t, 2t+1, 2t+8, 2t+9 are physical 4t..4t+3)
// so one 8-byte load gives a lane both halves of its x fragment; the sum is
// over the same products. Split K: S blocks of one cluster (S <= 8, chosen
// from M, K, N so that the grid puts at least one block on every SM) each
// take a range of the K stages, sum their two k warps' fp32 partials and
// push each S-th of the tile into the shared memory of the block that owns
// it (distributed shared memory); after one cluster barrier block r adds its
// S slots in rank order (deterministic, no atomics, no memset: graph-safe),
// applies the scale and bias (read into shared memory at the start), the
// rounding, and stores. M above 64 takes 64-row tiles, the m tiles of a
// channel range next to each other in the grid so their weight reads meet
// in L2. One launch per call. (Measured on the card: eight warps with one
// k16 step each, or six to eight stages, were no faster; a call at M <= 10
// is bound by latency, PERF.md.)

#include "split_softmax.cuh"

namespace {

using split::cluster_sync;
using split::cp_async_commit;
using split::cp_async_wait;
using split::remote;
using split::smem_u32;

constexpr int BN = 64;       // output channels a block takes
constexpr int BK = 64;       // k a stage
constexpr int STAGES = 4;
constexpr int THREADS = 128; // 2 warps along the channels x 2 along k
constexpr int MAX_CLUSTER = 8;
constexpr int W_STAGE = BN * BK;  // int8 bytes of the weight panel a stage

enum Layout { KN = 0, NK = 1 };

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes LO and HI of u (int8 values XORed with 0x80) as an exact bf16 pair,
// LO in the low half: 0x4B0000xx is 2^23 + xx, and 2^23 + 128 less.
template <int LO, int HI>
__device__ __forceinline__ uint32_t i8_bf16x2(uint32_t u) {
  const float lo = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | LO)) - 8388736.0f;
  const float hi = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | HI)) - 8388736.0f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_nctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// Shared memory: the ring (in the epilogue, the two k warps' partials),
// then the tile's fp32 sums pushed by the cluster's blocks, then the
// tile's scales and bias.
template <int MT>
__host__ __device__ constexpr int ring_bytes() {
  constexpr int ring = STAGES * (W_STAGE + 8 * MT * BK * 2);
  constexpr int partials = 2 * 8 * MT * BN * 4;
  return ring > partials ? ring : partials;
}
template <int MT>
constexpr int smem_bytes() {
  return ring_bytes<MT>() + 8 * MT * BN * 4 + BN * 4 + BN * 2;
}

// x [M, K] bf16; w [K, N] (KN) or [N, K] (NK) int8; scale [N] fp32; bias [N]
// bf16 or null (KN only); out [M, N] bf16 (KN) or fp32 (NK). Grid: x = m
// tiles x S (a cluster of S along x), y = channel tiles.
template <int MT, int LAYOUT>
__global__ void __launch_bounds__(THREADS) dense_w8_kernel(
    const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ w,
    const float* __restrict__ scale, const __nv_bfloat16* __restrict__ bias,
    void* __restrict__ out, int M, int K, int N) {
  constexpr int BM = 8 * MT;
  constexpr int STAGE = W_STAGE + BM * BK * 2;
  extern __shared__ __align__(128) uint8_t smem[];

  const int S = static_cast<int>(cluster_nctarank());
  const int rank = static_cast<int>(cluster_ctarank());
  const int m0 = static_cast<int>(blockIdx.x) / S * BM;
  const int n0 = static_cast<int>(blockIdx.y) * BN;
  const int chunks = (K + BK - 1) / BK;
  const int c_begin = rank * chunks / S;
  const int count = (rank + 1) * chunks / S - c_begin;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nw = warp & 1, kw = warp >> 1;
  const int g = lane >> 2, t = lane & 3;
  const int live = min(MT, (M - m0 + 7) / 8);  // token tiles with a row below M
  if (S > 1) split::cluster_arrive_relaxed();  // waited for before the first remote store

  // This thread's pieces of a stage, the same in every stage but for its k:
  // weight chunks tid + THREADS j, 16 bytes each (chunk q of row r at
  // q ^ f(r)); x chunks of the rows below M (chunk q of row m at
  // q ^ 2 (m & 3)). The x rows of the tile at or past M are zeroed once.
  constexpr int WPT = BN * BK / 16 / THREADS;
  const int8_t* wsrc[WPT];
  int wdst[WPT], wk[WPT];
  bool wn[WPT];
#pragma unroll
  for (int j = 0; j < WPT; ++j) {
    const int i = tid + THREADS * j, r = i >> 2, q = i & 3;
    if (LAYOUT == NK) {  // row r: channel n0 + r, bytes k0 + 16 q ...
      wsrc[j] = w + static_cast<size_t>(n0 + r) * K + 16 * q;
      wk[j] = 16 * q;
      wn[j] = n0 + r < N;
      wdst[j] = r * BK + 16 * (q ^ ((r >> 1) & 3));
    } else {  // row r: k0 + r, channels n0 + 16 q ...
      wsrc[j] = w + static_cast<size_t>(r) * N + n0 + 16 * q;
      wk[j] = r;
      wn[j] = n0 + 16 * q < N;
      wdst[j] = r * BK + 16 * (q ^ ((r >> 2) & 3));
    }
  }
  const size_t wstep = LAYOUT == NK ? BK : static_cast<size_t>(BK) * N;
  const int rows = min(BM, M - m0);
  for (int i = tid; i < STAGES * (BM - rows) * 8; i += THREADS) {
    const int st = i / ((BM - rows) * 8), rem = i % ((BM - rows) * 8);
    *reinterpret_cast<uint4*>(smem + st * STAGE + W_STAGE + (rows + rem / 8) * 128 +
                              16 * (rem % 8)) = make_uint4(0u, 0u, 0u, 0u);
  }

  auto load_stage = [&](int slot, int c) {
    uint8_t* stage = smem + slot * STAGE;
    const int k0 = c * BK;
#pragma unroll
    for (int j = 0; j < WPT; ++j) {
      const bool ok = wn[j] && k0 + wk[j] < K;
      cp_async16_zfill(stage + wdst[j], ok ? wsrc[j] + c * wstep : w, ok);
    }
    for (int i = tid; i < rows * 8; i += THREADS) {
      const int m = i >> 3, q = i & 7;
      const bool ok = k0 + 8 * q < K;
      const __nv_bfloat16* src = x + static_cast<size_t>(m0 + m) * K + k0 + 8 * q;
      cp_async16_zfill(stage + W_STAGE + m * 128 + 16 * (q ^ (2 * (m & 3))), ok ? src : x, ok);
    }
  };

  float acc[2][MT][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][i][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < count) load_stage(st, c_begin + st);
    cp_async_commit();
  }
  // The tile's scales and bias, read while the first stages are in flight.
  float* sscale = reinterpret_cast<float*>(smem + ring_bytes<MT>() + BM * BN * 4);
  __nv_bfloat16* sbias = reinterpret_cast<__nv_bfloat16*>(sscale + BN);
  if (tid < BN) {
    sscale[tid] = n0 + tid < N ? scale[n0 + tid] : 0.0f;
  } else if (bias != nullptr && tid < 2 * BN) {
    const int n = n0 + tid - BN;
    sbias[tid - BN] = n < N ? bias[n] : __float2bfloat16_rn(0.0f);
  }

  // This lane's ldmatrix row: matrix q = lane / 8, row r = lane % 8 of it.
  const int lq = lane >> 3, lr = lane & 7;

  for (int c = 0; c < count; ++c) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (c + STAGES - 1 < count) load_stage((c + STAGES - 1) % STAGES, c_begin + c + STAGES - 1);
    cp_async_commit();
    const uint8_t* sw = smem + (c % STAGES) * STAGE;
    const uint8_t* sx = sw + W_STAGE;

    // Each 16-channel tile j: one ldmatrix.x4 holds both of this warp's k16
    // steps. NK: matrices (rows +0..7, step 0), (rows +8..15, step 0), then
    // step 1; KN (transposed): (logical k 0..7, step 0), (k 8..15, step 0),
    // then step 1, logical k 2 i, 2 i + 1 at physical rows 4 i, 4 i + 1 and
    // k 8 + 2 i, 9 + 2 i at 4 i + 2, 4 i + 3.
    uint32_t ra[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int nb = 32 * nw + 16 * j;
      if (LAYOUT == NK) {
        const int r = nb + lr + 8 * (lq & 1);
        const int q = 2 * kw + (lq >> 1);
        ldsm_x4(ra[j], smem_u32(sw + r * BK + 16 * (q ^ ((r >> 1) & 3))));
      } else {
        const int s = 2 * kw + (lq >> 1);
        const int r = 16 * s + 4 * (lr >> 1) + (lr & 1) + 2 * (lq & 1);
        ldsm_x4_trans(ra[j], smem_u32(sw + r * BK + 16 * ((nb >> 4) ^ ((r >> 2) & 3))));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) ra[j][e] ^= 0x80808080u;
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = 2 * kw + h;
      uint32_t a[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t lo = ra[j][2 * h], hi = ra[j][2 * h + 1];
        if (LAYOUT == NK) {  // lo: channel g, hi: channel g + 8; bytes = k
          a[j][0] = i8_bf16x2<0, 1>(lo);
          a[j][1] = i8_bf16x2<0, 1>(hi);
          a[j][2] = i8_bf16x2<2, 3>(lo);
          a[j][3] = i8_bf16x2<2, 3>(hi);
        } else {  // lo: k 0..7, hi: k 8..15; bytes (k, n 2g), (k, 2g+1), (k+1, 2g), (k+1, 2g+1)
          a[j][0] = i8_bf16x2<0, 2>(lo);
          a[j][1] = i8_bf16x2<1, 3>(lo);
          a[j][2] = i8_bf16x2<0, 2>(hi);
          a[j][3] = i8_bf16x2<1, 3>(hi);
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < live) {
          const int m = 8 * i + g;
          const uint2 b = *reinterpret_cast<const uint2*>(
              sx + m * 128 + 16 * ((2 * s + (t >> 1)) ^ (2 * (m & 3))) + 8 * (t & 1));
          mma_bf16(acc[0][i], a[0], b.x, b.y);
          mma_bf16(acc[1][i], a[1], b.x, b.y);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Partials [kw][m][channel] in fp32 over the ring.
  float* part = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int m = 8 * i + 2 * t;
      float* p = part + (kw * BM + m) * BN;
      if (LAYOUT == NK) {  // rows g, g + 8 of the tile: channels nb + g, nb + g + 8
        const int n = 32 * nw + 16 * j + g;
        p[n] = acc[j][i][0];
        p[BN + n] = acc[j][i][1];
        p[n + 8] = acc[j][i][2];
        p[BN + n + 8] = acc[j][i][3];
      } else {  // rows g, g + 8: channels nb + 2 g, nb + 2 g + 1
        const int n = 32 * nw + 16 * j + 2 * g;
        *reinterpret_cast<float2*>(p + n) = make_float2(acc[j][i][0], acc[j][i][2]);
        *reinterpret_cast<float2*>(p + BN + n) = make_float2(acc[j][i][1], acc[j][i][3]);
      }
    }
  }
  __syncthreads();

  // Groups of four channels of a row: block r owns groups [r per, r per +
  // per). Each block sums its two k warps' partials of every group and
  // pushes the sum into the owner's shared memory (slot: the pushing
  // block's rank); one cluster barrier later each owner adds its S slots in
  // rank order, reading only its own shared memory, so no block waits for
  // another to finish reading. Deterministic: no atomics.
  constexpr int GROUPS = BM * BN / 4;
  const float4* p0 = reinterpret_cast<const float4*>(part);
  const float4* p1 = reinterpret_cast<const float4*>(part + BM * BN);
  auto add = [](float4 a, const float4 b) {
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
    return a;
  };
  auto store = [&](int gi, float4 sum) {
    const int m = gi / (BN / 4), nq = gi % (BN / 4) * 4;
    const int gm = m0 + m, gn = n0 + nq;
    if (gm >= M || gn >= N) return;
    const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
    if (LAYOUT == KN) {  // N % 16 == 0: all four channels in range, 8-byte aligned
      __nv_bfloat16 y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        y[e] = __float2bfloat16_rn(vals[e] * sscale[nq + e]);
        if (bias != nullptr) {
          y[e] = __float2bfloat16_rn(__bfloat162float(y[e]) + __bfloat162float(sbias[nq + e]));
        }
      }
      __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out) + static_cast<size_t>(gm) * N + gn;
      uint2 packed;
      packed.x = static_cast<uint32_t>(__bfloat16_as_ushort(y[0])) |
                 (static_cast<uint32_t>(__bfloat16_as_ushort(y[1])) << 16);
      packed.y = static_cast<uint32_t>(__bfloat16_as_ushort(y[2])) |
                 (static_cast<uint32_t>(__bfloat16_as_ushort(y[3])) << 16);
      *reinterpret_cast<uint2*>(o) = packed;
    } else {
      float* o = static_cast<float*>(out) + static_cast<size_t>(gm) * N + gn;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (gn + e < N) o[e] = vals[e] * sscale[nq + e];
      }
    }
  };
  if (S == 1) {
    for (int gi = tid; gi < GROUPS; gi += THREADS) store(gi, add(p0[gi], p1[gi]));
    return;
  }
  const int per = GROUPS / S;
  float4* recv = reinterpret_cast<float4*>(smem + ring_bytes<MT>());  // [S][per]
  split::cluster_wait();  // every block of the cluster is running
  for (int gi = tid; gi < GROUPS; gi += THREADS) {
    const int owner = gi / per;
    remote(recv, static_cast<uint32_t>(owner))[rank * per + gi - owner * per] = add(p0[gi], p1[gi]);
  }
  cluster_sync();
  for (int li = tid; li < per; li += THREADS) {
    float4 sum = recv[li];
    for (int q = 1; q < S; ++q) sum = add(sum, recv[q * per + li]);
    store(rank * per + li, sum);
  }
}

int sm_count() {
  static const int n = [] {
    int dev = 0, count = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count > 0 ? count : 132;
  }();
  return n;
}

template <int MT, int LAYOUT>
int launch(const void* x, const void* w, const void* scale, const void* bias, void* out, int M,
           int K, int N, void* stream) {
  constexpr int BM = 8 * MT;
  constexpr int SMEM = smem_bytes<MT>();
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      dense_w8_kernel<MT, LAYOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  const int m_tiles = (M + BM - 1) / BM, n_tiles = (N + BN - 1) / BN;
  const int chunks = (K + BK - 1) / BK;
  // The fewest blocks of a cluster that put a block on every SM, each with
  // at least one stage.
  int S = 1;
  while (S < MAX_CLUSTER && 2 * S <= chunks && m_tiles * n_tiles * S < sm_count()) S *= 2;
  const dim3 grid(m_tiles * S, n_tiles, 1);
  if (S == 1) {  // no cluster to form
    dense_w8_kernel<MT, LAYOUT><<<grid, THREADS, SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(w),
        static_cast<const float*>(scale), static_cast<const __nv_bfloat16*>(bias), out, M, K, N);
    return static_cast<int>(cudaGetLastError());
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, dense_w8_kernel<MT, LAYOUT>, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int8_t*>(w), static_cast<const float*>(scale),
      static_cast<const __nv_bfloat16*>(bias), out, M, K, N);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <int LAYOUT>
int dispatch(const void* x, const void* w, const void* scale, const void* bias, void* out, int M,
             int K, int N, void* stream) {
  if (M < 1 || N < 1 || K < 16 || K % 16 || (LAYOUT == KN && N % 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (M <= 8) return launch<1, LAYOUT>(x, w, scale, bias, out, M, K, N, stream);
  if (M <= 16) return launch<2, LAYOUT>(x, w, scale, bias, out, M, K, N, stream);
  if (M <= 32) return launch<4, LAYOUT>(x, w, scale, bias, out, M, K, N, stream);
  return launch<8, LAYOUT>(x, w, scale, bias, out, M, K, N, stream);
}

}  // namespace

// x [M, K] bf16, w_q [K, N] int8, scale [N] fp32, bias [N] bf16 or null ->
// out [M, N] bf16.
extern "C" int sstw_dense_w8(const void* x, const void* w_q, const void* scale, const void* bias,
                             void* out, int M, int K, int N, void* stream) {
  return dispatch<KN>(x, w_q, scale, bias, out, M, K, N, stream);
}

// x [M, K] bf16, emb_q [N, K] int8, scale [N] fp32 -> out [M, N] fp32.
extern "C" int sstw_logits_w8(const void* x, const void* emb_q, const void* scale, void* out,
                              int M, int K, int N, void* stream) {
  return dispatch<NK>(x, emb_q, scale, nullptr, out, M, K, N, stream);
}

// K2: non-causal flash attention for the Whisper encoder, bf16 in and out.
//
// Replaces the Pallas TPU kernel ops/flash_attention.py:_attn_kernel, launched
// by flash_attention (pallas_call at ops/flash_attention.py:85). The plain
// PyTorch version is ops/flash_attention.py:attention_reference in this
// package. jaxlib's TPU flash kernel (flash_attention_jaxlib, pallas_call at
// ops/flash_attention.py:163) computes the same function, so this is its port
// too.
//
// What it computes, per (batch*head, query row): softmax(q . k^T) . v over the
// Lk key positions, with q and k each pre-scaled by d^-0.25 by the caller, an
// fp32 softmax and fp32 accumulation. There are Lq query rows per head: Lq = Lk
// for the encoder on one device, Lq = Lk / sp for a rank of a sequence-parallel
// mesh, whose rows attend to the keys of every rank. Key columns >= Lk are masked
// (1500 is not a multiple of the 64-column tile). The [Lq, Lk] score matrix never
// reaches device memory.
//
// Bound on the H100: at the encoder's shape ([4, 20, 1500, 64]) the two
// products are 4 * 80 * 1500^2 * 64 = 46 GFLOP against 61 MB of q, k, v and
// output, far above the bf16 ridge point: tensor-core issue bounds it
// (0.047 ms at 989 TFLOP/s), with the softmax's exp and max work and the
// shared-memory reads of the K/V fragments between the products.
//
// Design: one block of two warpgroups (eight warps) per (batch*head, 128-row
// query tile), so each staged K/V tile serves 128 rows (12 x 80 = 960 blocks at
// the encoder's shape). The K/V tiles of 64 keys go through a ring of four
// stages in shared memory, filled by cp.async 16-byte copies (rows past Lk zero-
// filled) two tiles ahead, so the next tiles load while the current one is
// multiplied; one __syncthreads per tile. Q, K and V stay row-major in shared
// memory in the 128-byte swizzle of the tensor cores' shared-memory descriptors
// (the 16-byte chunks of each 128-byte row XOR-ed with the row's low three
// bits, tiles 1024-byte aligned), so no tile is transposed. Each warpgroup owns
// 64 query rows and runs both products as wgmma.m64n64k16 bf16 -> fp32: S = Q
// K^T with both operands read from shared memory (K-major), then O += P V with
// the score fragment, rounded to bf16, as the register A operand and V read in
// place (MN-major, transposed by the instruction). P V is left running into the
// next tile's barrier and S product, whose wait ends both. The online softmax
// runs on the S fragment in registers in the log2 domain: one FFMA folds
// log2(e) and the running max into the argument of ex2.approx; normalisation is
// deferred to the end, and the accumulator is rescaled only when a row max
// moved. The two warpgroups of a block and the two blocks of an SM take turns
// on the tensor cores while the others do their softmax. The output goes
// through each warp's own Q rows in shared memory, so it leaves in 16-byte
// stores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;                // head dim: 8 chunks of 16 bytes per row
constexpr int BQ = 128;              // query rows per block, 64 per warpgroup
constexpr int BK = 64;               // keys per tile
constexpr int THREADS = 256;         // two warpgroups
constexpr int STAGES = 4;            // K/V ring depth
constexpr int AHEAD = 2;             // tiles in flight ahead of the one multiplied
constexpr int Q_BYTES = BQ * D * 2;
constexpr int TILE_BYTES = BK * D * 2;  // one K or V tile
// Q (16 KB) and the ring (64 KB), plus room to align them to 1024 bytes.
constexpr int SMEM_BYTES = 1024 + Q_BYTES + STAGES * 2 * TILE_BYTES;
constexpr float LOG2E = 1.4426950408889634f;

// Byte offset of 16-byte chunk c of row r in a [rows][64] bf16 tile whose
// chunks are XOR-swizzled by the row's low three bits.
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>(r * (D * 2) + ((c ^ (r & 7)) << 4));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; src_bytes = 0 writes zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's shared-memory writes visible to the tensor cores' reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Shared-memory matrix descriptor of a tile in the 128-byte swizzle: start
// address, 1024 bytes from one 8-row group to the next; the leading offset is
// unused (64 bf16 of the contiguous dimension are one swizzle atom).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep a register live and in place across the asynchronous wgmma that reads
// or writes it: no move of its uses above the wait, no reuse before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// The 32 fp32 registers a thread holds of a 64 x 64 accumulator.
#define SSTW_D32                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),    \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),         \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),      \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),      \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])
#define SSTW_D32_LIST                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B K-major in shared memory;
// accumulate = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSTW_D32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : SSTW_D32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A in registers (per warp, the
// mma.sync m16n8k16 A layout of its 16 rows), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSTW_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SSTW_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [row0, row0 + ROWS) of an [L, 64] head into a swizzled tile,
// rows past L as zeros. Each thread copies ROWS * 8 / THREADS chunks.
template <int ROWS>
__device__ __forceinline__ void load_rows(uint32_t dst, const __nv_bfloat16* src, int row0, int L) {
#pragma unroll
  for (int i = 0; i < ROWS * 8 / THREADS; ++i) {
    const int idx = threadIdx.x + i * THREADS;
    const int r = idx >> 3, c = idx & 7;
    const bool in = row0 + r < L;
    cp_async16(dst + swz(r, c), src + static_cast<size_t>(in ? row0 + r : 0) * D + c * 8,
               in ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS, 2)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,  // [BH, Lq, D]
                       const __nv_bfloat16* __restrict__ k,  // [BH, Lk, D]
                       const __nv_bfloat16* __restrict__ v,  // [BH, Lk, D]
                       __nv_bfloat16* __restrict__ o, int Lq, int Lk) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t qs = (smem_u32(smem) + 1023u) & ~1023u;  // [BQ][D], swizzled
  const uint32_t ring = qs + Q_BYTES;                     // [STAGES][K, V][BK][D], swizzled

  const size_t qhead = static_cast<size_t>(blockIdx.y) * Lq * D;
  const size_t khead = static_cast<size_t>(blockIdx.y) * Lk * D;
  const __nv_bfloat16* kh = k + khead;
  const __nv_bfloat16* vh = v + khead;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane & 3;  // fragment column pair
  const uint32_t qw = qs + (warp / 4) * 64 * (D * 2);  // the warpgroup's 64 Q rows
  const int q0 = blockIdx.x * BQ;
  const int n_tiles = (Lk + BK - 1) / BK;

  // Q joins the first tile's commit group.
  load_rows<BQ>(qs, q + qhead, q0, Lq);
#pragma unroll
  for (int st = 0; st < AHEAD; ++st) {
    if (st < n_tiles) {
      load_rows<BK>(ring + (2 * st) * TILE_BYTES, kh, st * BK, Lk);
      load_rows<BK>(ring + (2 * st + 1) * TILE_BYTES, vh, st * BK, Lk);
    }
    cp_async_commit();
  }

  // Fragments of a warp's 16 rows (g, g+8): register 4*nt + {0,1,2,3} holds
  // columns nt*8 + 2t, +1 of row g, then of row g+8.
  float s[32], acc[32];
  uint32_t pa[4][4];  // P in bf16 pairs, the A operand of P V, per 16-key chunk
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i / 4][i % 4] = 0u;
  float m0 = -INFINITY, m1 = -INFINITY;  // running row max (natural units)
  float l0 = 0.f, l1 = 0.f;              // this thread's share of the row sums

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<AHEAD - 1>();  // tile j (and Q) landed for this thread's copies
    fence_proxy_async();
    __syncthreads();  // ... and everyone's; tile j-2's slot is free (its P V ended
                      // with tile j-1's S product)
    {
      const int nx = j + AHEAD;
      if (nx < n_tiles) {
        const int slot = nx % STAGES;
        load_rows<BK>(ring + (2 * slot) * TILE_BYTES, kh, nx * BK, Lk);
        load_rows<BK>(ring + (2 * slot + 1) * TILE_BYTES, vh, nx * BK, Lk);
      }
      cp_async_commit();  // an empty group keeps the wait count uniform
    }
    const uint32_t ks = ring + (2 * (j % STAGES)) * TILE_BYTES;
    const uint32_t vs = ks + TILE_BYTES;

    // S = Q K^T, 64 rows x 64 keys per warpgroup, four 16-wide steps of d.
    // Its wait also ends the previous tile's P V, issued without a wait.
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      wgmma_ss(s, sw128_desc(qw + kc * 32), sw128_desc(ks + kc * 32), kc);
    }
    wgmma_commit_wait();
    fence_regs(s);
    fence_regs(acc);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) fence_regs(pa[kc]);

    // Mask the ragged edge, then the online-softmax update.
    const int kv0 = j * BK;
    if (kv0 + BK > Lk) {  // the ragged last tile only
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int col = kv0 + nt * 8 + t * 2;
        if (col >= Lk) s[4 * nt] = s[4 * nt + 2] = -INFINITY;
        if (col + 1 >= Lk) s[4 * nt + 1] = s[4 * nt + 3] = -INFINITY;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * nt], s[4 * nt + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * nt + 2], s[4 * nt + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    // Every tile holds at least one key < Lk, so mx0/mx1 are finite here.
    const float a0 = ex2((m0 - mx0) * LOG2E), a1 = ex2((m1 - mx1) * LOG2E);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
    if (__any_sync(0xffffffffu, a0 != 1.f || a1 != 1.f)) {  // a row max moved
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        acc[4 * nt] *= a0;
        acc[4 * nt + 1] *= a0;
        acc[4 * nt + 2] *= a1;
        acc[4 * nt + 3] *= a1;
      }
    }
    const float mb0 = -m0 * LOG2E, mb1 = -m1 * LOG2E;

    // P = 2^(S log2(e) - m log2(e)) in bf16, the A operand of P V: 16-key
    // chunk kc is score tiles 2kc and 2kc+1. fp32 row sums.
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      float p[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float* sn = s + 4 * (2 * kc + h);
        p[h][0] = ex2(fmaf(sn[0], LOG2E, mb0));
        p[h][1] = ex2(fmaf(sn[1], LOG2E, mb0));
        p[h][2] = ex2(fmaf(sn[2], LOG2E, mb1));
        p[h][3] = ex2(fmaf(sn[3], LOG2E, mb1));
        l0 += p[h][0] + p[h][1];
        l1 += p[h][2] + p[h][3];
      }
      pa[kc][0] = pack_bf16(p[0][0], p[0][1]);
      pa[kc][1] = pack_bf16(p[0][2], p[0][3]);
      pa[kc][2] = pack_bf16(p[1][0], p[1][1]);
      pa[kc][3] = pack_bf16(p[1][2], p[1][3]);
    }
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) wgmma_rs(acc, pa[kc], sw128_desc(vs + kc * 16 * (D * 2)));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }
  wgmma_commit_wait();  // the last P V
  fence_regs(acc);
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) fence_regs(pa[kc]);
  cp_async_wait<0>();  // no copy in flight past the end (the trailing groups are empty)

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;

  // The warp's 16 output rows overwrite its own 16 Q rows (every read of Q
  // ended with the last S product), then leave in 16-byte stores.
  const int g = lane >> 2, r0 = warp * 16 + g;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const uint32_t c = t * 4;  // byte offset of the column pair inside the chunk
    const uint32_t w0 = pack_bf16(acc[4 * nt] * inv0, acc[4 * nt + 1] * inv0);
    const uint32_t w1 = pack_bf16(acc[4 * nt + 2] * inv1, acc[4 * nt + 3] * inv1);
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(qs + swz(r0, nt) + c), "r"(w0) : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(qs + swz(r0 + 8, nt) + c), "r"(w1) : "memory");
  }
  __syncwarp();
  __nv_bfloat16* oh = o + qhead;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = lane + i * 32;  // 16 rows x 8 chunks
    const int r = warp * 16 + (idx >> 3), c = idx & 7;
    if (q0 + r < Lq) {
      uint4 val;
      asm volatile("ld.shared.v4.b32 {%0,%1,%2,%3}, [%4];\n"
                   : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                   : "r"(qs + swz(r, c))
                   : "memory");
      *reinterpret_cast<uint4*>(oh + static_cast<size_t>(q0 + r) * D + c * 8) = val;
    }
  }
}

}  // namespace

extern "C" int sstw_flash_attention(const void* q, const void* k, const void* v, void* o,
                                    int bh, int Lq, int Lk, void* stream) {
  // Above 48 KB a block's dynamic shared memory needs this opt-in, once.
  static const cudaError_t opt_in = cudaFuncSetAttribute(
      flash_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  if (bh < 1 || Lq < 1 || Lk < 1) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((Lq + BQ - 1) / BQ, bh);
  flash_attention_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Lq, Lk);
  return static_cast<int>(cudaGetLastError());
}

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
// IEEE division and rint rounds half to even (no --use_fast_math), so the
// codes equal the plain version's bit for bit.
//
// Bound on the H100 at the probe's shape ([16, 20, 1500, 64]): QK^T is 9.2e10
// int8 operations (0.047 ms at 1,979 TOP/s), PV 9.2e10 bf16 FLOP in qk8 (0.093
// ms at 989 TFLOP/s) or int8 operations in full8 (0.047 ms), against 246 MB of
// q, k, v and output (0.073 ms at 3.35 TB/s). But every score also takes one
// exponential: 7.2e8 of them at the 16 a clock per SM of the special-function
// units (about 3.9e12 a second) take 0.185 ms, above every other term. So the
// exponentials bound both modes, and K2 (csrc/flash_attention.cu) too at
// d = 64: the int8 tensor cores cannot lift P1's floor below K2's.
//
// Design, after K2 (what each choice bought: PERF.md, section 6):
//  * Pre-pass (flash_q8_quant_kernel): kmax and vmax depend on all of K and
//    V, which no query tile sees alone. A cluster of eight blocks per
//    (batch*head) splits its key tiles; each block reduces its share, the
//    blocks exchange the maxima through distributed shared memory, and each
//    quantizes its own tiles (its first from registers, the others read
//    again, from L2): k8 [lp, 64] row-major and, for full8, v8 as 64-key tiles
//    [channel][key] in the order of the PV product's A fragment (see
//    v8_slot), all zero past L.
//  * Attention (flash_q8_kernel): one block of two warpgroups per
//    (batch*head, 128 query rows), two blocks an SM. Each thread quantizes
//    half a q row; each warp keeps its 16 rows' q8 in registers as the A
//    operand of QK^T. A ring of four stages, filled by cp.async 16-byte copies
//    two steps ahead, feeds the steps, one __syncthreads each: in pass 1 a
//    step is four k8 tiles, in pass 2 two tiles of k8 and V (or v8). int8
//    tiles sit in the 64-byte swizzle of the wgmma descriptors (an int8 row
//    is 64 bytes, not K2's 128), the bf16 V tile in K2's 128-byte swizzle.
//  * full8 quantizes e against the row's true max, which an online softmax's
//    running max would change, so the block makes two passes over the key
//    tiles, both with QK^T on wgmma m64nNk32 s8 -> s32 (exact, so the same
//    scores bit for bit). Pass 1 takes the row maxima on the int32
//    accumulators by integer max (exact, see pass 1), two tiles in flight;
//    pass 2 forms e, its sum and the PV product by half tiles of 32 keys,
//    each half's S issued one half ahead of its softmax. qk8 takes the same
//    two passes in the same code.
//  * PV: qk8 runs bf16(e) from the score fragments (a 16-key chunk is two
//    accumulator tiles) as the register A operand of wgmma.m64n64k16 bf16 ->
//    fp32 against the V tile read in place (MN-major), as K2. full8 runs p8 as
//    the register A operand of wgmma.m64n64k32 s8 -> s32 (127 * 127 * L stays
//    far below 2^31 for the encoder's 1500). Its A layout takes four
//    consecutive k-indices a register where the accumulator gives each thread
//    key pairs (2t, 2t + 1) of each 8-key tile; a sum over keys does not care
//    which k-index holds which key, so the pre-pass writes the v8 tile's keys
//    in the order the registers hold them (no shuffle, no shared memory).
//  * ptxas keeps wgmma asynchronous only while every wait_group retires
//    products issued in the same loop iteration (or before it) and no other
//    instruction touches an accumulator in flight; else it serializes every
//    wgmma of the kernel (warnings C7514 / C7515). So each step issues the
//    same products on every path (tiles past the last are zero-filled and
//    masked), and the accumulators start from zeros of their own.
//  * Scores use __fmul_rn / __fsub_rn, so no FMA contraction rounds them
//    differently from the plain version. Every code's rint is a float add
//    (half to even, as rintf), off the conversion unit the exponentials
//    need. The exponential is __expf's arithmetic with denormal results
//    flushed (see exp_approx). What bounds the kernel on the card is issue:
//    pass 2 takes about 6.5 instructions a score in qk8 and 8 in full8
//    (I2FP, the fixed fmul and fsub, exp's fmul and MUFU, the fp32 sum, the
//    packing), besides the steps' copies, barriers and waits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "split_softmax.cuh"  // the cluster barrier and distributed shared memory

namespace {

constexpr int D = 64;             // head dim: an int8 row is 64 bytes, a bf16 row 128
constexpr int BQ = 128;           // query rows per block, 64 per warpgroup
constexpr int BK = 64;            // keys per tile
constexpr int THREADS = 256;      // two warpgroups
constexpr int STAGES = 4;         // ring depth
constexpr int AHEAD = 2;          // tiles in flight ahead of the one multiplied
constexpr int I8_TILE = BK * D;   // one int8 tile (k8 or v8): 4 KB
constexpr int BF_TILE = BK * D * 2;  // one bf16 V tile: 8 KB
constexpr int Q8_BYTES = BQ * D;
constexpr int PREP_CLUSTER = 8;   // pre-pass blocks per (batch*head)
constexpr int PREP_THREADS = 256;
constexpr int PREP_CACHED = 1;    // key tiles a pre-pass block keeps in registers (512 keys a head)
constexpr float Q127 = 127.f * 127.f;
constexpr float MAGIC = 12582912.f;   // 1.5 * 2^23: x + MAGIC holds rint(x) in its low bits

template <bool FULL8>
struct Ring {  // a stage: two key tiles, each k8 then V (bf16) or v8; in pass 1 four k8 tiles
  static constexpr int TILE = I8_TILE + (FULL8 ? I8_TILE : BF_TILE);
  static constexpr int STAGE = 2 * TILE;
  // q8 (8 KB) and the ring, plus room to align them to 1024 bytes.
  static constexpr int SMEM = 1024 + Q8_BYTES + STAGES * STAGE;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk c (0..3) of row r in an int8 [rows][64] tile in
// the 64-byte swizzle of the tensor cores' descriptors: address bits 4-5
// XOR-ed with bits 7-8, i.e. the chunk with (r / 2) % 4 (tiles 512-byte
// aligned).
__device__ __forceinline__ uint32_t swz64(int r, int c) {
  return static_cast<uint32_t>(r * D + ((c ^ ((r >> 1) & 3)) << 4));
}
// The same for chunk c (0..7) of a bf16 [rows][64] tile in the 128-byte
// swizzle (address bits 4-6 XOR-ed with bits 7-9), as K2.
__device__ __forceinline__ uint32_t swz128(int r, int c) {
  return static_cast<uint32_t>(r * (D * 2) + ((c ^ (r & 7)) << 4));
}

// Shared-memory matrix descriptors, K-major (or MN-major for K2's V): start
// address, 512 (64-byte swizzle) or 1024 (128-byte) bytes from one 8-row
// group to the next; the leading offset is unused (a k-step lies inside one
// swizzle atom).
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
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

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {  // all but the newest N groups done
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep a register live and in place across the asynchronous wgmma that reads
// or writes it: no move of its uses above the wait, no reuse before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Zeros for registers a wgmma will write, each from an instruction of its own,
// so that the compiler shares no register between them and any other zero
// (a loop counter, say): ptxas serializes every wgmma of a kernel once it
// sees another instruction touch an accumulator in flight.
template <int N>
__device__ __forceinline__ void zero_regs(int (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("mov.b32 %0, 0;" : "=r"(r[i]));
}
template <int N>
__device__ __forceinline__ void zero_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("mov.b32 %0, 0;" : "=f"(r[i]));
}

// The 32 registers a thread holds of a 64 x 64 accumulator: register 4 nt +
// {0, 1, 2, 3} of warp w, lane 4g + t holds columns 8 nt + 2t, + 1 of row
// 16 w + g, then of row 16 w + g + 8.
#define SSTW_Q8_D32(c)                                                                        \
  c(d[0]), c(d[1]), c(d[2]), c(d[3]), c(d[4]), c(d[5]), c(d[6]), c(d[7]), c(d[8]), c(d[9]),   \
      c(d[10]), c(d[11]), c(d[12]), c(d[13]), c(d[14]), c(d[15]), c(d[16]), c(d[17]),         \
      c(d[18]), c(d[19]), c(d[20]), c(d[21]), c(d[22]), c(d[23]), c(d[24]), c(d[25]),         \
      c(d[26]), c(d[27]), c(d[28]), c(d[29]), c(d[30]), c(d[31])
#define SSTW_Q8_F(x) "+f"(x)
#define SSTW_Q8_R(x) "+r"(x)
#define SSTW_Q8_LIST                                                     \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d[64 x 32] (+)= A[64 x 32] B[32 x 32], s8 -> s32, A in registers (as
// wgmma_s8_rs below), B K-major in shared memory: half a key tile.
__device__ __forceinline__ void wgmma_s8_rs_n32(int (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                                int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 32] B[32 x 64], s8 -> s32, A in registers (per warp,
// the mma.sync m16n8k32 A layout of its 16 rows: a[0] row g, k 4t..4t+3, a[1]
// row g + 8, a[2] row g, k 16 + 4t.., a[3] row g + 8; the lowest byte holds
// the lowest k), B K-major in shared memory.
__device__ __forceinline__ void wgmma_s8_rs(int (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                            int accumulate = 1) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 " SSTW_Q8_LIST
      ", {%32, %33, %34, %35}, %36, p;\n}\n"
      : SSTW_Q8_D32(SSTW_Q8_R)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], bf16 -> fp32, A in registers (the
// m16n8k16 A layout), B MN-major in shared memory (K2's wgmma_rs).
__device__ __forceinline__ void wgmma_bf16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SSTW_Q8_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : SSTW_Q8_D32(SSTW_Q8_F)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&h);
}

// The int8 code rint(x * scale) (|x * scale| <= 127) in the low byte: adding
// 1.5 * 2^23 rounds half to even, as rintf, into the low mantissa bits, a
// negative code as its two's complement.
__device__ __forceinline__ uint32_t code(float x, float scale) {
  return __float_as_uint(__fadd_rn(__fmul_rn(x, scale), MAGIC));
}
// Four codes' low bytes packed, the first lowest.
__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}

// fp32 of an int32 score, exact for |x| < 2^24 (one I2FP on sm_90).
__device__ __forceinline__ float i2f(int x) { return __int2float_rn(x); }

// The position in a v8 tile of key w (0..63): within each group of 16 keys,
// k-index 4t + b holds key 8 (b / 2) + 2t + b % 2, the order in which lane t
// holds the p8 of a 32-key chunk (two accumulator tiles, then the next two).
__device__ __forceinline__ int v8_slot(int w) {
  const int x = w & 15;
  return (w & ~15) | (((x & 7) >> 1) << 2) | ((x >> 3) << 1) | (x & 1);
}

// Pre-pass: a cluster of PREP_CLUSTER blocks per (batch*head); block r takes
// the key tiles r, r + PREP_CLUSTER, ... . kmax and k8 [lp, 64]; with full8
// also vmax [64] and the v8 tiles [lp / 64][64 channels][64 keys in v8_slot
// order]. Keys L..lp-1 are zeros. Thread t takes channels 8 (t % 8)..+7 of
// rows t / 8 and t / 8 + 32 of each tile (a row in 16-byte loads by eight
// neighbours): it keeps its first PREP_CACHED tiles in registers for the
// quantization (more registers would cost more than a second read of the
// rest from L2, measured).
__global__ void __cluster_dims__(PREP_CLUSTER, 1, 1) __launch_bounds__(PREP_THREADS)
flash_q8_quant_kernel(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                      int8_t* __restrict__ k8, float* __restrict__ kmax_out,
                      int8_t* __restrict__ v8t, float* __restrict__ vmax_out, int L, int full8) {
  __shared__ float vred[PREP_THREADS / 8][D];
  __shared__ float kred[PREP_THREADS / 32];
  __shared__ float part[D + 1];     // this block's max|v| per channel, then max|k|
  __shared__ float scale_s[D + 1];  // 127 / vmax per channel, then 127 / kmax
  __shared__ __align__(16) int8_t tile[D][D + 4];  // 17 words a row: 2-way conflicts at most
  const int rank = blockIdx.x, bh = blockIdx.y, tid = threadIdx.x, lane = tid % 32;
  const int c = tid & 7, r0 = tid >> 3;  // this thread's chunk of 8 channels, first row
  const int n_tiles = (L + BK - 1) / BK, lp = n_tiles * BK;
  const __nv_bfloat16* kh = k + static_cast<size_t>(bh) * L * D;
  const __nv_bfloat16* vh = v + static_cast<size_t>(bh) * L * D;

  // Row h (0, 1) of this thread in its u-th tile, or zeros past L.
  auto row_of = [&](const __nv_bfloat16* x, int u, int h) {
    const int r = (rank + u * PREP_CLUSTER) * BK + r0 + 32 * h;
    return r < L ? *reinterpret_cast<const uint4*>(x + static_cast<size_t>(r) * D + c * 8)
                 : make_uint4(0u, 0u, 0u, 0u);
  };
  auto absmax = [](float m, const uint4& x) {
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
    for (int j = 0; j < 8; ++j) m = fmaxf(m, fabsf(__bfloat162float(b[j])));
    return m;
  };
  auto absmax8 = [](float (&m)[8], const uint4& x) {
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&x);
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j] = fmaxf(m[j], fabsf(__bfloat162float(b[j])));
  };
  const int n_mine = rank < n_tiles ? (n_tiles - rank + PREP_CLUSTER - 1) / PREP_CLUSTER : 0;
  uint4 kc[PREP_CACHED][2], vc[PREP_CACHED][2];
#pragma unroll
  for (int u = 0; u < PREP_CACHED; ++u) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      kc[u][h] = u < n_mine ? row_of(kh, u, h) : make_uint4(0u, 0u, 0u, 0u);
      vc[u][h] = full8 && u < n_mine ? row_of(vh, u, h) : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  float km = 0.f, vm[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int u = 0; u < PREP_CACHED; ++u) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      km = absmax(km, kc[u][h]);
      absmax8(vm, vc[u][h]);
    }
  }
  for (int u = PREP_CACHED; u < n_mine; ++u) {  // heads longer than the cache
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      km = absmax(km, row_of(kh, u, h));
      if (full8) absmax8(vm, row_of(vh, u, h));
    }
  }
  km = split::warp_max(km);
  if (lane == 0) kred[tid / 32] = km;
#pragma unroll
  for (int j = 0; j < 8; ++j) vred[r0][c * 8 + j] = vm[j];
  __syncthreads();
  if (tid < D) {
    float m = 0.f;
    for (int i = 0; i < PREP_THREADS / 8; ++i) m = fmaxf(m, vred[i][tid]);
    part[tid] = m;
  } else if (tid == D) {
    float m = 0.f;
    for (int i = 0; i < PREP_THREADS / 32; ++i) m = fmaxf(m, kred[i]);
    part[D] = m;
  }
  split::cluster_sync();  // every block's maxima are in its part[]
  if (tid <= D) {
    float m = 0.f;
#pragma unroll
    for (int b = 0; b < PREP_CLUSTER; ++b) m = fmaxf(m, *split::remote(&part[tid], b));
    m = fmaxf(m, 1e-6f);
    scale_s[tid] = 127.f / m;
    if (rank == 0) {
      if (tid == D) kmax_out[bh] = m;
      else if (full8) vmax_out[static_cast<size_t>(bh) * D + tid] = m;
    }
  }
  // Done with the other blocks' shared memory; none leaves before all are.
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  __syncthreads();

  const float ks = scale_s[D];
  float vs[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) vs[j] = scale_s[c * 8 + j];
  int8_t* k8h = k8 + static_cast<size_t>(bh) * lp * D;
  int8_t* v8h = v8t + static_cast<size_t>(bh) * lp * D;
  auto codes8 = [](const uint4& x, const float* sc, int r_ok) {  // 8 codes, zeros past L
    const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&x);
    uint32_t w[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      w[i] = pack4(code(__bfloat162float(b[4 * i]), sc[4 * i]),
                   code(__bfloat162float(b[4 * i + 1]), sc[4 * i + 1]),
                   code(__bfloat162float(b[4 * i + 2]), sc[4 * i + 2]),
                   code(__bfloat162float(b[4 * i + 3]), sc[4 * i + 3]));
    }
    return r_ok ? make_uint2(w[0], w[1]) : make_uint2(0u, 0u);
  };
  const float ks8[8] = {ks, ks, ks, ks, ks, ks, ks, ks};
  auto quantize = [&](int u, const uint4 (&kx)[2], const uint4 (&vx)[2]) {
    const int tt = rank + u * PREP_CLUSTER;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r0 + 32 * h, r = tt * BK + rr;
      *reinterpret_cast<uint2*>(k8h + static_cast<size_t>(r) * D + c * 8) =
          codes8(kx[h], ks8, r < L);
      if (full8) {
        const uint2 w = codes8(vx[h], vs, r < L);
        const int slot = v8_slot(rr);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          tile[c * 8 + j][slot] = static_cast<int8_t>(((j < 4 ? w.x : w.y) >> (8 * (j & 3))));
        }
      }
    }
    if (!full8) return;
    // The v8 tile out as 4 KB.
    __syncthreads();
    const int ch = tid >> 2, part16 = tid & 3;
    *reinterpret_cast<uint4*>(v8h + static_cast<size_t>(tt) * I8_TILE + ch * D + part16 * 16) =
        make_uint4(*reinterpret_cast<const uint32_t*>(&tile[ch][part16 * 16]),
                   *reinterpret_cast<const uint32_t*>(&tile[ch][part16 * 16 + 4]),
                   *reinterpret_cast<const uint32_t*>(&tile[ch][part16 * 16 + 8]),
                   *reinterpret_cast<const uint32_t*>(&tile[ch][part16 * 16 + 12]));
    __syncthreads();
  };
#pragma unroll
  for (int u = 0; u < PREP_CACHED; ++u) {
    if (u < n_mine) quantize(u, kc[u], vc[u]);
  }
  for (int u = PREP_CACHED; u < n_mine; ++u) {
    const uint4 kx[2] = {row_of(kh, u, 0), row_of(kh, u, 1)};
    const uint4 vx[2] = {full8 ? row_of(vh, u, 0) : make_uint4(0u, 0u, 0u, 0u),
                         full8 ? row_of(vh, u, 1) : make_uint4(0u, 0u, 0u, 0u)};
    quantize(u, kx, vx);
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// exp(x) as __expf computes it, 2^(x * log2(e)) on the special-function
// unit, with results below 2^-126 flushed to zero (ex2.approx.ftz; __expf
// without -ftz adds a range test and two multiplies a score to keep them).
// __expf's documented error, 2 + floor(1.173 |x|) ulp, is at most 8 ulp where
// a p8 code can be 1 or more (e * 127 >= 0.5, so x >= -5.54); see
// ops/flash_q8.full8_tolerance for what that does to p8. A flushed e is
// below 1.2e-38: its p8 is 0 either way and it moves s by less than that.
__device__ __forceinline__ float exp_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
}

// e for the four scores of accumulator tile nt (row g: x = 0, 1; row g + 8:
// x = 2, 3) of a tile; keys at or past L give 0 when MASK. The scores and
// their difference to the row max are rounded as the plain version's; the
// exponential is exp_approx (two instructions where expf takes about ten,
// which made the kernel issue-bound).
template <bool MASK>
__device__ __forceinline__ void exps(float (&e)[4], const int* s, const float (&mult)[2],
                                     const float (&m)[2], int col, int L) {
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const int h = x >> 1;
    e[x] = exp_approx(__fsub_rn(__fmul_rn(i2f(s[x]), mult[h]), m[h]));
    if (MASK && col + (x & 1) >= L) e[x] = 0.f;
  }
}

// Pass 2's work on one half tile (32 keys from key col0) from its score
// fragment s: e, the row sums l and the A operand of its P V (qk8: pa[kc] the
// bf16 pairs of 16-key chunk kc; full8: pa[0] the p8 bytes of the 32 keys, in
// v8_slot order).
template <bool FULL8, bool MASK>
__device__ __forceinline__ void half_softmax(uint32_t (&pa)[FULL8 ? 1 : 2][4], const int (&s)[16],
                                             const float (&mult)[2], const float (&m)[2],
                                             float (&l)[2], int col0, int t, int L) {
  if constexpr (FULL8) {
    // Accumulator tiles q = 2 r2, 2 r2 + 1 go to registers 2 r2 (row g) and
    // 2 r2 + 1 (row g + 8): bytes 0, 1 from tile 2 r2, bytes 2, 3 from 2 r2 + 1.
#pragma unroll
    for (int r2 = 0; r2 < 2; ++r2) {
      uint32_t lo[2], hi[2];  // per row: the byte pairs of the two tiles
#pragma unroll
      for (int qq = 0; qq < 2; ++qq) {
        const int q = 2 * r2 + qq;
        float e[4];
        exps<MASK>(e, s + 4 * q, mult, m, col0 + q * 8 + 2 * t, L);
        l[0] += e[0] + e[1];
        l[1] += e[2] + e[3];
        (qq ? hi : lo)[0] = __byte_perm(code(e[0], 127.f), code(e[1], 127.f), 0x0040);
        (qq ? hi : lo)[1] = __byte_perm(code(e[2], 127.f), code(e[3], 127.f), 0x0040);
      }
      pa[0][2 * r2] = __byte_perm(lo[0], hi[0], 0x5410);
      pa[0][2 * r2 + 1] = __byte_perm(lo[1], hi[1], 0x5410);
    }
  } else {
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      float p[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int nt = 2 * kc + h;
        exps<MASK>(p[h], s + 4 * nt, mult, m, col0 + nt * 8 + 2 * t, L);
        l[0] += p[h][0] + p[h][1];
        l[1] += p[h][2] + p[h][3];
      }
      pa[kc][0] = pack_bf16(p[0][0], p[0][1]);
      pa[kc][1] = pack_bf16(p[0][2], p[0][3]);
      pa[kc][2] = pack_bf16(p[1][0], p[1][1]);
      pa[kc][3] = pack_bf16(p[1][2], p[1][3]);
    }
  }
}

template <bool FULL8>
__global__ void __launch_bounds__(THREADS, 2)
flash_q8_kernel(const __nv_bfloat16* __restrict__ q,    // [bh, L, 64]
                const __nv_bfloat16* __restrict__ v,    // [bh, L, 64] (qk8)
                const int8_t* __restrict__ k8,          // [bh, lp, 64]
                const float* __restrict__ kmax,         // [bh]
                const int8_t* __restrict__ v8t,         // [bh, lp / 64, 64, 64] (full8)
                const float* __restrict__ vmax,         // [bh, 64] (full8)
                __nv_bfloat16* __restrict__ out,        // [bh, L, 64]
                int8_t* __restrict__ q8_out,            // [bh, L, 64] or null
                int L) {
  using R = Ring<FULL8>;
  using Acc = typename std::conditional<FULL8, int, float>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float qmax_s[BQ];
  const uint32_t q8s = (smem_u32(smem) + 1023u) & ~1023u;  // [BQ][64] int8, 64-byte swizzle
  const uint32_t ring = q8s + Q8_BYTES;                     // [STAGES][k8 | V or v8]

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int wg = warp / 4;
  const int n_tiles = (L + BK - 1) / BK, lp = n_tiles * BK;
  const size_t head = static_cast<size_t>(bh) * L * D;
  const int8_t* k8h = k8 + static_cast<size_t>(bh) * lp * D;
  const __nv_bfloat16* vh = v + head;
  const int8_t* v8h = v8t + static_cast<size_t>(bh) * lp * D;

  // Step i < p1 is pass 1 over tiles 4i..4i + 3 (k8 only), step p1 + jj pass 2
  // over tiles 2jj and 2jj + 1 (k8, and V or v8); its copies go to stage
  // i % STAGES. Tiles past the last are zero-filled: their products run, on
  // masked keys, so that every step issues the same tensor-core work. Each
  // thread copies the same chunks of every tile: one 16-byte chunk of an int8
  // tile, two of a bf16 V tile.
  const int p1 = (n_tiles + 3) / 4, steps = p1 + (n_tiles + 1) / 2;
  const int cr = tid >> 2, cq = tid & 3;
  const uint32_t i8_dst = swz64(cr, cq);
  const int8_t* k8_src = k8h + cr * D + cq * 16;
  const int8_t* v8_src = v8h + cr * D + cq * 16;
  int v_row[2], v_col[2];
  uint32_t v_dst[2];
#pragma unroll
  for (int i2 = 0; i2 < 2; ++i2) {
    const int idx = tid + i2 * THREADS;
    v_row[i2] = idx >> 3;
    v_col[i2] = (idx & 7) * 8;
    v_dst[i2] = I8_TILE + swz128(idx >> 3, idx & 7);
  }
  auto load = [&](int i) {
    const uint32_t st = ring + (i % STAGES) * R::STAGE;
    if (i < p1) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int tt = 4 * i + u;
        const bool in = tt < n_tiles;
        cp_async16(st + u * I8_TILE + i8_dst, k8_src + static_cast<size_t>(in ? tt : 0) * I8_TILE,
                   in ? 16 : 0);
      }
      return;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int tt = 2 * (i - p1) + u;
      const bool in = tt < n_tiles;
      const uint32_t base = st + u * R::TILE;
      cp_async16(base + i8_dst, k8_src + static_cast<size_t>(in ? tt : 0) * I8_TILE, in ? 16 : 0);
      if constexpr (FULL8) {
        cp_async16(base + I8_TILE + i8_dst, v8_src + static_cast<size_t>(in ? tt : 0) * I8_TILE,
                   in ? 16 : 0);
      } else {
#pragma unroll
        for (int i2 = 0; i2 < 2; ++i2) {
          const int key = tt * BK + v_row[i2];
          const bool kin = key < L;
          cp_async16(base + v_dst[i2], vh + static_cast<size_t>(kin ? key : 0) * D + v_col[i2],
                     kin ? 16 : 0);
        }
      }
    }
  };
#pragma unroll
  for (int i = 0; i < AHEAD; ++i) {
    if (i < steps) load(i);
    cp_async_commit();
  }

  // Each thread pair quantizes one q row (32 values each): warp w of a
  // warpgroup its rows 16w..16w + 15.
  {
    const int tw = tid & 127, rl = tw >> 1, half = tw & 1, row = q0 + wg * 64 + rl;
    uint4 x[4] = {};
    if (row < L) {
      const uint4* src =
          reinterpret_cast<const uint4*>(q + head + static_cast<size_t>(row) * D + half * 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) x[i] = src[i];
    }
    const __nv_bfloat16* xv = reinterpret_cast<const __nv_bfloat16*>(x);
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) a = fmaxf(a, fabsf(__bfloat162float(xv[i])));
    const float qm = fmaxf(fmaxf(a, __shfl_xor_sync(0xffffffffu, a, 1)), 1e-6f);
    const float scale = 127.f / qm;
    uint32_t w[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      w[i] = pack4(code(__bfloat162float(xv[4 * i]), scale),
                   code(__bfloat162float(xv[4 * i + 1]), scale),
                   code(__bfloat162float(xv[4 * i + 2]), scale),
                   code(__bfloat162float(xv[4 * i + 3]), scale));
    }
    const uint32_t qrow = q8s + wg * (64 * D);
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                   ::"r"(qrow + swz64(rl, 2 * half + cc)),
                   "r"(w[4 * cc]), "r"(w[4 * cc + 1]), "r"(w[4 * cc + 2]), "r"(w[4 * cc + 3])
                   : "memory");
    }
    if (q8_out != nullptr && row < L) {
      uint4* dst =
          reinterpret_cast<uint4*>(q8_out + head + static_cast<size_t>(row) * D + half * 32);
      dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
      dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
    }
    if (half == 0) qmax_s[wg * 64 + rl] = qm;
  }
  __syncwarp();  // a warp quantized the 16 rows it reads below
  const int r_lo = wg * 64 + (warp & 3) * 16 + g;  // this thread's rows: r_lo, r_lo + 8
  const float kscale = kmax[bh] / Q127;
  const float mult[2] = {__fmul_rn(qmax_s[r_lo], kscale), __fmul_rn(qmax_s[r_lo + 8], kscale)};
  const uint32_t qw = q8s + wg * (64 * D);
  // The warp's 16 q8 rows as the register A operand of QK^T, one per 32-wide
  // step of d (the m16n8k32 layout: rows g and g + 8, bytes 4t.. and 16 + 4t..).
  uint32_t qa[2][4];
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = (warp & 3) * 16 + g + 8 * (r & 1), col = kk * 32 + 16 * (r >> 1) + 4 * t;
      asm volatile("ld.shared.b32 %0, [%1];\n"
                   : "=r"(qa[kk][r])
                   : "r"(qw + swz64(row, col >> 4) + (col & 15)));
    }
  }

  // Pass 1: the row maxima, by integer max over the real keys. float(x) is
  // exact for |x| <= 127 * 127 * 64 < 2^24 and x * mult (mult > 0, rounded)
  // does not decrease as x grows, so fmul(float(max s32), mult) equals the
  // max of fmul(float(s32), mult) over the row bit for bit.
  int mi[2] = {INT_MIN, INT_MIN};
  auto row_max = [&](const int (&sc)[32], int j) {
    const int lim = L - j * BK;  // keys of the tile below L (the ragged last tile has fewer)
    if (lim >= BK) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        mi[0] = max(mi[0], max(sc[4 * nt], sc[4 * nt + 1]));
        mi[1] = max(mi[1], max(sc[4 * nt + 2], sc[4 * nt + 3]));
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int c0 = nt * 8 + 2 * t;
        const bool in0 = c0 < lim, in1 = c0 + 1 < lim;
        mi[0] = max(mi[0], max(in0 ? sc[4 * nt] : INT_MIN, in1 ? sc[4 * nt + 1] : INT_MIN));
        mi[1] = max(mi[1], max(in0 ? sc[4 * nt + 2] : INT_MIN, in1 ? sc[4 * nt + 3] : INT_MIN));
      }
    }
  };
  // Step i's copies landed for everyone; step i + AHEAD loads into the stage
  // of step i + AHEAD - STAGES, whose tensor-core reads every thread has
  // waited for by now (see the waits below).
  auto next_step = [&](int i) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    if (i + AHEAD < steps) load(i + AHEAD);
    cp_async_commit();  // an empty group keeps the wait count uniform
    return ring + (i % STAGES) * R::STAGE;
  };
  auto scores = [&](int (&sc)[32], uint32_t st) {  // S = q8 k8^T, two 32-wide steps of d
    wgmma_fence();
    wgmma_s8_rs(sc, qa[0], sw64_desc(st), 0);
    wgmma_s8_rs(sc, qa[1], sw64_desc(st + 32), 1);
    wgmma_commit();
  };
  // Four tiles a step, two at a time: S of the second runs while the max of
  // the first is taken.
  {
    int sa[32], sb[32];
    zero_regs(sa);
    zero_regs(sb);
    for (int i = 0; i < p1; ++i) {
      const uint32_t st = next_step(i);
#pragma unroll
      for (int u = 0; u < 4; u += 2) {
        scores(sa, st + u * I8_TILE);
        scores(sb, st + (u + 1) * I8_TILE);
        wgmma_wait<1>();  // S of tile 4i + u
        fence_regs(sa);
        row_max(sa, 4 * i + u);
        wgmma_wait<0>();  // S of tile 4i + u + 1
        fence_regs(sb);
        row_max(sb, 4 * i + u + 1);
      }
    }
  }
  float m[2];  // the rows' score maxima
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mi[h] = max(mi[h], __shfl_xor_sync(0xffffffffu, mi[h], 1));
    mi[h] = max(mi[h], __shfl_xor_sync(0xffffffffu, mi[h], 2));
    m[h] = __fmul_rn(i2f(mi[h]), mult[h]);  // every row has key 0 < L
  }

  // Pass 2: the same scores, e, its sum and P V, by half tiles of 32 keys,
  // each with its own score and A-operand registers (sh[h], pa[h]).
  constexpr int KC = FULL8 ? 1 : 2;  // A operands of a half tile's P V
  Acc acc[32];
  uint32_t pa[2][KC][4];
  int sh[2][16];
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  zero_regs(acc);
  zero_regs(sh[0]);
  zero_regs(sh[1]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pa[h][kc][r] = 0u;
    }
  }
  auto half_scores = [&](int (&sc)[16], uint32_t kh) {  // keys of a half tile at kh
    wgmma_fence();
    wgmma_s8_rs_n32(sc, qa[0], sw64_desc(kh), 0);
    wgmma_s8_rs_n32(sc, qa[1], sw64_desc(kh + 32), 1);
    wgmma_commit();
  };
  // P V of one half tile: its A operands p, its V (qk8: 32 rows of the bf16
  // tile from vh; full8: the v8 tile's 32 bytes of k from vh).
  auto half_pv = [&](const uint32_t (&p)[KC][4], uint32_t vh) {
    wgmma_fence();
    if constexpr (FULL8) {
      wgmma_s8_rs(acc, p[0], sw64_desc(vh));
    } else {
#pragma unroll
      for (int kc = 0; kc < 2; ++kc) wgmma_bf16_rs(acc, p[kc], sw128_desc(vh + kc * 16 * (D * 2)));
    }
    wgmma_commit();
  };
  auto softmax = [&](int (&sc)[16], uint32_t (&p)[KC][4], int col0) {
    fence_regs(sc);  // (not acc: a P V may still write it)
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) fence_regs(p[kc]);
    if (col0 + BK / 2 > L) {
      half_softmax<FULL8, true>(p, sc, mult, m, l, col0, t, L);
    } else {
      half_softmax<FULL8, false>(p, sc, mult, m, l, col0, t, L);
    }
  };
  // Where half h's V starts in a stage's V (or v8) tile.
  constexpr int V_HALF = FULL8 ? BK / 2 : (BK / 2) * D * 2;
  for (int jj = 0; jj < steps - p1; ++jj) {
    // Tiles A = 2jj and B = 2jj + 1, four halves; each half's S is issued
    // one half ahead of its softmax (the first of the step with the second),
    // so it runs on the tensor cores while the softmax before it does. Every
    // wait retires the products issued before the step or in it, in order;
    // the last half's P V runs on into the next step.
    const uint32_t st = next_step(p1 + jj);
    const int ja = 2 * jj * BK, jb = ja + BK;
    const uint32_t va = st + I8_TILE, vb = st + R::TILE + I8_TILE;
    half_scores(sh[0], st);                                  // S a(A)
    half_scores(sh[1], st + (BK / 2) * D);                   // S b(A)
    wgmma_wait<1>();                                         // S a(A)
    softmax(sh[0], pa[0], ja);
    half_pv(pa[0], va);                                      // P V a(A)
    half_scores(sh[0], st + R::TILE);                        // S a(B)
    wgmma_wait<2>();                                         // S b(A)
    softmax(sh[1], pa[1], ja + BK / 2);
    half_pv(pa[1], va + V_HALF);                             // P V b(A)
    half_scores(sh[1], st + R::TILE + (BK / 2) * D);         // S b(B)
    wgmma_wait<2>();                                         // P V a(A), S a(B)
    softmax(sh[0], pa[0], jb);
    half_pv(pa[0], vb);                                      // P V a(B)
    wgmma_wait<1>();                                         // P V b(A), S b(B)
    softmax(sh[1], pa[1], jb + BK / 2);
    half_pv(pa[1], vb + V_HALF);                             // P V b(B)
  }
  wgmma_wait<0>();  // the last P V
  fence_regs(acc);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) fence_regs(pa[h][kc]);
  }
  cp_async_wait<0>();  // no copy in flight past the end (the trailing groups are empty)

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }

  // The warp's 16 output rows go through a stage no step reads any more (the
  // other warpgroup may still be in its last two), then leave in 16-byte
  // stores.
  const uint32_t ob = ring + ((steps + wg) % STAGES) * R::STAGE;
  const int orow = (warp & 3) * 16 + g;  // in the warpgroup's 64
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int ch = nt * 8 + 2 * t;
    float o[4];
    if constexpr (FULL8) {
      const float vs0 = vmax[static_cast<size_t>(bh) * D + ch] / Q127;
      const float vs1 = vmax[static_cast<size_t>(bh) * D + ch + 1] / Q127;
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        o[x] = __fmul_rn(__int2float_rn(acc[4 * nt + x]), (x & 1) ? vs1 : vs0);
      }
    } else {
#pragma unroll
      for (int x = 0; x < 4; ++x) o[x] = acc[4 * nt + x];
    }
    const uint32_t w0 = pack_bf16(o[0] / l[0], o[1] / l[0]);
    const uint32_t w1 = pack_bf16(o[2] / l[1], o[3] / l[1]);
    const uint32_t cb = t * 4;  // byte offset of the column pair inside the chunk
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(ob + swz128(orow, nt) + cb), "r"(w0) : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(ob + swz128(orow + 8, nt) + cb), "r"(w1)
                 : "memory");
  }
  __syncwarp();
  __nv_bfloat16* oh = out + head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int idx = lane + i * 32;  // 16 rows x 8 chunks
    const int r = (warp & 3) * 16 + (idx >> 3), c = idx & 7, row = q0 + wg * 64 + r;
    if (row < L) {
      uint4 val;
      asm volatile("ld.shared.v4.b32 {%0,%1,%2,%3}, [%4];\n"
                   : "=r"(val.x), "=r"(val.y), "=r"(val.z), "=r"(val.w)
                   : "r"(ob + swz128(r, c))
                   : "memory");
      *reinterpret_cast<uint4*>(oh + static_cast<size_t>(row) * D + c * 8) = val;
    }
  }
}

}  // namespace

// parts: 1 the pre-pass, 2 the attention, 3 both (the wrapper's call; the
// others time one kernel alone).
extern "C" int sstw_flash_q8(const void* q, const void* k, const void* v, void* o, void* k8,
                             void* kmax, void* v8t, void* vmax, void* q8, int bh, int L,
                             int full8, int parts, void* stream) {
  // Above 48 KB a block's dynamic shared memory needs this opt-in, once.
  static const cudaError_t opt_in = [] {
    cudaError_t e = cudaFuncSetAttribute(flash_q8_kernel<false>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Ring<false>::SMEM);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(flash_q8_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Ring<true>::SMEM);
    }
    return e;
  }();
  if (opt_in != cudaSuccess) return static_cast<int>(opt_in);
  if (bh < 1 || bh > 65535 || L < 1 || parts < 1 || parts > 3) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (parts & 1) {
    flash_q8_quant_kernel<<<dim3(PREP_CLUSTER, bh), PREP_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v),
        static_cast<int8_t*>(k8), static_cast<float*>(kmax), static_cast<int8_t*>(v8t),
        static_cast<float*>(vmax), L, full8);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (!(parts & 2)) return 0;
  const dim3 grid((L + BQ - 1) / BQ, bh);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  if (full8) {
    flash_q8_kernel<true><<<grid, THREADS, Ring<true>::SMEM, st>>>(
        qp, vp, static_cast<const int8_t*>(k8), static_cast<const float*>(kmax),
        static_cast<const int8_t*>(v8t), static_cast<const float*>(vmax),
        static_cast<__nv_bfloat16*>(o), static_cast<int8_t*>(q8), L);
  } else {
    flash_q8_kernel<false><<<grid, THREADS, Ring<false>::SMEM, st>>>(
        qp, vp, static_cast<const int8_t*>(k8), static_cast<const float*>(kmax),
        static_cast<const int8_t*>(v8t), static_cast<const float*>(vmax),
        static_cast<__nv_bfloat16*>(o), static_cast<int8_t*>(q8), L);
  }
  return static_cast<int>(cudaGetLastError());
}

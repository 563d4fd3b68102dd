// K1: fused STFT -> power -> mel projection -> log10 for the Whisper frontend.
//
// Replaces the Pallas TPU kernel ops/pallas_mel.py:_mel_kernel, launched by
// log_mel_spectrogram_fused (pallas_call at ops/pallas_mel.py:74). The plain
// PyTorch version is ops/mel.py:log_mel_power in this package.
//
// What it computes, per frame f of one clip (x reflect-padded by 200 at
// both edges, w the periodic Hann window, n < 400, k < 201):
//   X[k]      = sum_n x[f*160 + n - 200] * w[n] * exp(-2 pi i n k / 400)
//   p[k]      = |X[k]|^2
//   out[f][m] = log10(max(sum_k p[k] * mel[m][k], 1e-10))
// in fp32 throughout (TF32 misses the 3e-4 tolerance on the log-mel). The
// whole-clip clamp to max - 8 and the (x + 4) / 4 scaling need a reduction
// across the clip; they stay outside, as in the JAX package.
//
// Bound on the H100: device memory. The function reads 1.92 MB of audio and
// writes 1.54 MB of log-mel (128 mels) per 30 s window; its arithmetic, a
// 400-point real FFT, the power and the filterbank's ~400 nonzeros per frame,
// is about 10 kflop a frame, under half the bytes' time at the fp32 peak.
//
// Design: a block owns a tile of TILE_F frames of one clip and loads the
// contiguous span of its samples once, coalesced, reflecting at both clip
// edges, with every table beside it in shared memory, before its first
// barrier; the five phases after it read nothing else. Forty threads a frame
// take the 400-point real DFT as a 200-point complex FFT of z[n] = x[2n] +
// i x[2n+1] (the Hann window applied as z is read from the span), in three
// Stockham stages of radix 5, 5 and 8 between two buffers in shared memory
// (no bit reversal), then the real split, bins k and 200 - k from one pair:
//   e = (Z[k] + conj Z[200-k]) / 2,   o = -i (Z[k] - conj Z[200-k]) / 2,
//   X[k] = e + W^k o,   |X[200-k]| = |e - W^k o|,   W = exp(-2 pi i / 400).
// Twiddles and window come from tables built in float64 on the host and
// stored as fp32 (ops/fused_mel._tables). The mel projection is sparse: each
// band's first bin, bin count (at most 14) and run of weights (391 nonzeros
// at 80 mels, 394 at 128), one thread a (frame, band). What sets the time
// is the instructions around the FFT's arithmetic (PERF.md).

#include <cuda_runtime.h>

namespace {

constexpr int N_FFT = 400;
constexpr int HOP = 160;
constexpr int N = N_FFT / 2;       // complex FFT points
constexpr int N_FREQ = N + 1;      // 201 bins
constexpr int TILE_F = 8;          // frames per block
constexpr int LANES = 40;          // threads per frame: the radix-5 stages' butterflies
constexpr int THREADS = TILE_F * LANES;
constexpr int SPAN = (TILE_F - 1) * HOP + N_FFT;  // samples a tile reads
constexpr int MAX_MELS = 128;
constexpr int MAX_WEIGHTS = 2 * N_FREQ;  // filterbank nonzeros: no bin feeds more than two bands
constexpr int MIN_BLOCKS = 5;      // an SM (<= 40 registers a thread), as shared memory allows

__device__ __forceinline__ float2 operator+(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 operator-(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 operator*(float s, float2 a) { return make_float2(s * a.x, s * a.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}
__device__ __forceinline__ float2 mul_neg_i(float2 a) { return make_float2(a.y, -a.x); }  // -i a

// In-place DFTs (exp(-2 pi i r m / R)) of 4, 5 and 8 points.
__device__ __forceinline__ void dft4(float2& a0, float2& a1, float2& a2, float2& a3) {
  const float2 t0 = a0 + a2, t1 = a0 - a2, t2 = a1 + a3, t3 = mul_neg_i(a1 - a3);
  a0 = t0 + t2;
  a2 = t0 - t2;
  a1 = t1 + t3;
  a3 = t1 - t3;
}

__device__ __forceinline__ void dft(float2 (&v)[5]) {
  constexpr float C1 = 0.30901699437494745f, C2 = -0.8090169943749475f;  // cos(2 pi / 5), cos(4 pi / 5)
  constexpr float S1 = 0.9510565162951535f, S2 = 0.5877852522924731f;    // sin(2 pi / 5), sin(4 pi / 5)
  const float2 t1 = v[1] + v[4], t2 = v[2] + v[3], t3 = v[1] - v[4], t4 = v[2] - v[3];
  const float2 a1 = v[0] + C1 * t1 + C2 * t2, a2 = v[0] + C2 * t1 + C1 * t2;
  const float2 b1 = mul_neg_i(S1 * t3 + S2 * t4), b2 = mul_neg_i(S2 * t3 - S1 * t4);
  v[0] = v[0] + t1 + t2;
  v[1] = a1 + b1;
  v[4] = a1 - b1;
  v[2] = a2 + b2;
  v[3] = a2 - b2;
}

__device__ __forceinline__ void dft(float2 (&v)[8]) {
  constexpr float R = 0.7071067811865476f;  // 1 / sqrt(2)
  dft4(v[0], v[2], v[4], v[6]);  // even inputs
  dft4(v[1], v[3], v[5], v[7]);  // odd inputs, then times W8^m
  const float2 o1 = R * make_float2(v[3].x + v[3].y, v[3].y - v[3].x);
  const float2 o2 = mul_neg_i(v[5]);
  const float2 o3 = R * make_float2(v[7].y - v[7].x, -(v[7].x + v[7].y));
  const float2 e0 = v[0], e1 = v[2], e2 = v[4], e3 = v[6], o0 = v[1];
  v[0] = e0 + o0;
  v[4] = e0 - o0;
  v[1] = e1 + o1;
  v[5] = e1 - o1;
  v[2] = e2 + o2;
  v[6] = e2 - o2;
  v[3] = e3 + o3;
  v[7] = e3 - o3;
}

// One Stockham stage of radix R after stages whose radices multiply to NS:
// butterfly j < N / R reads elements j + r N / R, turns them by
// W_{NS R}^{(j mod NS) r} (table index (j mod NS) r 400 / (NS R)), takes
// their R-point DFT and writes elements (j / NS) NS R + j mod NS + r NS.
template <int R, int NS, class Load>
__device__ __forceinline__ void stage(Load load, float2* out, int j, const float2* tw) {
  float2 v[R];
  const int k = j % NS;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = load(j + r * (N / R));
    if (NS > 1 && r > 0) v[r] = cmul(v[r], tw[k * r * (N_FFT / (NS * R))]);
  }
  dft(v);
  const int d = (j / NS) * NS * R + k;
#pragma unroll
  for (int r = 0; r < R; ++r) out[d + r * NS] = v[r];
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
log_mel_kernel(const float* __restrict__ audio,      // [B, n_samples]
               const float2* __restrict__ twiddles,  // [N_FFT]: exp(-2 pi i m / 400)
               const float* __restrict__ window,     // [N_FFT]
               const int* __restrict__ bands,        // [n_mels, 3]: first bin, count, offset
               const float* __restrict__ weights,    // [n_weights]: each band's run
               float* __restrict__ out,              // [B, n_frames, n_mels]
               int n_samples, int n_frames, int n_mels, int n_weights) {
  __shared__ float span[SPAN];
  __shared__ float2 buf[2][TILE_F][N];
  __shared__ float2 tw[N_FFT];
  __shared__ float win[N_FFT];
  __shared__ int band[3][MAX_MELS];
  __shared__ float wt[MAX_WEIGHTS];

  // Every load of the block at once: the span of samples, then the tables.
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * TILE_F;
  const int tile = min(TILE_F, n_frames - f0);
  const float* x = audio + static_cast<size_t>(b) * n_samples;
  const int s0 = f0 * HOP - N_FFT / 2;
#pragma unroll
  for (int it = 0; it < (SPAN + THREADS - 1) / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    if (i < (tile - 1) * HOP + N_FFT) {
      int j = s0 + i;
      if (j < 0) j = -j;
      if (j >= n_samples) j = 2 * (n_samples - 1) - j;
      span[i] = __ldg(x + j);
    }
  }
  for (int i = threadIdx.x; i < N_FFT; i += THREADS) {
    tw[i] = __ldg(twiddles + i);
    win[i] = __ldg(window + i);
  }
  for (int i = threadIdx.x; i < 3 * n_mels; i += THREADS) band[i % 3][i / 3] = __ldg(bands + i);
  for (int i = threadIdx.x; i < n_weights; i += THREADS) wt[i] = __ldg(weights + i);
  __syncthreads();

  // Frames past the clip's end (a ragged last tile) run on stale shared
  // memory and are not written.
  const int fr = threadIdx.x / LANES, j = threadIdx.x % LANES;
  const float* xf = span + fr * HOP;
  stage<5, 1>([&](int n) {
    return make_float2(xf[2 * n] * win[2 * n], xf[2 * n + 1] * win[2 * n + 1]);
  }, buf[0][fr], j, tw);
  __syncthreads();
  stage<5, 5>([&](int n) { return buf[0][fr][n]; }, buf[1][fr], j, tw);
  __syncthreads();
  if (j < N / 8) stage<8, 25>([&](int n) { return buf[1][fr][n]; }, buf[0][fr], j, tw);
  __syncthreads();

  // The real split: X[N-k] = conj(even - W^k odd), so one pair gives bins k
  // and N - k (k = 100 writes its bin twice).
  float* power = reinterpret_cast<float*>(buf[1]);  // [TILE_F][N_FREQ]
  const float2* z = buf[0][fr];
#pragma unroll
  for (int k = j; k < (N / 2 + LANES) / LANES * LANES; k += LANES) {
    if (k <= N / 2) {
      const float2 a = z[k], c = z[(N - k) % N];
      const float2 even = 0.5f * make_float2(a.x + c.x, a.y - c.y);  // (Z[k] + conj Z[N-k]) / 2
      const float2 odd = cmul(tw[k], mul_neg_i(0.5f * make_float2(a.x - c.x, a.y + c.y)));
      const float2 lo = even + odd, hi = even - odd;
      power[fr * N_FREQ + k] = fmaf(lo.x, lo.x, lo.y * lo.y);
      power[fr * N_FREQ + N - k] = fmaf(hi.x, hi.x, hi.y * hi.y);
    }
  }
  __syncthreads();

  // One thread a (frame, band): eight frames of a band in neighbouring
  // lanes, so a warp's lanes take four neighbouring bands, of near-equal bin
  // counts, and its loop over the bins runs about as often as each lane
  // needs (neighbouring bands in neighbouring lanes would run it as often as
  // the widest of 32 bands).
  const int f = threadIdx.x % TILE_F;
#pragma unroll
  for (int it = 0; it < (TILE_F * MAX_MELS + THREADS - 1) / THREADS; ++it) {
    const int m = (threadIdx.x + it * THREADS) / TILE_F;
    if (m < n_mels && f < tile) {
      const float* p = power + f * N_FREQ + band[0][m];
      const float* w = wt + band[2][m];
      float acc = 0.f;
      for (int t = 0; t < band[1][m]; ++t) acc = fmaf(p[t], w[t], acc);
      out[(static_cast<size_t>(b) * n_frames + f0 + f) * n_mels + m] = log10f(fmaxf(acc, 1e-10f));
    }
  }
}

}  // namespace

extern "C" int sstw_log_mel(const void* audio, const void* twiddles, const void* window,
                            const void* bands, const void* weights, void* out, int batch,
                            int n_samples, int n_frames, int n_mels, int n_weights,
                            void* stream) {
  if (batch < 1 || n_samples <= N_FFT / 2 || n_frames < 1 || n_frames > n_samples / HOP ||
      n_mels < 1 || n_mels > MAX_MELS || n_weights < 0 || n_weights > MAX_WEIGHTS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((n_frames + TILE_F - 1) / TILE_F, batch);
  log_mel_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(audio), static_cast<const float2*>(twiddles),
      static_cast<const float*>(window), static_cast<const int*>(bands),
      static_cast<const float*>(weights), static_cast<float*>(out), n_samples, n_frames, n_mels,
      n_weights);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sstw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

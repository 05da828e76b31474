// Fused log-mel featurizer: windowed FFT -> magnitude -> mel -> log-clamp.
//
// Replaces the TPU kernel gantron_tpu/ops/pallas_mel.py:62 (_kernel, launched
// by fused_frames_to_mel, wrapped by pallas_mel_spectrogram). Same function,
// for each frame t of the reflect-padded waveform yp (B, S):
//     x      = yp[b, t*hop : t*hop + n_fft] * window
//     X      = DFT(x)[0 .. n_fft/2]                    (nb = n_fft/2 + 1 bins)
//     out[b, m, t] = log(max(sum_k |X[k]| * mel_w[k, m], 1e-5))
// window is the Hann window of win_length centred in n_fft, mel_w is
// (nb, n_mel), out is (B, n_mel, T) with T = (S - n_fft) / hop + 1. The TPU
// kernel's 128-lane padding of bins and mels does not carry over: nb, n_mel
// and T are masked here, and the output is written in the public layout.
//
// Bound. The least work for this function is a real FFT, the magnitudes and
// the filterbank's nonzeros: about 2.5*n_fft*log2(n_fft) + 3*nb + 2*nnz(mel_w)
// operations a frame (about 29 kFLOP at n_fft = 1024, n_mel = 80), against
// 4*hop bytes of new waveform and 4*n_mel bytes of output. For 8 x 10 s of
// 22 kHz audio that is about 3 us by either count (67 TFLOP/s float32,
// 3.35 TB/s on an H100 SXM): bytes and operations bound it alike, and no
// tensor-core route keeps float32's precision. The TPU kernel does the DFT as
// a dense product on its matrix unit (2*n_fft*2*nb operations a frame, 73x the
// FFT's); on Hopper that streams a 4.2 MB basis through every block.
//
// Design: the FFT route (n_fft a power of two, 64 to 4096). One block of 256
// threads owns TF = 4 consecutive frames of one row b: a 501-frame utterance
// (B = 1) launches 126 blocks, about one for each of the card's 132 SMs, and
// the grid of a large batch has many blocks an SM (32 KB of shared memory a
// block at n_fft = 1024).
//  * Frames by address: the (TF-1)*hop + n_fft samples that the TF frames
//    cover are staged once in shared memory; no (B, T, n_fft) frame tensor is
//    written.
//  * A real n_fft-point FFT as an N = n_fft/2-point complex FFT of
//    z[n] = w[2n]x[2n] + i*w[2n+1]x[2n+1], in place in shared memory:
//    radix-2 decimation in frequency, natural order in, bit-reversed out, its
//    stages fused two at a time in registers (radix-2^2: a thread reads 4
//    values, does 2 stages, writes 4), so N = 512 takes one radix-2 pass and
//    four radix-2^2 passes with a barrier each. The first pass reads the
//    samples and the window straight from the staged tile. Real and imaginary
//    parts are separate arrays padded by one word every 32 against bank
//    conflicts. Twiddles come from a table of n_fft/2 complex values
//    e^(-2*pi*i*k/n_fft) built in float64 on the host (W_N^j = table[2j]).
//  * The split step X[k] = (Z[k] + conj Z[N-k])/2
//    - i*W^k*(Z[k] - conj Z[N-k])/2, k = 0..N, W = e^(-2*pi*i/n_fft), reads
//    Z at bit-reversed positions and writes |X[k]| to shared memory.
//  * Each (mel, frame) sum runs over that mel's nonzero bins [lo_m, hi_m)
//    only (727 of 41,040 filterbank entries at 80 mels), in bin order, then
//    log(max(., 1e-5)) is stored into (B, n_mel, T).
// So the spectrum never leaves shared memory, which is what the TPU kernel
// keeps out of HBM, and the work is the FFT's, not the dense DFT's.
//
// The dense route (any other n_fft) is the earlier kernel, kept so that the
// card takes every n_fft it took before: a block of 8 frames multiplies the
// staged frames by the windowed DFT basis [cos | -sin] (n_fft, 2*nb) in chunks
// of 512 bins staged through shared memory, folds each chunk's magnitudes into
// the mel sums at once, and does the bins after the last full chunk with one
// warp a (frame, bin).
//
// Both routes sum in a fixed order with no atomics, so a second launch on the
// same input is bit-equal to the first.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMel = 128;
constexpr int kMaxSmem = 232448;  // a block's shared memory on Hopper
constexpr int kMaxDevices = 64;

// Raises a kernel's dynamic shared-memory cap to ``smem`` once per device
// (not during a CUDA graph capture, which a warm-up call precedes).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem,
                       std::atomic<size_t> (&cap)[kMaxDevices]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (smem <= cap[dev].load()) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess) cap[dev].store(smem);
  return e;
}

// Stages the span samples of a tile that starts at sample ``start`` of row y;
// past the end of the row (frames beyond T) reads 0.
__device__ __forceinline__ void stage_samples(float* samp, const float* y,
                                              long long start, int span, int S) {
  const long long avail = (long long)S - start;
  for (int i = threadIdx.x; i < span; i += kThreads)
    samp[i] = i < avail ? y[start + i] : 0.f;
}

// ---------------------------------------------------------------- FFT route

constexpr int TF = 4;  // frames a block
constexpr int kMinFftLog = 6, kMaxFftLog = 12;

struct Cx {
  float x, y;
};
__device__ __forceinline__ Cx add(Cx a, Cx b) { return {a.x + b.x, a.y + b.y}; }
__device__ __forceinline__ Cx sub(Cx a, Cx b) { return {a.x - b.x, a.y - b.y}; }
__device__ __forceinline__ Cx mul(Cx a, Cx b) {
  return {a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x};
}
__device__ __forceinline__ Cx mul_neg_i(Cx a) { return {a.y, -a.x}; }

// One padding word every 32 words: the strided passes spread over the banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

size_t fft_smem_bytes(int n_fft, int hop) {
  const int N = n_fft / 2;
  const int fs = N + N / 32;  // padded length of one frame's buffer
  return sizeof(float) * (2 * (size_t)TF * fs + (size_t)TF * (N + 1) +
                          (size_t)(TF - 1) * hop + n_fft);
}

struct FftTile {
  float* re;        // (TF, fs), padded
  float* im;        // (TF, fs), padded
  const float* samp;
  const float2* window;  // (N,) pairs of (w[2n], w[2n+1])
  const float2* tw;      // (N,) e^(-2*pi*i*k/n_fft)
  int fs, hop, lg;       // lg = log2(N)
};

template <bool kFromSamples>
__device__ __forceinline__ Cx load(const FftTile& t, int f, int n) {
  if (kFromSamples) {
    const float* x = t.samp + f * t.hop + 2 * n;
    const float2 w = __ldg(t.window + n);
    return {x[0] * w.x, x[1] * w.y};
  }
  const int a = f * t.fs + pad(n);
  return {t.re[a], t.im[a]};
}

__device__ __forceinline__ void store(const FftTile& t, int f, int n, Cx v) {
  const int a = f * t.fs + pad(n);
  t.re[a] = v.x;
  t.im[a] = v.y;
}

__device__ __forceinline__ Cx twiddle(const FftTile& t, int k) {
  const float2 w = __ldg(t.tw + k);
  return {w.x, w.y};
}

// One radix-2 DIF stage of span N (the first pass when log2 N is odd).
template <bool kFromSamples>
__device__ void radix2_pass(const FftTile& t) {
  const int half = 1 << (t.lg - 1);
  for (int j = threadIdx.x; j < TF * half; j += kThreads) {
    const int f = j >> (t.lg - 1), p = j & (half - 1);
    const Cx a = load<kFromSamples>(t, f, p);
    const Cx b = load<kFromSamples>(t, f, p + half);
    store(t, f, p, add(a, b));
    store(t, f, p + half, mul(sub(a, b), twiddle(t, 2 * p)));  // W_N^p
  }
}

// Two radix-2 DIF stages, of spans 4q and 2q (lq = log2 q), fused.
template <bool kFromSamples>
__device__ void radix4_pass(const FftTile& t, int lq) {
  const int q = 1 << lq, per_frame = 1 << (t.lg - 2);
  for (int j = threadIdx.x; j < TF * per_frame; j += kThreads) {
    const int f = j >> (t.lg - 2), jj = j & (per_frame - 1);
    const int r = jj & (q - 1), n0 = ((jj >> lq) << (lq + 2)) + r;
    const Cx a0 = load<kFromSamples>(t, f, n0);
    const Cx a1 = load<kFromSamples>(t, f, n0 + q);
    const Cx a2 = load<kFromSamples>(t, f, n0 + 2 * q);
    const Cx a3 = load<kFromSamples>(t, f, n0 + 3 * q);
    // table[k] = W_{2N}^k, so W_{4q}^r = table[r * 2N / 4q] and
    // W_{2q}^r = table[r * 2N / 2q].
    const Cx w1 = twiddle(t, r << (t.lg - 1 - lq));
    const Cx w2 = twiddle(t, r << (t.lg - lq));
    const Cx b0 = add(a0, a2), b2 = mul(sub(a0, a2), w1);
    const Cx b1 = add(a1, a3), b3 = mul_neg_i(mul(sub(a1, a3), w1));
    store(t, f, n0, add(b0, b1));
    store(t, f, n0 + q, mul(sub(b0, b1), w2));
    store(t, f, n0 + 2 * q, add(b2, b3));
    store(t, f, n0 + 3 * q, mul(sub(b2, b3), w2));
  }
}

__global__ void __launch_bounds__(kThreads)
    fft_mel_kernel(const float* __restrict__ yp,
                   const float* __restrict__ window,
                   const float* __restrict__ tw,
                   const float* __restrict__ mel_w,
                   const int* __restrict__ bins, float* __restrict__ out,
                   int S, int T, int n_fft, int hop, int n_mel, int lg) {
  extern __shared__ float smem[];
  const int N = 1 << lg, fs = N + N / 32, ms = N + 1;
  FftTile t;
  t.re = smem;
  t.im = t.re + TF * fs;
  float* mag = t.im + TF * fs;  // (TF, ms)
  float* samp = mag + TF * ms;  // (TF - 1) * hop + n_fft samples
  t.samp = samp;
  t.window = reinterpret_cast<const float2*>(window);
  t.tw = reinterpret_cast<const float2*>(tw);
  t.fs = fs;
  t.hop = hop;
  t.lg = lg;

  const int b = blockIdx.y, t0 = blockIdx.x * TF;
  const int nf = min(TF, T - t0);  // frames of this tile inside T
  stage_samples(samp, yp + (size_t)b * S, (long long)t0 * hop,
                (TF - 1) * hop + n_fft, S);
  __syncthreads();

  // The FFT: stages of span N, N/2, ..., 2, two at a time after a lone
  // radix-2 stage when log2 N is odd. The first pass reads the samples.
  int lq = lg - 2;  // the first fused pass has span 4q = N
  if (lg & 1) {
    radix2_pass<true>(t);
    lq = lg - 3;
  } else {
    radix4_pass<true>(t, lq);
    lq -= 2;
  }
  for (; lq >= 0; lq -= 2) {
    __syncthreads();
    radix4_pass<false>(t, lq);
  }
  __syncthreads();

  // Split step: the real FFT's bins 0..N from the packed FFT (bit-reversed).
  for (int j = threadIdx.x; j < TF * ms; j += kThreads) {
    const int f = j / ms, k = j - f * ms;
    const int ik = (int)(__brev((unsigned)(k & (N - 1))) >> (32 - lg));
    const int in = (int)(__brev((unsigned)((N - k) & (N - 1))) >> (32 - lg));
    const Cx zk = load<false>(t, f, ik), zn = load<false>(t, f, in);
    const Cx s = {zk.x + zn.x, zk.y - zn.y};  // Z[k] + conj Z[N-k]
    const Cx d = {zk.x - zn.x, zk.y + zn.y};  // Z[k] - conj Z[N-k]
    const Cx w = k < N ? twiddle(t, k) : Cx{-1.f, 0.f};
    const Cx e = mul(w, d);  // X = (s - i*e) / 2
    const float xr = 0.5f * (s.x + e.y), xi = 0.5f * (s.y - e.x);
    mag[f * ms + k] = sqrtf(xr * xr + xi * xi);
  }
  __syncthreads();

  // Mel sums over each filter's nonzero bins, in bin order. Output
  // o = m*TF + f: neighbouring threads take neighbouring frames.
  for (int o = threadIdx.x; o < n_mel * TF; o += kThreads) {
    const int m = o / TF, f = o - m * TF;
    if (f >= nf) continue;
    const int lo = __ldg(bins + 2 * m), hi = __ldg(bins + 2 * m + 1);
    const float* mg = mag + f * ms;
    float s = 0.f;
    for (int k = lo; k < hi; ++k)
      s = fmaf(mg[k], __ldg(mel_w + (size_t)k * n_mel + m), s);
    out[((size_t)b * n_mel + m) * T + t0 + f] = logf(fmaxf(s, 1e-5f));
  }
}

// -------------------------------------------------------------- dense route

// The tile: DF frames a block; each thread holds RF frames x RB bins of re
// and im; NC basis rows are staged a step.
constexpr int DF = 8, RF = 8, RB = 2, NC = 8;
constexpr int TY = DF / RF;         // thread rows (frames)
constexpr int TX = kThreads / TY;   // thread columns (bins)
constexpr int KB = TX * RB;         // bins in a chunk
constexpr int MS = KB + 1;          // magnitude row stride
constexpr int kMelPer = (kMaxMel * DF + kThreads - 1) / kThreads;
static_assert(DF % RF == 0 && kThreads % TY == 0, "tile shape");
static_assert(TX % 32 == 0, "a warp shares one thread row");

size_t dense_smem_bytes(int n_fft, int hop) {
  return sizeof(float) * (2 * (size_t)NC * KB + (size_t)DF * MS +
                          (size_t)(DF - 1) * hop + n_fft);
}

__global__ void __launch_bounds__(kThreads, 2)
    dense_mel_kernel(const float* __restrict__ yp,
                     const float* __restrict__ basis,
                     const float* __restrict__ mel_w, float* __restrict__ out,
                     int S, int T, int n_fft, int hop, int nb, int n_mel) {
  extern __shared__ float smem[];
  float* cos_s = smem;            // (NC, KB)
  float* sin_s = cos_s + NC * KB;  // (NC, KB)
  float* mag_s = sin_s + NC * KB;  // (DF, MS)
  float* samp = mag_s + DF * MS;  // (DF - 1) * hop + n_fft samples

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int b = blockIdx.y, t0 = blockIdx.x * DF;
  const int nf = min(DF, T - t0);  // frames of this tile inside T
  const int ldb = 2 * nb;

  stage_samples(samp, yp + (size_t)b * S, (long long)t0 * hop,
                (DF - 1) * hop + n_fft, S);

  float macc[kMelPer];
#pragma unroll
  for (int j = 0; j < kMelPer; ++j) macc[j] = 0.f;

  const int n_full = nb / KB;
  for (int c = 0; c <= n_full; ++c) {
    const int k0 = c * KB;
    const int kc = c < n_full ? KB : nb - k0;  // bins in this chunk
    if (kc == 0) break;
    if (c < n_full) {
      float re[RF][RB], im[RF][RB];
#pragma unroll
      for (int f = 0; f < RF; ++f)
#pragma unroll
        for (int j = 0; j < RB; ++j) re[f][j] = im[f][j] = 0.f;

      for (int n0 = 0; n0 < n_fft; n0 += NC) {
        __syncthreads();  // the last readers of cos_s / sin_s are done
        for (int e = tid; e < NC * KB; e += kThreads) {
          const float* row = basis + (size_t)(n0 + e / KB) * ldb + k0 + e % KB;
          cos_s[e] = row[0];
          sin_s[e] = row[nb];
        }
        __syncthreads();
#pragma unroll 4
        for (int nn = 0; nn < NC; ++nn) {
          float x[RF], cv[RB], sv[RB];
#pragma unroll
          for (int f = 0; f < RF; ++f) x[f] = samp[(ty + f * TY) * hop + n0 + nn];
#pragma unroll
          for (int j = 0; j < RB; ++j) {
            cv[j] = cos_s[nn * KB + tx + j * TX];
            sv[j] = sin_s[nn * KB + tx + j * TX];
          }
#pragma unroll
          for (int f = 0; f < RF; ++f)
#pragma unroll
            for (int j = 0; j < RB; ++j) {
              re[f][j] = fmaf(x[f], cv[j], re[f][j]);
              im[f][j] = fmaf(x[f], sv[j], im[f][j]);
            }
        }
      }
      // Every thread passed the n0 loop's barriers after the last chunk's
      // mel sums, so mag_s is free.
#pragma unroll
      for (int f = 0; f < RF; ++f)
#pragma unroll
        for (int j = 0; j < RB; ++j)
          mag_s[(ty + f * TY) * MS + tx + j * TX] =
              sqrtf(re[f][j] * re[f][j] + im[f][j] * im[f][j]);
    } else {
      // The kc < KB bins left over: one warp a (frame, bin), lanes over n.
      __syncthreads();  // samp staged (nb < KB) / last mel sums done
      const int warp = tid / 32, lane = tid % 32;
      for (int p = warp; p < DF * kc; p += kThreads / 32) {
        const int f = p / kc, kk = p % kc;
        const float* col = basis + k0 + kk;
        float r = 0.f, i = 0.f;
        for (int n = lane; n < n_fft; n += 32) {
          const float xv = samp[f * hop + n];
          r = fmaf(xv, col[(size_t)n * ldb], r);
          i = fmaf(xv, col[(size_t)n * ldb + nb], i);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          r += __shfl_xor_sync(0xffffffffu, r, o);
          i += __shfl_xor_sync(0xffffffffu, i, o);
        }
        if (lane == 0) mag_s[f * MS + kk] = sqrtf(r * r + i * i);
      }
    }
    __syncthreads();

    // This chunk's share of the mel sums, in bin order. Output o = m*DF + f:
    // neighbouring threads take neighbouring frames (conflict-free mag_s
    // rows, broadcast mel_w reads, coalesced stores below).
#pragma unroll
    for (int j = 0; j < kMelPer; ++j) {
      const int o = tid + j * kThreads;
      if (o < n_mel * DF) {
        const int m = o / DF, f = o % DF;
        const float* w = mel_w + (size_t)k0 * n_mel + m;
        const float* mg = mag_s + f * MS;
        float s = macc[j];
        for (int kk = 0; kk < kc; ++kk) s = fmaf(mg[kk], w[(size_t)kk * n_mel], s);
        macc[j] = s;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kMelPer; ++j) {
    const int o = tid + j * kThreads;
    if (o < n_mel * DF) {
      const int m = o / DF, f = o % DF;
      if (f < nf)
        out[((size_t)b * n_mel + m) * T + t0 + f] = logf(fmaxf(macc[j], 1e-5f));
    }
  }
}

// log2(n_fft) when n_fft is a power of two the FFT route takes, else -1.
int fft_log2(int n_fft) {
  for (int lg = kMinFftLog; lg <= kMaxFftLog; ++lg)
    if (n_fft == 1 << lg) return lg;
  return -1;
}

int launch(const float* yp, const float* basis, const float* mel_w,
           const float* window, const float* tw, const int* bins, float* out,
           int B, int S, int T, int n_fft, int hop, int nb, int n_mel,
           cudaStream_t stream) {
  const int lg = fft_log2(n_fft);
  cudaError_t e;
  if (lg > 0) {
    static std::atomic<size_t> cap[kMaxDevices];
    const size_t smem = fft_smem_bytes(n_fft, hop);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    if ((e = allow_smem(fft_mel_kernel, smem, cap)) != cudaSuccess)
      return (int)e;
    const dim3 grid((T + TF - 1) / TF, B);
    fft_mel_kernel<<<grid, kThreads, smem, stream>>>(
        yp, window, tw, mel_w, bins, out, S, T, n_fft, hop, n_mel, lg - 1);
  } else {
    static std::atomic<size_t> cap[kMaxDevices];
    if (n_fft % NC != 0) return (int)cudaErrorInvalidValue;
    const size_t smem = dense_smem_bytes(n_fft, hop);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
    if ((e = allow_smem(dense_mel_kernel, smem, cap)) != cudaSuccess)
      return (int)e;
    const dim3 grid((T + DF - 1) / DF, B);
    dense_mel_kernel<<<grid, kThreads, smem, stream>>>(
        yp, basis, mel_w, out, S, T, n_fft, hop, nb, n_mel);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// All float tensors float32, all contiguous, on the current device: yp
// (B, S), basis (n_fft, 2*nb), mel_w (nb, n_mel), window (n_fft,), tw
// (n_fft/2, 2), bins (n_mel, 2) int32 [lo, hi) of each filter's nonzero bins,
// out (B, n_mel, T) with T = (S - n_fft) / hop + 1. A power-of-two n_fft from
// 64 to 4096 takes the FFT route (window, tw, bins), any other the dense route
// (basis). Returns cudaGetLastError() after the launch (0 = success).
extern "C" int mel_launch(const void* yp, const void* basis, const void* mel_w,
                          const void* window, const void* tw, const void* bins,
                          void* out, int B, int S, int T, int n_fft, int hop,
                          int nb, int n_mel, void* stream) {
  if (B < 1 || T < 1 || n_fft < 2 || hop < 1 || nb != n_fft / 2 + 1 ||
      n_mel < 1 || n_mel > kMaxMel || (long long)(T - 1) * hop + n_fft > S)
    return (int)cudaErrorInvalidValue;
  return launch(static_cast<const float*>(yp),
                static_cast<const float*>(basis),
                static_cast<const float*>(mel_w),
                static_cast<const float*>(window),
                static_cast<const float*>(tw), static_cast<const int*>(bins),
                static_cast<float*>(out), B, S, T, n_fft, hop, nb, n_mel,
                static_cast<cudaStream_t>(stream));
}

// 1 if mel_launch takes the FFT route for this n_fft, 0 if the dense route.
extern "C" int mel_fft_route(int n_fft) { return fft_log2(n_fft) > 0; }

extern "C" const char* mel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

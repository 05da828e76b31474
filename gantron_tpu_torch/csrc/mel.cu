// Fused log-mel featurizer: windowed DFT -> magnitude -> mel -> log-clamp.
//
// Replaces the TPU kernel gantron_tpu/ops/pallas_mel.py:62 (_kernel, launched
// by fused_frames_to_mel, wrapped by pallas_mel_spectrogram). Same function,
// for each frame t of the reflect-padded waveform yp (B, S):
//     x      = yp[b, t*hop : t*hop + n_fft]
//     re, im = x @ basis[:, :nb], x @ basis[:, nb:]   (Hann window folded in)
//     mag    = sqrt(re^2 + im^2)                       (nb = n_fft/2 + 1 bins)
//     out[b, m, t] = log(max(sum_k mag[k] * mel_w[k, m], 1e-5))
// basis is (n_fft, 2*nb) = [cos | -sin], mel_w is (nb, n_mel), out is
// (B, n_mel, T) with T = (S - n_fft) / hop + 1. The TPU kernel's 128-lane
// padding of bins and mels does not carry over: nb, n_mel and T are masked
// here, and the output is written in the public (B, n_mel, T) layout.
//
// Bound. The least work for this function is a real FFT, the magnitudes and
// the filterbank's nonzeros: about 2.5*n_fft*log2(n_fft) + 3*nb + 2*nnz(mel_w)
// operations a frame (about 29 kFLOP at n_fft = 1024, n_mel = 80), against
// 4*hop bytes of new waveform and 4*n_mel bytes of output. For 8 x 10 s of
// 22 kHz audio that is about 3 us by either count (67 TFLOP/s float32,
// 3.35 TB/s on an H100 SXM), so the function is bound by bytes and
// operations alike. This kernel does the DFT as a dense product, as the TPU
// kernel does on its matrix unit: 2*n_fft*2*nb operations a frame (2.1 MFLOP,
// 73x the FFT's), in float32 FMAs (no TF32, so no tensor cores). It is far
// from the bound by design; a real FFT in the block is later work.
//
// Design (right and simple first). One block of 256 threads owns TF = 8
// consecutive frames of one row b, so one utterance (B = 1, ~500 frames)
// launches ~63 blocks:
//  * frames by address: the (TF-1)*hop + n_fft samples that the TF frames
//    cover are staged once in shared memory, and frame f is read at offset
//    f*hop, so no (B, T, n_fft) frame tensor is ever written;
//  * the bins go in chunks of KB = 512: for each chunk a loop over n_fft
//    stages NC rows of the cos and sin basis in shared memory, and each thread
//    keeps RF frames x RB bins of re and im in registers, re and im of a bin
//    in the same thread (RB bins strided by the thread's lane, so the basis
//    reads are free of bank conflicts; the frame reads are broadcasts);
//  * the chunk's magnitudes go to shared memory, and each thread adds the
//    chunk's share to its mel sums (registers) in bin order; the bins left
//    over after the last full chunk (the Nyquist bin at n_fft = 1024) are
//    done by one warp a (frame, bin) with a shuffle reduction.
// So the spectrum never leaves shared memory, which is what the TPU kernel
// keeps out of HBM. Every sum runs in a fixed order, with no atomics, so the
// output is deterministic. Each block reads the whole basis (4.2 MB at
// n_fft = 1024) from L2, with a barrier a stage and no overlap of loads and
// FMAs: that, not the HBM, is what this design's time is made of.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMel = 128;
constexpr int kMaxSmem = 232448;  // a block's shared memory on Hopper
constexpr int kMaxDevices = 64;

// The tile: TF frames a block; each thread holds RF frames x RB bins of re
// and im; NC basis rows are staged a step.
constexpr int TF = 8, RF = 8, RB = 2, NC = 8;
constexpr int TY = TF / RF;         // thread rows (frames)
constexpr int TX = kThreads / TY;   // thread columns (bins)
constexpr int KB = TX * RB;         // bins in a chunk
constexpr int MS = KB + 1;          // magnitude row stride
constexpr int kMelPer = (kMaxMel * TF + kThreads - 1) / kThreads;
static_assert(TF % RF == 0 && kThreads % TY == 0, "tile shape");
static_assert(TX % 32 == 0, "a warp shares one thread row");

size_t smem_bytes(int n_fft, int hop) {
  return sizeof(float) * (2 * (size_t)NC * KB + (size_t)TF * MS +
                          (size_t)(TF - 1) * hop + n_fft);
}

__global__ void __launch_bounds__(kThreads, 2)
    mel_kernel(const float* __restrict__ yp, const float* __restrict__ basis,
               const float* __restrict__ mel_w, float* __restrict__ out,
               int S, int T, int n_fft, int hop, int nb, int n_mel) {
  extern __shared__ float smem[];
  float* cos_s = smem;            // (NC, KB)
  float* sin_s = cos_s + NC * KB;  // (NC, KB)
  float* mag_s = sin_s + NC * KB;  // (TF, MS)
  float* samp = mag_s + TF * MS;  // (TF - 1) * hop + n_fft samples

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int b = blockIdx.y, t0 = blockIdx.x * TF;
  const int nf = min(TF, T - t0);  // frames of this tile inside T
  const int ldb = 2 * nb;

  // Stage the tile's samples; past the end of yp (frames beyond T) read 0.
  {
    const int span = (TF - 1) * hop + n_fft;
    const long long start = (long long)t0 * hop;
    const float* y = yp + (size_t)b * S + start;
    const long long avail = (long long)S - start;
    for (int i = tid; i < span; i += kThreads)
      samp[i] = i < avail ? y[i] : 0.f;
  }

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
      for (int p = warp; p < TF * kc; p += kThreads / 32) {
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

    // This chunk's share of the mel sums, in bin order. Output o = m*TF + f:
    // neighbouring threads take neighbouring frames (conflict-free mag_s
    // rows, broadcast mel_w reads, coalesced stores below).
#pragma unroll
    for (int j = 0; j < kMelPer; ++j) {
      const int o = tid + j * kThreads;
      if (o < n_mel * TF) {
        const int m = o / TF, f = o % TF;
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
    if (o < n_mel * TF) {
      const int m = o / TF, f = o % TF;
      if (f < nf)
        out[((size_t)b * n_mel + m) * T + t0 + f] = logf(fmaxf(macc[j], 1e-5f));
    }
  }
}

int launch(const float* yp, const float* basis, const float* mel_w, float* out,
           int B, int S, int T, int n_fft, int hop, int nb, int n_mel,
           cudaStream_t stream) {
  if (n_fft % NC != 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(n_fft, hop);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  // Raise the dynamic shared-memory cap once per device and size (not
  // during a CUDA graph capture, which a warm-up call precedes).
  static std::atomic<size_t> cap[kMaxDevices];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (smem > 48 * 1024 && smem > cap[dev].load()) {
    e = cudaFuncSetAttribute(mel_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
    cap[dev].store(smem);
  }
  const dim3 grid((T + TF - 1) / TF, B);
  mel_kernel<<<grid, kThreads, smem, stream>>>(yp, basis, mel_w, out, S, T,
                                               n_fft, hop, nb, n_mel);
  return (int)cudaGetLastError();
}

}  // namespace

// All tensors float32, contiguous, on the current device: yp (B, S),
// basis (n_fft, 2*nb), mel_w (nb, n_mel), out (B, n_mel, T) with
// T = (S - n_fft) / hop + 1. Returns cudaGetLastError() after the launch
// (0 = success).
extern "C" int mel_launch(const void* yp, const void* basis, const void* mel_w,
                          void* out, int B, int S, int T, int n_fft, int hop,
                          int nb, int n_mel, void* stream) {
  if (B < 1 || T < 1 || n_fft < 1 || hop < 1 || nb < 1 || n_mel < 1 ||
      n_mel > kMaxMel || (long long)(T - 1) * hop + n_fft > S)
    return (int)cudaErrorInvalidValue;
  return launch(static_cast<const float*>(yp),
                static_cast<const float*>(basis),
                static_cast<const float*>(mel_w), static_cast<float*>(out), B,
                S, T, n_fft, hop, nb, n_mel, static_cast<cudaStream_t>(stream));
}

extern "C" const char* mel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Int8 weight-streaming matmul for the decoder's recurrence matrices.
//
// Replaces the TPU kernel gantron_tpu/ops/quant.py::_qmm_kernel (launched by
// qmatmul_pallas). Same function:
//     y[b, o] = (sum_i x[b, i] * float(q[i, o])) * scale[o]
// x is (B, I) float32 or bfloat16, q is (I, O) int8 (per-output-channel
// symmetric), scale is (O,) float32, y is (B, O) in x's type. The products
// are summed in float32 and the scale is applied after the sum, as the TPU
// kernel does. It is not a block-for-block copy: any B >= 1, I >= 1 and O >= 1
// are taken and the ragged edges are masked here, so the TPU kernel's
// 128-lane tile restriction (quant.py _pick_block_o) does not carry over.
//
// Bound. On the decode path B is the serving batch (1 to 8) and the work is
// I*O multiply-adds per row of x against I*O bytes of weights: the kernel is
// bound by bytes, I*O + 4*O + size(x) + size(y), at 3.35 TB/s on an H100 SXM
// about 1.25 us for a (1024, 4096) matrix. The four matrices of one decoder
// step hold 21 MB of int8, which fits the 50 MB L2, so steady-state decode
// reads them from L2 and can beat that bound.
//
// Design (simple first; wgmma, TMA and split-K across blocks are later work).
// A block owns 32 output columns and all of I. Its threads are 8 column
// threads x R row lanes (R = 128 with 1024 threads): a thread reads 4 adjacent
// int8 columns (one 4-byte load) of every R-th row of q, so the 8 column
// threads of a row read its 32 neighbouring bytes, and reads the matching x
// values straight from global memory (x is a few KB and stays in L1). At
// I = 1024 a thread has 8 rows, all of whose loads can be in flight at once:
// the kernel waits about one memory latency instead of one per row. A block
// takes kB rows of x (1, 2, 4 or 8, the least power of two >= B, capped at 8;
// larger B adds block rows, which re-read q from L2) and keeps kB x 4 float32
// sums in registers. The R row lanes are summed in a fixed order (warp
// shuffles over the 4 row lanes of a warp, then the warp partials through
// shared memory), so results are deterministic: there is no atomicAdd across
// blocks. At O = 4096 the grid is 128 blocks, one on each of 128 of the
// card's 132 SMs, of 32 warps (B <= 2) or 16 (B > 2).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;                            // output columns per block
constexpr int kColsPerThread = 4;                    // one char4 load
constexpr int kColThreads = kCols / kColsPerThread;  // 8

static_assert(32 / kColThreads == 4, "warp reduction below sums 4 row lanes");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// kVec: O % 4 == 0, so a thread's 4 columns are 4-byte aligned and either all
// inside O or all outside it.
template <typename T, int kB, int kThreads, bool kVec>
__global__ void __launch_bounds__(kThreads)
    qmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, T* __restrict__ y, int B,
               int I, int O) {
  constexpr int kRowLanes = kThreads / kColThreads;
  constexpr int kWarps = kThreads / 32;
  __shared__ float part[kWarps][kB][kCols];

  const int tid = threadIdx.x;
  const int cg = tid % kColThreads;
  const int lane_row = tid / kColThreads;
  const int col0 = blockIdx.x * kCols + cg * kColsPerThread;
  const int b0 = blockIdx.y * kB;
  const int nb = min(kB, B - b0);  // rows of x in this block's tile
  const T* xb = x + (size_t)b0 * I;

  float acc[kB][kColsPerThread];
#pragma unroll
  for (int b = 0; b < kB; ++b)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) acc[b][j] = 0.f;

#pragma unroll 8
  for (int i = lane_row; i < I; i += kRowLanes) {
    const int8_t* row = q + (size_t)i * O;
    float w[kColsPerThread];
    if (kVec) {
      char4 v = make_char4(0, 0, 0, 0);
      if (col0 < O) v = *reinterpret_cast<const char4*>(row + col0);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        w[j] = (col0 + j < O) ? (float)row[col0 + j] : 0.f;
    }
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      const float xv = b < nb ? to_float(xb[(size_t)b * I + i]) : 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        acc[b][j] = fmaf(xv, w[j], acc[b][j]);
    }
  }

  // The 4 row lanes of a warp that share a column group sit 8 lanes apart.
#pragma unroll
  for (int b = 0; b < kB; ++b)
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      float v = acc[b][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[b][j] = v;
    }
  const int warp = tid / 32, lane = tid % 32;
  if (lane < kColThreads) {
#pragma unroll
    for (int b = 0; b < kB; ++b)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j)
        part[warp][b][lane * kColsPerThread + j] = acc[b][j];
  }
  __syncthreads();

  if (tid < kB * kCols) {
    const int b = tid / kCols, c = tid % kCols;
    const int col = blockIdx.x * kCols + c;
    if (b < nb && col < O) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += part[w][b][c];
      store(y + (size_t)(b0 + b) * O + col, s * scale[col]);
    }
  }
}

template <typename T, int kB, int kThreads>
void launch(const void* x, const void* q, const void* scale, void* y, int B,
            int I, int O, cudaStream_t stream) {
  const dim3 grid((O + kCols - 1) / kCols, (B + kB - 1) / kB);
  const T* xp = static_cast<const T*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  T* yp = static_cast<T*>(y);
  if (O % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 4 == 0)
    qmm_kernel<T, kB, kThreads, true>
        <<<grid, kThreads, 0, stream>>>(xp, qp, sp, yp, B, I, O);
  else
    qmm_kernel<T, kB, kThreads, false>
        <<<grid, kThreads, 0, stream>>>(xp, qp, sp, yp, B, I, O);
}

// 1024 threads hold 64 registers each, enough for kB <= 2; kB = 4 and 8 take
// 512 threads (64 row lanes) so that their kB x 4 sums stay in registers.
template <typename T>
void launch_batch(const void* x, const void* q, const void* scale, void* y,
                  int B, int I, int O, cudaStream_t stream) {
  if (B == 1)
    launch<T, 1, 1024>(x, q, scale, y, B, I, O, stream);
  else if (B == 2)
    launch<T, 2, 1024>(x, q, scale, y, B, I, O, stream);
  else if (B <= 4)
    launch<T, 4, 512>(x, q, scale, y, B, I, O, stream);
  else
    launch<T, 8, 512>(x, q, scale, y, B, I, O, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y). All tensors contiguous on the
// current device. Returns cudaGetLastError() after the launch (0 = success).
extern "C" int qmm_launch(const void* x, const void* q, const void* scale,
                          void* y, int B, int I, int O, int dtype,
                          void* stream) {
  if (B < 1 || I < 1 || O < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    launch_batch<float>(x, q, scale, y, B, I, O, s);
  else
    launch_batch<__nv_bfloat16>(x, q, scale, y, B, I, O, s);
  return (int)cudaGetLastError();
}

extern "C" const char* qmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

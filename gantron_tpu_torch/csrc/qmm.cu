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
// reads them from L2 and can beat that bound. What stands between the kernel
// and the bytes is issue work per weight: widening int8 to float32 with the
// conversion instruction (I2F) runs at 16 a clock on an SM, an eighth of the
// FMA rate, so at B = 1 it costs more than moving the bytes, and at B = 8 a
// thread that reads 4 bytes of q issues as many loads of x as of q.
//
// Design. A block of 256 threads owns 32 output columns and all of I, so
// O = 4096 gives 128 blocks, one on each of 128 of the card's 132 SMs.
//  * q: a thread reads 16 int8 columns of a row in one 16-byte load; the two
//    column threads of a row read its 32 neighbouring bytes. A thread takes
//    four consecutive rows of every 512 and loads the next four rows' q (and
//    x, for kB <= 4) before it sums the current four.
//  * widening without I2F: a byte v becomes the float 2^23 + (v + 128) by a
//    byte permute (v ^ 0x80 placed under the exponent of 2^23), and one
//    exact float subtraction of 2^23 + 128 gives v: a PRMT and an FADD per
//    weight instead of an I2F.
//  * x: kB rows of x (1, 2, 4 or 8, the least power of two >= B, capped at
//    8) are read through L1 with the rows of q they multiply, the four
//    values of a thread's four rows in one load where I % 4 == 0. Staging x in
//    shared memory first was tried and was slower at every B: the barrier
//    after the staging put a second memory round trip in front of the sums.
//    A larger B loops over tiles of 8 rows inside the block, which re-reads
//    its 32 columns of q from L1 or L2 instead of launching a wave of blocks
//    per tile.
//  * sums: each thread keeps kB x 16 float32 sums in registers, rows in
//    increasing order. The 16 row lanes of a warp are reduced by recursive
//    halving (15 shuffles a row of x: after it each lane holds one column's
//    sum), then the 8 warps' partials are added in warp order through shared
//    memory, with the column's scale loaded at the start. The order is fixed
//    and there is no atomicAdd across blocks, so a second launch on the same
//    input is bit-equal to the first.
// A split of I across the blocks of a cluster was not taken: with 128 blocks
// the grid already holds one block an SM, so splitting adds a reduction
// across blocks without adding SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;                            // output columns per block
constexpr int kColsPerThread = 16;                   // one 16-byte load
constexpr int kColThreads = kCols / kColsPerThread;  // 2
constexpr int kThreads = 256;                        // 128 row lanes
constexpr int kGroup = 4;                            // rows of q in flight

static_assert(kColThreads == 2, "the warp reduction halves over lane bits 1-4");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// The 4 int8 of a word, widened exactly: 2^23 + (v + 128) - (2^23 + 128).
__device__ __forceinline__ void widen4(uint32_t word, float (&w)[4]) {
  const uint32_t u = word ^ 0x80808080u;
  w[0] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) - 8388736.f;
  w[1] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) - 8388736.f;
  w[2] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) - 8388736.f;
  w[3] = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) - 8388736.f;
}

// 16 columns of row i from col0 on; 0 outside I x O. kVec: O % 16 == 0 and q
// 16-byte aligned, so the 16 columns are one aligned load, all inside O or
// all outside it.
template <bool kVec>
__device__ __forceinline__ uint4 load_row(const int8_t* __restrict__ q, int i,
                                          int I, int O, int col0) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (i >= I || col0 >= O) return v;
  const int8_t* row = q + (size_t)i * O + col0;
  if (kVec) return __ldg(reinterpret_cast<const uint4*>(row));
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j)
    if (col0 + j < O) w[j / 4] |= (uint32_t)(uint8_t)row[j] << (8 * (j % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// x[i .. i + kN) of one row of x as float32, 0 past I or for a row past B.
// xvec: I is a multiple of 4 and x is 16-byte aligned, so 4 elements at a
// multiple of 4 are one aligned load (16 bytes of float32, 8 of bf16), all
// inside I or all outside it.
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
  v[0] = __uint_as_float(w.x << 16);  // bf16 is float32's top half
  v[1] = __uint_as_float(w.x & 0xffff0000u);
  v[2] = __uint_as_float(w.y << 16);
  v[3] = __uint_as_float(w.y & 0xffff0000u);
}

template <int kN, typename T>
__device__ __forceinline__ void load_x(const T* __restrict__ row, int i, int I,
                                       bool in_batch, bool xvec,
                                       float (&v)[kN]) {
  static_assert(kN % 4 == 0, "rows come in fours");
  if (in_batch && xvec) {
#pragma unroll
    for (int u = 0; u < kN; u += 4) {
      float f[4] = {0.f, 0.f, 0.f, 0.f};
      if (i + u < I) load4(row + i + u, f);
#pragma unroll
      for (int k = 0; k < 4; ++k) v[u + k] = f[k];
    }
  } else {
#pragma unroll
    for (int u = 0; u < kN; ++u)
      v[u] = in_batch && i + u < I ? to_float(row[i + u]) : 0.f;
  }
}

// acc[b][c0 + j] += x[b] * w[j] for the 4 weights of one word of q.
template <int kB>
__device__ __forceinline__ void fma_row(uint32_t word, int c0,
                                        const float (&xv)[kB],
                                        float (&acc)[kB][kColsPerThread]) {
  float w[4];
  widen4(word, w);
#pragma unroll
  for (int b = 0; b < kB; ++b)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[b][c0 + j] = fmaf(xv[b], w[j], acc[b][c0 + j]);
}

// One step of the recursive halving over lane bit 2*kHalf: the lower lane
// keeps columns [0, kHalf), the upper lane [kHalf, 2*kHalf), each adding
// its partner's. The selects take values, not lvalues: `c ? v[j] : v[k]`
// selects an address and moves v to local memory.
template <int kHalf>
__device__ __forceinline__ void halve(float (&v)[kColsPerThread], int lane) {
  const bool upper = lane & (2 * kHalf);
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const float lo = v[j], hi = v[j + kHalf];
    const float keep = upper ? hi : lo;
    const float send = upper ? lo : hi;
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * kHalf);
  }
}

template <typename T, int kB, bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    qmm_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
               const float* __restrict__ scale, T* __restrict__ y, int B,
               int I, int O, bool xvec) {
  constexpr int kRowLanes = kThreads / kColThreads;
  constexpr int kWarps = kThreads / 32;
  __shared__ float part[kWarps][kB][kCols];

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int cg = tid % kColThreads;
  const int lane_row = tid / kColThreads;
  const int col0 = blockIdx.x * kCols + cg * kColsPerThread;
  // The output column of this thread in the final sum, and its scale, read
  // now so that the epilogue waits for no load.
  const int oc = blockIdx.x * kCols + tid % kCols;
  const float sc = tid < kB * kCols && oc < O ? __ldg(scale + oc) : 0.f;

  for (int b0 = 0; b0 < B; b0 += kB) {  // batch tiles, one after the other
    const int nb = min(kB, B - b0);     // rows of x in this tile
    float acc[kB][kColsPerThread];
#pragma unroll
    for (int b = 0; b < kB; ++b)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[b][j] = 0.f;

    // A thread takes kGroup consecutive rows, i = i0 + kGroup * lane_row +
    // u, of every kGroup * kRowLanes; the next group's q is loaded before
    // the current group's sums, and so is its x where the sums leave
    // registers for it (kB <= 4; at kB = 8 a second copy of x would spill).
    constexpr bool kPrefetchX = kB <= 4;
    constexpr int kStep = kGroup * kRowLanes;
    uint4 next[kGroup];
    float xnext[kB][kGroup];
    auto load_q = [&](int i) {
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        next[u] = load_row<kVec>(q, i + u, I, O, col0);
    };
    auto load_xs = [&](int i, float (&xs)[kB][kGroup]) {
#pragma unroll
      for (int b = 0; b < kB; ++b)
        load_x<kGroup>(x + (size_t)(b0 + b) * I, i, I, b < nb, xvec, xs[b]);
    };
    load_q(kGroup * lane_row);
    if constexpr (kPrefetchX) load_xs(kGroup * lane_row, xnext);
    for (int i = kGroup * lane_row; i < I; i += kStep) {
      uint4 cur[kGroup];
      float xcur[kB][kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) cur[u] = next[u];
      if constexpr (kPrefetchX) {
#pragma unroll
        for (int b = 0; b < kB; ++b)
#pragma unroll
          for (int u = 0; u < kGroup; ++u) xcur[b][u] = xnext[b][u];
      }
      if (i + kStep < I) {
        load_q(i + kStep);
        if constexpr (kPrefetchX) load_xs(i + kStep, xnext);
      }
      if constexpr (!kPrefetchX) load_xs(i, xcur);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        float xv[kB];
#pragma unroll
        for (int b = 0; b < kB; ++b) xv[b] = xcur[b][u];
        fma_row<kB>(cur[u].x, 0, xv, acc);
        fma_row<kB>(cur[u].y, 4, xv, acc);
        fma_row<kB>(cur[u].z, 8, xv, acc);
        fma_row<kB>(cur[u].w, 12, xv, acc);
      }
    }

    // The 16 row lanes of a warp (lane bits 1-4; bit 0 is the column
    // thread): recursive halving leaves lane l with the sum of column
    // cg*16 + (l >> 1); then the warps' partials in warp order.
#pragma unroll
    for (int b = 0; b < kB; ++b) {
      halve<8>(acc[b], lane);
      halve<4>(acc[b], lane);
      halve<2>(acc[b], lane);
      halve<1>(acc[b], lane);
    }
    if (b0 > 0) __syncthreads();  // the last tile's partials are read
    const int col = cg * kColsPerThread + (lane >> 1);
#pragma unroll
    for (int b = 0; b < kB; ++b) part[warp][b][col] = acc[b][0];
    __syncthreads();

    if (tid < kB * kCols) {
      const int b = tid / kCols, c = tid % kCols;
      if (b < nb && oc < O) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += part[w][b][c];
        store(y + (size_t)(b0 + b) * O + oc, s * sc);
      }
    }
  }
}

template <typename T, int kB>
cudaError_t launch(const void* x, const void* q, const void* scale, void* y,
                   int B, int I, int O, cudaStream_t stream) {
  const dim3 grid((O + kCols - 1) / kCols);
  const T* xp = static_cast<const T*>(x);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  T* yp = static_cast<T*>(y);
  const bool xvec = I % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (O % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0)
    qmm_kernel<T, kB, true><<<grid, kThreads, 0, stream>>>(xp, qp, sp, yp, B,
                                                          I, O, xvec);
  else
    qmm_kernel<T, kB, false><<<grid, kThreads, 0, stream>>>(xp, qp, sp, yp,
                                                           B, I, O, xvec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_batch(const void* x, const void* q, const void* scale,
                         void* y, int B, int I, int O, cudaStream_t stream) {
  if (B == 1) return launch<T, 1>(x, q, scale, y, B, I, O, stream);
  if (B == 2) return launch<T, 2>(x, q, scale, y, B, I, O, stream);
  if (B <= 4) return launch<T, 4>(x, q, scale, y, B, I, O, stream);
  return launch<T, 8>(x, q, scale, y, B, I, O, stream);
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
    return (int)launch_batch<float>(x, q, scale, y, B, I, O, s);
  return (int)launch_batch<__nv_bfloat16>(x, q, scale, y, B, I, O, s);
}

extern "C" const char* qmm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

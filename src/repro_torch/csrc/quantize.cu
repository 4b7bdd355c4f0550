// Row-wise symmetric int8 quantize / dequantize for the DFL wire payload.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/quantize/quantize.py:
// `quantize` (body `_q_kernel`) and `dequantize` (body `_dq_kernel`).
//
// quantize, per row of x (R, C), C <= 256, fp32 or bf16:
//   absmax = max |x|
//   scale  = fp32(bf16_rn(max(absmax / 127, 1e-12)))   (the bf16 wire grid)
//   q      = clamp(rint(x / scale), -127, 127) as int8
// dequantize: out = float(q) * scale[row] in fp32.
//
// Bitwise contract: both kernels equal the plain PyTorch versions in
// repro_torch/kernels/quantize/ref.py (and so the JAX package's
// core/compression.py) for q, scales and outputs. What that takes here:
// the max is order-free, so the warp-shuffle reduction is exact; the two
// divisions are IEEE round-to-nearest (__fdiv_rn; never --use_fast_math);
// round-half-to-even is rintf (roundf rounds half away from zero); the bf16
// cast is __float2bfloat16_rn. NaN inputs are outside the contract: fmaxf
// drops a NaN from the absmax where jnp.maximum would keep it.
//
// Bound on the card: bytes. Per element quantize reads 4 (or 2) bytes and
// writes 1; dequantize reads 1 and writes 4; the arithmetic is a few
// operations per element. The design keeps each row's values in registers
// between the absmax and the quantize pass (one read of x), gives a row to
// one warp so the reduction needs no shared memory or barrier, and lays a
// warp's loads on consecutive addresses (lane + 32 k). At the main path's
// shapes (LeNet leaves, at most 784 x 120) a launch moves under 0.5 MB, so
// launch overhead, not bandwidth, sets the time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxCols = 256;
constexpr int kPerLane = kMaxCols / 32;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void quantize_rows_kernel(const T* __restrict__ x,
                                     int8_t* __restrict__ q,
                                     float* __restrict__ scales,
                                     long long rows, int cols) {
  const int lane = threadIdx.x & 31;
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform: one row per warp
  const T* xr = x + row * cols;
  float v[kPerLane];
  float absmax = 0.f;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = lane + 32 * k;
    v[k] = c < cols ? load_f32(xr + c) : 0.f;
    absmax = fmaxf(absmax, fabsf(v[k]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    absmax = fmaxf(absmax, __shfl_xor_sync(0xffffffffu, absmax, off));
  const float scale = __bfloat162float(
      __float2bfloat16_rn(fmaxf(__fdiv_rn(absmax, 127.f), 1e-12f)));
  int8_t* qr = q + row * cols;
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    const int c = lane + 32 * k;
    if (c < cols) {
      const float r = rintf(__fdiv_rn(v[k], scale));
      qr[c] = (int8_t)fminf(fmaxf(r, -127.f), 127.f);
    }
  }
  if (lane == 0) scales[row] = scale;
}

__global__ void dequantize_rows_kernel(const int8_t* __restrict__ q,
                                       const float* __restrict__ scales,
                                       float* __restrict__ out, long long rows,
                                       int cols) {
  const long long total = rows * (long long)cols;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    out[i] = (float)q[i] * scales[i / cols];
  }
}

template <typename T>
int launch_quantize(const void* x, void* q, void* scales, long long rows,
                    int cols, void* stream) {
  if (rows < 0 || cols < 1 || cols > kMaxCols) return (int)cudaErrorInvalidValue;
  if (rows == 0) return (int)cudaSuccess;
  const long long blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  quantize_rows_kernel<T><<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
                            (cudaStream_t)stream>>>(
      (const T*)x, (int8_t*)q, (float*)scales, rows, cols);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int quantize_rows_f32(const void* x, void* q, void* scales, long long rows,
                      int cols, void* stream) {
  return launch_quantize<float>(x, q, scales, rows, cols, stream);
}

int quantize_rows_bf16(const void* x, void* q, void* scales, long long rows,
                       int cols, void* stream) {
  return launch_quantize<__nv_bfloat16>(x, q, scales, rows, cols, stream);
}

int dequantize_rows_f32(const void* q, const void* scales, void* out,
                        long long rows, int cols, void* stream) {
  if (rows < 0 || cols < 1) return (int)cudaErrorInvalidValue;
  const long long total = rows * (long long)cols;
  if (total == 0) return (int)cudaSuccess;
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond 64 waves
  dequantize_rows_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const int8_t*)q, (const float*)scales, (float*)out, rows, cols);
  return (int)cudaGetLastError();
}

}  // extern "C"

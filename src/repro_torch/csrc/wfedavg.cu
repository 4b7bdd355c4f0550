// Fused reputation-weighted FedAvg (paper Eq. 3) on a flat parameter block:
//   out[d] = 0.5 * (sum_n wn[n] * models[n, d] + prev[d])     (fp32 throughout)
//
// Replaces the Pallas TPU kernel in src/repro/kernels/wfedavg/wfedavg.py:
// `wfedavg_flat` (body `_kernel`).
//
// Bound on the card: bytes. It reads the N stacked models and prev once and
// writes out once, (N + 2) * D * 4 bytes, for 2 N + 2 operations per
// column. Each thread owns columns and loops over the N models, keeping
// the sum in a register, so nothing but the inputs and the output touches
// device memory; neighbouring threads read neighbouring columns of each
// model row, so every load is coalesced. Where D is a multiple of 4 and the
// pointers are 16-byte aligned, a thread owns 4 columns and moves them with
// one 16-byte load or store; otherwise one column per thread. The grid
// covers D exactly and masks its ragged edge, so the caller pads nothing
// (the TPU version padded D to 2048-column tiles). The sum runs n = 0..N-1
// in that order with fused multiply-adds, which differs from XLA's order:
// it is held to its plain version at rtol/atol 1e-6.
//
// At the main path's shapes (N = 10, D = 94 080 for LeNet's f1.w and 10 080
// for f2.w) a launch moves 0.5-4.5 MB, about 0.1-1.4 us at 3.35 TB/s, so
// launch overhead is of the same order as the transfer.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__global__ void wfedavg_vec4_kernel(const float4* __restrict__ models,
                                    const float* __restrict__ wn,
                                    const float4* __restrict__ prev,
                                    float4* __restrict__ out, int n,
                                    long long d4) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d4) return;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = 0; i < n; ++i) {
    const float w = __ldg(wn + i);
    const float4 m = __ldg(models + (long long)i * d4 + j);
    acc.x = fmaf(w, m.x, acc.x);
    acc.y = fmaf(w, m.y, acc.y);
    acc.z = fmaf(w, m.z, acc.z);
    acc.w = fmaf(w, m.w, acc.w);
  }
  const float4 p = __ldg(prev + j);
  out[j] = make_float4(0.5f * (acc.x + p.x), 0.5f * (acc.y + p.y),
                       0.5f * (acc.z + p.z), 0.5f * (acc.w + p.w));
}

__global__ void wfedavg_scalar_kernel(const float* __restrict__ models,
                                      const float* __restrict__ wn,
                                      const float* __restrict__ prev,
                                      float* __restrict__ out, int n,
                                      long long d) {
  const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d) return;
  float acc = 0.f;
  for (int i = 0; i < n; ++i)
    acc = fmaf(__ldg(wn + i), __ldg(models + (long long)i * d + j), acc);
  out[j] = 0.5f * (acc + __ldg(prev + j));
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" int wfedavg_f32(const void* models, const void* wn,
                           const void* prev, void* out, int n, long long d,
                           void* stream) {
  if (n < 1 || d < 0) return (int)cudaErrorInvalidValue;
  if (d == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (d % 4 == 0 && aligned16(models) && aligned16(prev) && aligned16(out)) {
    const long long d4 = d / 4;
    const long long blocks = (d4 + kThreads - 1) / kThreads;
    wfedavg_vec4_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float4*)models, (const float*)wn, (const float4*)prev,
        (float4*)out, n, d4);
  } else {
    const long long blocks = (d + kThreads - 1) / kThreads;
    wfedavg_scalar_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float*)models, (const float*)wn, (const float*)prev,
        (float*)out, n, d);
  }
  return (int)cudaGetLastError();
}

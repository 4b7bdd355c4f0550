// The train step's clip and AdamW: the global gradient norm in one read of
// the grads, and the whole update of a leaf in one pass.
//
// Replaces no TPU kernel: the JAX package's optimizer is jnp
// (src/repro/optim/optimizers.py `adamw`, `clip_by_global_norm`), which XLA
// fuses. The port's plain version (repro_torch/kernels/adamw/ref.py) is one
// PyTorch op at a time: 16 kernels and 148 bytes a parameter for the update,
// 20 for the norm and the scaling, and two leaf-sized temporaries.
//
// grad_sumsq (norm and clip scale), per leaf then once:
//   partial[b] = sum over block b's grid-stride range of g * g      (fp32)
//   norm  = sqrt(sum of every partial)
//   scale = min(1, max_norm / max(norm, 1e-9))      (NaN passes, as clamp's)
// A block's threads keep four fp32 lanes (one a float of a 16-byte load),
// then the block sums its threads by warp shuffles and one shared row, in a
// fixed order; one final block sums the partials of every leaf in a fixed
// order and writes norm and scale to the card. No atomics and no host read:
// a call repeats itself bit for bit. The sum's order is not the plain
// version's (torch.sum a leaf, then leaf after leaf), so the norm agrees
// with it to round-off, not bitwise.
//
// adamw_step, per element, from the 0-d fp32 device tensors scale, lr, bc1
// and bc2 (the step's schedule and bias corrections, made by torch ops):
//   g' = g * scale
//   m  = m * b1 + (1 - b1) * g'
//   v  = v * b2 + (1 - b2) * (g' * g')
//   u  = (m / bc1) / (sqrt(v / bc2) + eps)
//   p  = p + (u + wd * p) * -lr
// m, v and p are written in place; g is only read. Every operation is the
// plain version's, in its order, each rounded once (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn: nvcc contracts none of them into an FMA), with the
// constants the fp32 casts of the same Python doubles. So m, v and p are
// bitwise the plain version's given the same scale.
//
// Bound on the card: bytes. The update reads g, m, v, p and writes m, v, p:
// 28 bytes for 17 operations an element; the norm reads g once, 4 bytes.
// Both use 16-byte loads and stores (cache-streaming: nothing is read
// twice) in a grid-stride loop over as many blocks as the card holds at
// once; a leaf whose pointers are not 16-byte aligned takes one float a
// load. A leaf's last numel % 4 elements are taken by the first threads.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // ops.py THREADS
constexpr int kFinalThreads = 1024;

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ void adamw_one(float g, float& m, float& v, float& p,
                                          float scale, float bc1, float bc2,
                                          float neg_lr, const Hyper& h) {
  const float gs = __fmul_rn(g, scale);
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.omb1, gs));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(h.omb2, __fmul_rn(gs, gs)));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), h.eps);
  float u = __fdiv_rn(__fdiv_rn(m, bc1), den);
  u = __fadd_rn(u, __fmul_rn(h.wd, p));
  u = __fmul_rn(u, neg_lr);
  p = __fadd_rn(p, u);
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
adamw_step_kernel(const float* __restrict__ g, float* __restrict__ m,
                  float* __restrict__ v, float* __restrict__ p, long long n,
                  const float* __restrict__ scale_p, const float* __restrict__ lr_p,
                  const float* __restrict__ bc1_p, const float* __restrict__ bc2_p,
                  Hyper h) {
  const float scale = __ldg(scale_p), bc1 = __ldg(bc1_p), bc2 = __ldg(bc2_p);
  const float neg_lr = -__ldg(lr_p);
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (kVec) {
    const long long n4 = n >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    float4* m4 = reinterpret_cast<float4*>(m);
    float4* v4 = reinterpret_cast<float4*>(v);
    float4* p4 = reinterpret_cast<float4*>(p);
    for (long long j = i; j < n4; j += stride) {
      const float4 gg = __ldcs(g4 + j);
      float4 mm = __ldcs(m4 + j), vv = __ldcs(v4 + j), pp = __ldcs(p4 + j);
      adamw_one(gg.x, mm.x, vv.x, pp.x, scale, bc1, bc2, neg_lr, h);
      adamw_one(gg.y, mm.y, vv.y, pp.y, scale, bc1, bc2, neg_lr, h);
      adamw_one(gg.z, mm.z, vv.z, pp.z, scale, bc1, bc2, neg_lr, h);
      adamw_one(gg.w, mm.w, vv.w, pp.w, scale, bc1, bc2, neg_lr, h);
      __stcs(m4 + j, mm);
      __stcs(v4 + j, vv);
      __stcs(p4 + j, pp);
    }
    const long long t = (n4 << 2) + i;
    if (t < n) adamw_one(g[t], m[t], v[t], p[t], scale, bc1, bc2, neg_lr, h);
  } else {
    for (long long j = i; j < n; j += stride)
      adamw_one(g[j], m[j], v[j], p[j], scale, bc1, bc2, neg_lr, h);
  }
}

// The block's sum of one value a thread, in a fixed order; thread 0 gets it.
template <int kBlock>
__device__ __forceinline__ float block_sum(float s) {
  __shared__ float warp_sums[kBlock / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < kBlock / 32 ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  }
  return s;
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
grad_sumsq_partial_kernel(const float* __restrict__ g, long long n,
                          float* __restrict__ partial) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (kVec) {
    const long long n4 = n >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(g);
#pragma unroll 4
    for (long long j = i; j < n4; j += stride) {
      const float4 x = __ldcs(g4 + j);
      acc.x = fmaf(x.x, x.x, acc.x);
      acc.y = fmaf(x.y, x.y, acc.y);
      acc.z = fmaf(x.z, x.z, acc.z);
      acc.w = fmaf(x.w, x.w, acc.w);
    }
    const long long t = (n4 << 2) + i;
    if (t < n) acc.x = fmaf(g[t], g[t], acc.x);
  } else {
    for (long long j = i; j < n; j += stride) acc.x = fmaf(g[j], g[j], acc.x);
  }
  const float s = block_sum<kThreads>((acc.x + acc.y) + (acc.z + acc.w));
  if (threadIdx.x == 0) partial[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kFinalThreads)
grad_sumsq_final_kernel(const float* __restrict__ partial, int count, float max_norm,
                        float* __restrict__ out) {
  float s = 0.f;
  for (int j = threadIdx.x; j < count; j += kFinalThreads) s += partial[j];
  s = block_sum<kFinalThreads>(s);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(s);
    const float den = isnan(norm) ? norm : fmaxf(norm, 1e-9f);
    const float q = __fdiv_rn(max_norm, den);
    out[0] = norm;
    out[1] = isnan(q) ? q : fminf(q, 1.f);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// Blocks of kThreads the card holds at once for `kernel`.
int resident_blocks(const void* kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return sms * (per_sm > 0 ? per_sm : 1);
}

}  // namespace

extern "C" int adamw_step_f32(const void* g, void* m, void* v, void* p, long long n,
                              const void* scale, const void* lr, const void* bc1,
                              const void* bc2, float b1, float omb1, float b2, float omb2,
                              float eps, float wd, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  const bool vec = aligned16(g) && aligned16(m) && aligned16(v) && aligned16(p);
  static const int cap_vec = resident_blocks((const void*)adamw_step_kernel<true>);
  static const int cap_one = resident_blocks((const void*)adamw_step_kernel<false>);
  const long long work = vec ? (n >> 2) : n;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;                  // n < 4: the tail alone
  const long long cap = vec ? cap_vec : cap_one;
  if (blocks > cap) blocks = cap;
  const float *sc = (const float*)scale, *l = (const float*)lr;
  const float *c1 = (const float*)bc1, *c2 = (const float*)bc2;
  if (vec)
    adamw_step_kernel<true><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float*)g, (float*)m, (float*)v, (float*)p, n, sc, l, c1, c2, h);
  else
    adamw_step_kernel<false><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float*)g, (float*)m, (float*)v, (float*)p, n, sc, l, c1, c2, h);
  return (int)cudaGetLastError();
}

// One leaf's partial sums: `blocks` blocks (ops.py sumsq_blocks) write
// partial[0, blocks).
extern "C" int grad_sumsq_partial_f32(const void* g, long long n, void* partial,
                                      int blocks, void* stream) {
  if (n < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (aligned16(g))
    grad_sumsq_partial_kernel<true><<<blocks, kThreads, 0, s>>>((const float*)g, n,
                                                                (float*)partial);
  else
    grad_sumsq_partial_kernel<false><<<blocks, kThreads, 0, s>>>((const float*)g, n,
                                                                 (float*)partial);
  return (int)cudaGetLastError();
}

// The norm and the clip scale from `count` partial sums: out[0], out[1].
extern "C" int grad_sumsq_final_f32(const void* partial, int count, float max_norm,
                                    void* out, void* stream) {
  if (count < 0) return (int)cudaErrorInvalidValue;
  grad_sumsq_final_kernel<<<1, kFinalThreads, 0, (cudaStream_t)stream>>>(
      (const float*)partial, count, max_norm, (float*)out);
  return (int)cudaGetLastError();
}

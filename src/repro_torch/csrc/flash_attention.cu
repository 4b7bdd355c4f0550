// Flash-attention forward (online softmax), causal and/or sliding window:
//   o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h // G]) v[b, j, h // G]
// over the keys j that the mask keeps (causal: j <= i; window w: j > i - w;
// and j < Skv), with G = H / KH query heads per kv head.
//
// Replaces the Pallas TPU kernel in
// src/repro/kernels/flash_attention/flash_attention.py: `flash_attention_fwd`
// (body `_kernel`). Same arithmetic: scores, the running max m, the
// denominator l and the output accumulator are fp32 whatever the input type
// (bf16 or fp32); masked scores are NEG_INF = -1e38; tiles wholly above the
// diagonal or below the window band are skipped; the output is acc / max(l,
// 1e-37) in q's type. What differs is what the TPU needed: the inputs stay
// in the model's layout, q (B, Sq, H, Dh) and k/v (B, Skv, KH, Dh) with
// arbitrary batch/sequence/head strides and a unit head-dim stride, so there
// is no transpose, no repeat of kv heads (head h reads kv head h / G) and no
// 128-lane pad; Sq and Skv are arbitrary and the ragged edge is masked here.
//
// Design: one block of 256 threads per (64-row query tile, b * H + h); the
// grid's y axis runs the query tiles last to first, so the longest causal
// rows start first. The Q tile stays in shared memory (fp32); each 64-key
// tile of K, then of V, passes through one shared fp32 buffer. Thread (ty,
// tx) of the 16 x 16 grid owns query rows 4 ty .. 4 ty + 3, score columns
// tx + 16 j (j < 4) and output columns tx + 16 c (c < NCH); a row's max and
// sum are reduced over the 16 lanes of its half-warp with shuffles. The head
// dim is padded with zeros to DP = 16 NCH, NCH in {1, 2, 4, 8, 16}. Shared
// rows have an odd stride, so column reads are free of bank conflicts.
//
// With a non-null `lse` (B, H, Sq) fp32, the kernel also writes each row's
// log-sum-exp m + log(max(l, 1e-37)) from its final running max and
// denominator (the JAX `_fwd_impl`'s formula), for the training backward;
// a row with no kept key has m = -1e38 and gets -1e38. Lane tx 0 of the
// row's half-warp writes it (every lane holds the reduced m and l).
//
// What bounds it on the card: operations. At the serving path's shape
// (B 4, S 4096, H 32, KH 8, Dh 128, bf16, causal) a call does 5.5e11 FLOP
// on 335 MB of inputs and output, 1600 FLOP a byte, far above the card's
// ~295 FLOP/byte balance, so the least time is the FLOPs over the bf16
// tensor-core peak (0.556 ms). This kernel does its FLOPs as fp32 FMAs on
// the CUDA cores (67 TFLOP/s peak, so >= 8.2 ms), with shared-memory reads
// (8 per 16 FMAs in Q.K, 12 per 32 in P.V) as the next limit. wgmma, TMA
// and bf16 P.V on the tensor cores are the redesign's work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLDP = kBK + 1;
constexpr float kNegInf = -1.0e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;     // (B, H, Sq), or null: not written
  int H, KH, Sq, Skv, Dh;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window;
  float scale;
};

template <int NCH>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         ((size_t)(kBQ + kBK) * (NCH * 16 + 1) + (size_t)kBQ * kLDP);
}

// rows [0, kBK) x cols [0, DP) of a (rows, Dh) slice into shared fp32,
// zero past n_rows and past Dh
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long row_stride, int row0,
                                          int n_rows, int dh) {
  constexpr int LDD = DP + 1;
  for (int idx = threadIdx.x; idx < kBK * DP; idx += kThreads) {
    const int r = idx / DP, d = idx % DP;
    const int gr = row0 + r;
    dst[r * LDD + d] =
        (gr < n_rows && d < dh) ? to_f32(src[gr * row_stride + d]) : 0.f;
  }
}

template <typename T, int NCH>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  constexpr int DP = NCH * 16;
  constexpr int LDD = DP + 1;
  static_assert(kBQ == kBK, "load_tile serves the Q tile too");
  extern __shared__ float smem[];
  float* Qs = smem;               // [kBQ][LDD]
  float* KVs = Qs + kBQ * LDD;    // [kBK][LDD]: K, then V, of one tile
  float* Ps = KVs + kBK * LDD;    // [kBQ][kLDP]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;

  const T* q = (const T*)p.q + b * p.q_sb + h * p.q_sh;
  const T* k = (const T*)p.k + b * p.k_sb + kvh * p.k_sh;
  const T* v = (const T*)p.v + b * p.v_sb + kvh * p.v_sh;
  T* o = (T*)p.o + b * p.o_sb + h * p.o_sh;

  load_tile<T, DP>(Qs, q, p.q_ss, q0, p.Sq, p.Dh);

  float m[4], l[4], acc[4][NCH];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NCH; ++c) acc[i][c] = 0.f;
  }

  // kv tiles that hold a kept key for some row of this query tile
  int t_lo = 0, t_hi = (p.Skv + kBK - 1) / kBK;
  if (p.causal) t_hi = min(t_hi, (q0 + kBQ - 1) / kBK + 1);
  if (p.window > 0) t_lo = max(0, q0 - p.window + 1) / kBK;

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's V (and, first, Q's stores) done
    load_tile<T, DP>(KVs, k, p.k_ss, k0, p.Skv, p.Dh);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float a[4], kk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * LDD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kk[j] = KVs[(tx + 16 * j) * LDD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        bool ok = kj < p.Skv;
        if (p.causal) ok = ok && kj <= qi;
        if (p.window > 0) ok = ok && kj > qi - p.window;
        s[i][j] = ok ? s[i][j] * p.scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = expf(s[i][j] - m_new);
        Ps[(ty * 4 + i) * kLDP + tx + 16 * j] = e;
        ps += e;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int c = 0; c < NCH; ++c) acc[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();  // every K read and P write done
    load_tile<T, DP>(KVs, v, p.v_ss, k0, p.Skv, p.Dh);
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float pj[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pj[i] = Ps[(ty * 4 + i) * kLDP + j];
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const float vv = KVs[j * LDD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pj[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= p.Sq) continue;
    const float li = fmaxf(l[i], 1e-37f);
    if (p.lse != nullptr && tx == 0)
      p.lse[(long long)blockIdx.x * p.Sq + qi] = m[i] + logf(li);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      const int d = tx + 16 * c;
      if (d < p.Dh) store(o + qi * p.o_ss + d, acc[i][c] / li);
    }
  }
}

template <typename T, int NCH>
int launch(const Params& p, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes<NCH>();
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, NCH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((unsigned)(batch * p.H), (unsigned)((p.Sq + kBQ - 1) / kBQ));
  flash_fwd_kernel<T, NCH><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, float* lse,
        int batch,
        int H, int KH, int Sq, int Skv, int Dh, long long q_sb, long long q_ss,
        long long q_sh, long long k_sb, long long k_ss, long long k_sh,
        long long v_sb, long long v_ss, long long v_sh, long long o_sb,
        long long o_ss, long long o_sh, int causal, int window, float scale,
        void* stream) {
  if (batch < 1 || H < 1 || KH < 1 || H % KH != 0 || Dh < 1 || Dh > 256 ||
      Sq < 1 || Skv < 1 || window < 0 ||
      (long long)batch * H > 0x7fffffffLL || (Sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  const Params p{q,    k,    v,    o,    lse,  H,    KH,   Sq,     Skv,    Dh,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,   v_ss,   v_sh,
                 o_sb, o_ss, o_sh, causal, window, scale};
  cudaStream_t s = (cudaStream_t)stream;
  const int nch = (Dh + 15) / 16;
  if (nch <= 1) return launch<T, 1>(p, batch, s);
  if (nch <= 2) return launch<T, 2>(p, batch, s);
  if (nch <= 4) return launch<T, 4>(p, batch, s);
  if (nch <= 8) return launch<T, 8>(p, batch, s);
  return launch<T, 16>(p, batch, s);
}

}  // namespace

#define FLASH_ENTRY(NAME, T)                                                  \
  extern "C" int NAME(const void* q, const void* k, const void* v, void* o,   \
                      void* lse, int batch, int H, int KH, int Sq, int Skv, int Dh,      \
                      long long q_sb, long long q_ss, long long q_sh,         \
                      long long k_sb, long long k_ss, long long k_sh,         \
                      long long v_sb, long long v_ss, long long v_sh,         \
                      long long o_sb, long long o_ss, long long o_sh,         \
                      int causal, int window, float scale, void* stream) {    \
    return run<T>(q, k, v, o, (float*)lse, batch, H, KH, Sq, Skv, Dh, q_sb, q_ss, q_sh,    \
                  k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,       \
                  causal, window, scale, stream);                             \
  }

FLASH_ENTRY(flash_attention_fwd_f32, float)
FLASH_ENTRY(flash_attention_fwd_bf16, __nv_bfloat16)

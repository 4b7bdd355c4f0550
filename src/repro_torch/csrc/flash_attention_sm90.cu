// Flash-attention forward for Hopper (sm_90a) in bf16, on the tensor cores:
//   o[b, i, h] = sum_j softmax_j(scale * q[b, i, h] . k[b, j, h // G]) v[b, j, h // G]
// over the keys j that the mask keeps (causal: j <= i; window w: j > i - w;
// and j < Skv), with G = H / KH query heads per kv head.
//
// Replaces the Pallas TPU kernel `flash_attention_fwd` (body `_kernel`) in
// src/repro/kernels/flash_attention/flash_attention.py:82 for bf16 inputs
// with a head dim of 64, 128 or 256; csrc/flash_attention.cu keeps fp32 and
// the other head dims (the wrapper routes by dtype, head dim, alignment and
// strides before any launch). Same function as flash_attention.cu: m and l
// in fp32, masked scores at -1e38, tiles wholly above the diagonal or below
// the window band skipped, output acc / max(l, 1e-37) in bf16, inputs in
// the model's layout q (B, Sq, H, Dh), k/v (B, Skv, KH, Dh) with their
// strides (no transpose, no repeat of kv heads, no pad).
//
// One numerical difference: p is rounded to bf16 before P.V (the A operand
// of wgmma is bf16). The JAX model's own forward does the same
// (src/repro/models/flash.py:286, `p.astype(v_blk.dtype)`); the Pallas
// kernel and the plain version keep p in fp32. l sums the fp32 p.
//
// With a non-null `lse` (B, H, Sq) fp32, each consumer also writes its
// rows' log-sum-exp after the last kv tile, from the m and l it holds in
// registers: m is in log2 units here, so lse = m ln 2 + log(max(l, 1e-37))
// (the JAX `_fwd_impl`'s m + log(max(l, 1e-37))), and -1e38 for a row with
// no kept key (m = -1e38), as the simt kernel writes. The lane with
// lane % 4 == 0 writes each of its two rows; nothing stays live longer.
//
// What bounds it: operations. At the serving path's shape (B 4, S 4096,
// H 32, KH 8, Dh 128, causal) a call does 5.50e11 FLOP on 335 MB, so the
// least time is the FLOPs over the bf16 tensor-core peak, 0.556 ms.
// The design puts both products on the tensor cores and keeps them fed:
//
// - Block: 384 threads, one per (128-row query tile, b * H + h), query
//   tiles longest first (the grid's y axis runs last to first). Warpgroup
//   0 is the producer: it gives up registers (setmaxnreg 40) and one thread
//   issues every TMA load. Warpgroups 1 and 2 are consumers (setmaxnreg
//   232), 64 query rows each.
// - Loads: Q once; K and V tiles by TMA into a ring of kStages = 2 shared
//   stages, each with a "full" barrier for K, one for V (the tx bytes of
//   the load) and an "empty" barrier that the 256 consumer threads arrive
//   on once their products have read the stage. The tensor maps are 4-D
//   (Dh, S, heads, B) with the model's strides, so rows past S are zero
//   filled within one (b, head) and never read the next batch row. TMA
//   writes with 128-byte swizzle in boxes of 64 columns (Dh 128 and 256
//   load as 2 and 4 boxes), the layout wgmma reads without bank conflicts.
// - S = Q.K^T: wgmma m64nBKk16, A (Q) and B (K) K-major from shared memory,
//   fp32 accumulator in registers.
// - Softmax in registers on exp2 with scale * log2(e) folded into the
//   scores; a row's max is reduced over the 4 lanes that hold it; l stays a
//   per-thread partial sum until the end. Only tiles that cross the
//   diagonal, the window's edge or Skv compute a mask.
// - O += P.V: the score accumulator, rounded to bf16 in pairs, is wgmma's
//   A-from-registers operand as it lies (see sm90.cuh); V is the B operand
//   read MN-major (transposed) from shared memory, so it is never
//   transposed in memory. O (64 x Dh fp32) stays in registers.
// - Tiles: BQ 128 x BK 128 for Dh 64 and 128 (160 KB of shared memory at
//   Dh 128: Q 32 KB + 2 stages x (K 32 + V 32) KB). For Dh 256 the O
//   accumulator alone takes 128 registers a thread and ptxas compiles the
//   consumers within the kernel's 168 (the launch bound of 384 threads):
//   BK 32 keeps S and P small (16 + 8 registers). At BK 64 ptxas spilled
//   476 bytes and the call was slower (PERF.md, PR 13); a third stage
//   gained nothing at any Dh.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBQ = 128;        // query rows per block (two consumer warpgroups)
constexpr int kStages = 2;      // K/V ring depth
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr float kNegInf = -1.0e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DH>
struct Tiles {
  static constexpr int BK = DH == 256 ? 32 : 128;       // keys per tile
  static constexpr uint32_t Q_BYTES = kBQ * DH * 2;
  static constexpr uint32_t KV_BYTES = BK * DH * 2;     // one K or one V tile
  static constexpr uint32_t BAR_OFF = Q_BYTES + 2 * kStages * KV_BYTES;
  // barriers: q_full, full_k[kStages], full_v[kStages], empty[kStages];
  // 1024 bytes of slack to align the tiles to the swizzle atom
  static constexpr size_t SMEM = BAR_OFF + 8 * (1 + 3 * kStages) + 1024;
};

struct Params {
  CUtensorMap tm_q, tm_k, tm_v;   // 4-D (Dh, S, heads, B) maps, 128-byte swizzle
  __nv_bfloat16* o;
  float* lse;                     // (B, H, Sq), or null: not written
  long long o_sb, o_ss, o_sh;
  int H, KH, Sq, Skv;
  int causal, window;
  float scale_log2;               // scale * log2(e)
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ Params p) {
  using T = Tiles<DH>;
  constexpr int BK = T::BK;
  constexpr int NCH = DH / 64;    // 64-column swizzle boxes along Dh
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;
  const uint32_t sK = sQ + T::Q_BYTES;              // stage s at + s * KV_BYTES
  const uint32_t sV = sK + kStages * T::KV_BYTES;
  const uint32_t q_full = sQ + T::BAR_OFF;
  auto full_k = [&](int s) { return q_full + 8 * (1 + s); };
  auto full_v = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };

  const int b = blockIdx.x / p.H, h = blockIdx.x % p.H;
  const int kvh = h / (p.H / p.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  // kv tiles that hold a kept key for some row of this query tile
  int t_lo = 0, t_hi = (p.Skv + BK - 1) / BK;
  if (p.causal) t_hi = min(t_hi, (q0 + kBQ - 1) / BK + 1);
  if (p.window > 0) t_lo = max(0, q0 - p.window + 1) / BK;
  const int n_tiles = max(0, t_hi - t_lo);

  if (threadIdx.x == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full_k(s), 1);
      sm90::mbar_init(full_v(s), 1);
      sm90::mbar_init(empty(s), 2 * 128);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      sm90::mbar_expect_tx(q_full, T::Q_BYTES);
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        sm90::tma_load_4d(sQ + c * kBQ * 128, &p.tm_q, q_full, c * 64, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kStages;
        const uint32_t phase = (it / kStages) & 1;
        const int k0 = (t_lo + it) * BK;
        sm90::mbar_wait(empty(s), phase ^ 1);   // the first pass finds it free
        sm90::mbar_expect_tx(full_k(s), T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          sm90::tma_load_4d(sK + s * T::KV_BYTES + c * BK * 128, &p.tm_k,
                            full_k(s), c * 64, k0, kvh, b);
        sm90::mbar_expect_tx(full_v(s), T::KV_BYTES);
#pragma unroll
        for (int c = 0; c < NCH; ++c)
          sm90::tma_load_4d(sV + s * T::KV_BYTES + c * BK * 128, &p.tm_v,
                            full_v(s), c * 64, k0, kvh, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;                       // rows q0 + 64 cw ..
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int r_lo = q0 + 64 * cw;               // the warpgroup's first row
    const int row = r_lo + 16 * warp + lane / 4; // this thread's rows: row, row + 8
    const int col = 2 * (lane % 4);              // and columns 8 j + col, + 1

    float o[DH / 2];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    sm90::mbar_wait(q_full, 0);

    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kStages;
      const uint32_t phase = (it / kStages) & 1;
      const int k0 = (t_lo + it) * BK;

      // S = Q . K^T (64 x BK, fp32)
      float sc[BK / 2];
      sm90::mbar_wait(full_k(s), phase);
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk) {
        const uint32_t qa = sQ + (kk / 4) * kBQ * 128 + cw * 64 * 128 + (kk % 4) * 32;
        const uint32_t ka = sK + s * T::KV_BYTES + (kk / 4) * BK * 128 + (kk % 4) * 32;
        sm90::wgmma_ss(sc, sm90::desc_sw128(qa, 16), sm90::desc_sw128(ka, 16), kk > 0);
      }
      sm90::wg_commit();
      sm90::wg_wait_all();
      sm90::reg_fence(sc);

#pragma unroll
      for (int i = 0; i < BK / 2; ++i) sc[i] *= p.scale_log2;
      const bool masked = k0 + BK > p.Skv || (p.causal && k0 + BK - 1 > r_lo) ||
                          (p.window > 0 && k0 <= r_lo + 63 - p.window);
      if (masked) {
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kj = k0 + 8 * j + col + (e & 1);
            const int qi = row + 8 * (e >> 1);
            bool ok = kj < p.Skv;
            if (p.causal) ok = ok && kj <= qi;
            if (p.window > 0) ok = ok && kj > qi - p.window;
            if (!ok) sc[4 * j + e] = kNegInf;
          }
      }

      // online softmax: rows `row` (r = 0) and `row + 8` (r = 1)
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sc[4 * j], sc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = sm90::ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      uint32_t pa[BK / 4];
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const float p0 = sm90::ex2(sc[4 * j] - m[0]);
        const float p1 = sm90::ex2(sc[4 * j + 1] - m[0]);
        const float p2 = sm90::ex2(sc[4 * j + 2] - m[1]);
        const float p3 = sm90::ex2(sc[4 * j + 3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pa[2 * j] = sm90::pack_bf16(p0, p1);
        pa[2 * j + 1] = sm90::pack_bf16(p2, p3);
      }
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }

      // O += P . V (V read MN-major: 16 keys a step, SBO along keys, LBO
      // between the 64-column boxes)
      sm90::mbar_wait(full_v(s), phase);
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2],
                               pa[4 * kk + 3]};
        const uint32_t va = sV + s * T::KV_BYTES + kk * 16 * 128;
        sm90::wgmma_rs(o, a, sm90::desc_sw128(va, BK * 128));
      }
      sm90::wg_commit();
      sm90::wg_wait_all();
      sm90::reg_fence(o);
      sm90::reg_fence(pa);
      sm90::mbar_arrive(empty(s));
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-37f);
    }
    __nv_bfloat16* out = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = row + 8 * r;
      if (qi >= p.Sq) continue;
      if (p.lse != nullptr && lane % 4 == 0)
        p.lse[(long long)blockIdx.x * p.Sq + qi] =
            m[r] == kNegInf ? kNegInf : m[r] * kLn2 + logf(l[r]);
#pragma unroll
      for (int j = 0; j < DH / 8; ++j) {
        const __nv_bfloat162 v2 = __floats2bfloat162_rn(o[4 * j + 2 * r] / l[r],
                                                        o[4 * j + 2 * r + 1] / l[r]);
        *reinterpret_cast<__nv_bfloat162*>(out + qi * p.o_ss + 8 * j + col) = v2;
      }
    }
  }
}

// ------------------------------------------------------------------ host
// cuTensorMapEncodeTiled is a driver function; it is fetched through the
// runtime's entry-point query, so the library links no libcuda and keeps
// the plain C interface that ctypes loads.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                                  cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// Status codes beyond the runtime's: a failed encode returns
// kEncodeFailed + its CUresult.
constexpr int kEncodeFailed = 10000;

// (Dh, S, heads, B) with element strides (1, ss, sh, sb); boxes of
// 64 x rows x 1 x 1
int encode(EncodeTiledFn fn, CUtensorMap* map, const void* ptr, int dh, int seq,
           int heads, int batch, long long ss, long long sh, long long sb,
           int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)seq, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

template <int DH>
int launch(Params& p, const void* q, const void* k, const void* v, int batch,
           long long q_sb, long long q_ss, long long q_sh, long long k_sb,
           long long k_ss, long long k_sh, long long v_sb, long long v_ss,
           long long v_sh, cudaStream_t stream) {
  using T = Tiles<DH>;
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  int status = encode(fn, &p.tm_q, q, DH, p.Sq, p.H, batch, q_ss, q_sh, q_sb, kBQ);
  if (status == 0)
    status = encode(fn, &p.tm_k, k, DH, p.Skv, p.KH, batch, k_ss, k_sh, k_sb, T::BK);
  if (status == 0)
    status = encode(fn, &p.tm_v, v, DH, p.Skv, p.KH, batch, v_ss, v_sh, v_sb, T::BK);
  if (status != 0) return status;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(batch * p.H), (unsigned)((p.Sq + kBQ - 1) / kBQ));
  flash_fwd_sm90_kernel<DH><<<grid, kThreads, T::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

bool tma_ok(const void* ptr, long long sb, long long ss, long long sh) {
  return ((uintptr_t)ptr % 16) == 0 && sb > 0 && ss > 0 && sh > 0 &&
         sb % 8 == 0 && ss % 8 == 0 && sh % 8 == 0;
}

}  // namespace

extern "C" int flash_attention_fwd_sm90_bf16(
    const void* q, const void* k, const void* v, void* o, void* lse, int batch,
    int H, int KH,
    int Sq, int Skv, int Dh, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_ss, long long o_sh, int causal,
    int window, float scale, void* stream) {
  if (batch < 1 || H < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Skv < 1 ||
      window < 0 || (long long)batch * H > 0x7fffffffLL ||
      (Sq + kBQ - 1) / kBQ > 65535 || !tma_ok(q, q_sb, q_ss, q_sh) ||
      !tma_ok(k, k_sb, k_ss, k_sh) || !tma_ok(v, v_sb, v_ss, v_sh) ||
      ((uintptr_t)o % 4) != 0 || ((uintptr_t)lse % 4) != 0 || o_ss % 2 != 0 || o_sh % 2 != 0 || o_sb % 2 != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.o_sb = o_sb;
  p.o_ss = o_ss;
  p.o_sh = o_sh;
  p.H = H;
  p.KH = KH;
  p.Sq = Sq;
  p.Skv = Skv;
  p.causal = causal;
  p.window = window;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (Dh) {
    case 64:
      return launch<64>(p, q, k, v, batch, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                        v_sb, v_ss, v_sh, s);
    case 128:
      return launch<128>(p, q, k, v, batch, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                         v_sb, v_ss, v_sh, s);
    case 256:
      return launch<256>(p, q, k, v, batch, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                         v_sb, v_ss, v_sh, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the dynamic shared memory a block of the Dh kernel asks for (0: no kernel)
extern "C" int flash_attention_sm90_smem_bytes(int Dh) {
  switch (Dh) {
    case 64: return (int)Tiles<64>::SMEM;
    case 128: return (int)Tiles<128>::SMEM;
    case 256: return (int)Tiles<256>::SMEM;
    default: return 0;
  }
}

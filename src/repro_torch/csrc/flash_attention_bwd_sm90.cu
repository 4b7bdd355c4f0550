// Flash-attention backward for Hopper (sm_90a) in bf16, on the tensor cores:
// the VJP of csrc/flash_attention_sm90.cu's forward from its saved q, k, v,
// out and lse (B, H, Sq) fp32,
//   p[i, j]  = exp(scale q_i . k_j - lse_i) over the kept keys, else 0
//   dv_j    += p[i, j] dout_i            dp[i, j] = dout_i . v_j
//   ds[i, j] = p[i, j] (dp[i, j] - delta_i) scale,  delta_i = dout_i . out_i
//   dq_i    += ds[i, j] k_j               dk_j    += ds[i, j] q_i
// with dk and dv summed over the G = H / KH query heads of a kv head. Masks
// as the forward's (causal: j <= i; window w: j > i - w; and j < Skv),
// inputs in the model's layout q, out, dout (B, Sq, H, Dh), k/v (B, Skv, KH,
// Dh) with their strides: no transpose, no repeat of kv heads, no pad in
// device memory. dq, dk, dv are written contiguous, in bf16.
//
// It replaces no TPU kernel: the JAX model's backward is jnp
// (`_bwd` at src/repro/models/flash.py:315), and so is the port's plain
// version (kernels/flash_attention/ref.py `flash_backward`), which CPU
// tensors and the shapes this kernel does not take still use. The numerics
// are the plain version's: p, dout, ds and the operands of every product
// in bf16, every sum in fp32 (wgmma with bf16 operands and fp32
// accumulators), delta in fp32; exp on exp2 with log2(e) folded into the
// scale and the lse. dq, dk and dv are summed across blocks in fp32 by the
// memory system's bulk reductions in a fixed order (below), so a call gives
// the same bits every time.
//
// What bounds it: operations. At chatglm3-6b's training shape (B 2, S 4096,
// H 32, KH 2, Dh 128, causal) a call does 10 B H Dh pairs = 6.87e11 FLOP
// (the recompute of S and the dP, dV, dQ and dK products: 2.5 times the
// forward's 4 B H Dh pairs) on ~0.3 GB, so the least time is the FLOPs over
// the bf16 tensor-core peak, 0.695 ms. The design keeps the five products on
// the tensor cores and the card full:
//
// - Three kernels on the caller's stream. flash_bwd_sm90_prep_kernel: one
//   warp a (b, h, row) forms delta = sum(dout * out) in fp32 and lse log2(e)
//   into padded (B, H, Sq_pad) rows, and every thread clears a share of the
//   fp32 dQ accumulator and its counters. flash_bwd_sm90_kernel: the
//   products. flash_bwd_sm90_convert_kernel: dQ, and dK and dV summed over
//   the G query heads of their kv head (g = 0 first), to bf16 in the
//   outputs' layout.
// - flash_bwd_sm90_kernel: one block of 256 threads (two warpgroups) a
//   (128-key tile, b * H + h). Key tiles run first to last (the grid's y
//   axis), so under the causal mask the longest, the first, start first.
//   One block a query head, not a kv head: at chatglm3's B 2 x KH 2 a block
//   a (b, kv head, key tile) would give 128 blocks for 132 SMs, the first
//   with 32 times the last one's work; a block a query head gives 2,048.
//   Each writes its head's dK and dV to a (B, H, Skv_pad, Dh) fp32 slot of
//   its own, which the convert pass sums.
// - The order of dQ's sum: a counter a (b, h, group of kGroup query tiles)
//   lets the key tiles add into the group's rows one after another, first
//   to last: a key tile waits before its first add into the group until
//   the earlier tiles that add there are done with it. A block waits only
//   for blocks of an earlier key tile, a lower linear index, which the card
//   started before it. During step it + 1's dV and dK products thread 0
//   hands on the group of step it - 1 if that was the block's last step
//   there (its add, issued a step before, has completed), waits for step
//   it's group if it is the block's first step there, and adds step it's
//   dQ. Each wait and release stalls thread 0's warpgroup (an L2 round
//   trip, a gpu-scope fence), and a coarser group makes a key tile trail
//   the one before it by more steps: of groups of 1, 2, 4 and 8 tiles, 2
//   was the fastest on an H100.
// - The block's K and V tiles (128 keys, 64 a warpgroup) load once by TMA
//   and stay; dK and dV (64 x Dh fp32 each a warpgroup) stay in registers
//   across the query tiles. The query tiles the mask keeps for the key tile
//   stream through: Q, dout (64 rows, TMA) and their lse and delta rows (bulk
//   copies) into a ring of two stages; thread 0 issues step it + 1's loads
//   at the start of step it, into the stage that step it - 1 left (every
//   read of it ends before the barrier that closes step it - 1). No producer
//   warp: with 256 threads ptxas may give a thread 255 registers, and dK,
//   dV, S and dP alone take 192 at Dh 128.
// - A step (64 query rows): S^T = K.Q^T and dP^T = V.dO^T (wgmma m64n64k16,
//   both operands K-major from shared memory), so a warpgroup holds its
//   keys' rows; P^T and dS^T are formed in registers (masks only on tiles
//   that cross the diagonal, the window's edge, Sq or Skv); dV += P^T.dO and
//   dK += dS^T.Q take P^T and dS^T as wgmma's A from registers as they lie
//   (sm90.cuh) and dO and Q as the MN-major B. dS^T goes to shared memory
//   in the 128-byte swizzle, where dQ = dS.K reads it as an MN-major A
//   (m64n64k16 a warpgroup, one 64-column half of Dh each; at Dh 64 the
//   first warpgroup alone). dQ goes through shared memory (fp32, 16-byte
//   chunks of a row XOR-ed with the row, free of bank conflicts; two
//   buffers, so a step's add may run through the next step) to a bulk
//   reduce-add into the (B, H, Sq_pad, Dh) fp32 accumulator, which the
//   convert pass reads with the same XOR.
// - The epilogue writes dK and dV the same way into the idle K/V tiles and
//   Q/dO ring and bulk-copies them into the head's slots (a key tile
//   without a kept pair writes zeros there).
// - Shared memory at Dh 128: K, V 64 KB, Q/dO ring 64 KB, dS 16 KB, dQ 64 KB
//   (210 KB, one block an SM); at Dh 64, 114 KB.
// Head dims 64 and 128 only: at 256, dK and dV alone would take 256
// registers a thread; 80 stays on the plain version.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kBM = 64;         // query rows a step
constexpr int kBN = 128;        // keys a block (two warpgroups of 64)
constexpr int kStages = 2;      // Q/dO ring depth
constexpr int kThreads = 256;   // two warpgroups
constexpr int kGroup = 2;       // query tiles (128 rows) a dQ counter orders
constexpr float kLog2e = 1.4426950408889634f;

template <int DH>
struct Tiles {
  static constexpr uint32_t KV_BYTES = kBN * DH * 2;    // one K or V tile
  static constexpr uint32_t QD_BYTES = kBM * DH * 2;    // one Q or dO tile
  static constexpr uint32_t ROW_BYTES = kBM * 4;        // a tile's lse or delta
  static constexpr uint32_t DS_BYTES = kBN * kBM * 2;   // dS^T, bf16
  static constexpr uint32_t DQ_BYTES = kBM * DH * 4;    // dQ of a step, fp32 (two)
  static constexpr uint32_t OFF_K = 0;
  static constexpr uint32_t OFF_V = KV_BYTES;
  static constexpr uint32_t OFF_Q = 2 * KV_BYTES;       // stage s at + s * QD_BYTES
  static constexpr uint32_t OFF_DO = OFF_Q + kStages * QD_BYTES;
  static constexpr uint32_t OFF_DS = OFF_DO + kStages * QD_BYTES;
  static constexpr uint32_t OFF_DQ = OFF_DS + DS_BYTES;
  static constexpr uint32_t OFF_LSE = OFF_DQ + 2 * DQ_BYTES;  // stage s at + s * ROW_BYTES
  static constexpr uint32_t OFF_DELTA = OFF_LSE + kStages * ROW_BYTES;
  // barriers: kv_full, q_full[kStages], do_full[kStages]; 1024 bytes of
  // slack to align the tiles to the swizzle atom
  static constexpr uint32_t OFF_BAR = OFF_DELTA + kStages * ROW_BYTES;
  static constexpr size_t SMEM = OFF_BAR + 8 * (1 + 2 * kStages) + 1024;
  // the epilogue's fp32 dV (128 x Dh) over K and V, dK over the Q/dO ring
  static_assert(kBN * DH * 4 <= 2 * KV_BYTES, "dV staging");
  static_assert(kBN * DH * 4 <= 2 * kStages * QD_BYTES, "dK staging");
};

// element (r, c) of an fp32 accumulator row block lies at r Dh + swz(r, c):
// the 8-float chunks of row r XOR-ed with r % 8
__host__ __device__ __forceinline__ int swz(int r, int c) {
  return ((((c >> 3) ^ (r & 7)) << 3) | (c & 7));
}

struct Params {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;  // 4-D (Dh, S, heads, B), 128-byte swizzle
  const float* lse2;    // (B, H, Sq_pad): lse log2(e)
  const float* delta;   // (B, H, Sq_pad)
  float* dq_acc;        // (B, H, Sq_pad, Dh)
  float* dk_part;       // (B, H, Skv_pad, Dh): each query head's dK
  float* dv_part;       // (B, H, Skv_pad, Dh)
  int* dq_sem;          // (B, H, row groups): key tiles done with a group's rows
  int H, KH, Sq, Skv, Sq_pad, Skv_pad;
  int causal, window;
  float scale, scale_log2;  // scale, scale log2(e)
};

// the query tiles [m_lo, m_hi) that hold a kept pair with some key of the
// tile that starts at key n0
__device__ __forceinline__ int2 query_tiles(const Params& p, int n0) {
  int m_hi = (p.Sq + kBM - 1) / kBM;
  if (p.window > 0) m_hi = min(m_hi, (n0 + kBN + p.window - 2) / kBM + 1);
  return make_int2(p.causal ? n0 / kBM : 0, m_hi);
}

// how many key tiles before tile n add into the row group that starts at
// query tile m, which tile n also adds into: every earlier tile under no
// window (their query tiles start no later and run to the end); under a
// window those whose query tiles still reach m, the last ones before n
__device__ __forceinline__ int dq_turn(const Params& p, int n, int m) {
  if (p.window == 0) return n;
  int turn = 0;
  while (turn < n && query_tiles(p, (n - 1 - turn) * kBN).y > m) ++turn;
  return turn;
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_sm90_kernel(const __grid_constant__ Params p) {
  using T = Tiles<DH>;
  constexpr int NCH = DH / 64;   // 64-column swizzle boxes along Dh
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  uint8_t* const sp = smem_raw + (base - raw);     // the same bytes, generic
  const uint32_t sK = base + T::OFF_K, sV = base + T::OFF_V;
  auto sQ = [&](int s) { return base + T::OFF_Q + s * T::QD_BYTES; };
  auto sDO = [&](int s) { return base + T::OFF_DO + s * T::QD_BYTES; };
  const uint32_t sDS = base + T::OFF_DS;
  auto sDQ = [&](int j) { return base + T::OFF_DQ + (j & 1) * T::DQ_BYTES; };
  const uint32_t kv_full = base + T::OFF_BAR;
  auto q_full = [&](int s) { return kv_full + 8 * (1 + s); };
  auto do_full = [&](int s) { return kv_full + 8 * (1 + kStages + s); };

  const int bh = blockIdx.x, b = bh / p.H, h = bh % p.H;
  const int kvh = h / (p.H / p.KH);
  const int n0 = blockIdx.y * kBN;
  const int2 mr = query_tiles(p, n0);
  const int m_lo = mr.x, n_m = mr.y - mr.x;
  int* const dq_sem = p.dq_sem + (size_t)bh * ((p.Sq_pad / kBM + kGroup - 1) / kGroup);
  const size_t part = ((size_t)bh * p.Skv_pad + n0) * DH;   // this block's dK, dV slot
  if (n_m <= 0) {   // no kept pair: zero dK and dV, nothing for dQ
    float4* dk = reinterpret_cast<float4*>(p.dk_part + part);
    float4* dv = reinterpret_cast<float4*>(p.dv_part + part);
    for (int i = threadIdx.x; i < kBN * DH / 4; i += kThreads)
      dk[i] = dv[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    return;
  }

  if (threadIdx.x == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(q_full(s), 1);
      sm90::mbar_init(do_full(s), 1);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  // step it's Q, dout, lse and delta into stage it % kStages (thread 0)
  auto load_step = [&](int it) {
    const int s = it % kStages, m0 = (m_lo + it) * kBM;
    const size_t row = (size_t)bh * p.Sq_pad + m0;
    sm90::mbar_expect_tx(q_full(s), T::QD_BYTES + T::ROW_BYTES);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      sm90::tma_load_4d(sQ(s) + c * kBM * 128, &p.tm_q, q_full(s), c * 64, m0, h, b);
    sm90::bulk_load(base + T::OFF_LSE + s * T::ROW_BYTES, p.lse2 + row, T::ROW_BYTES,
                    q_full(s));
    sm90::mbar_expect_tx(do_full(s), T::QD_BYTES + T::ROW_BYTES);
#pragma unroll
    for (int c = 0; c < NCH; ++c)
      sm90::tma_load_4d(sDO(s) + c * kBM * 128, &p.tm_do, do_full(s), c * 64, m0, h, b);
    sm90::bulk_load(base + T::OFF_DELTA + s * T::ROW_BYTES, p.delta + row,
                    T::ROW_BYTES, do_full(s));
  };
  if (threadIdx.x == 0) {
    sm90::mbar_expect_tx(kv_full, 2 * T::KV_BYTES);
#pragma unroll
    for (int c = 0; c < NCH; ++c) {
      sm90::tma_load_4d(sK + c * kBN * 128, &p.tm_k, kv_full, c * 64, n0, kvh, b);
      sm90::tma_load_4d(sV + c * kBN * 128, &p.tm_v, kv_full, c * 64, n0, kvh, b);
    }
    load_step(0);
  }

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
  const int key_lo = n0 + 64 * wg;              // the warpgroup's first key
  const int kr = key_lo + 16 * warp + lane / 4; // this thread's keys: kr, kr + 8
  const int lrow = kr - n0;                     // the same, in the block's tile
  const int col = 2 * (lane % 4);               // and query columns 8 j + col, + 1

  // thread 0: step j's dQ (in sDQ(j) until step j + 2 writes it) into its
  // rows, after (at the block's first step in a row group) waiting until
  // the key tiles before this one are done with the group; and the group to
  // the next key tile once the block's last add into it has completed
  auto wait_dq = [&](int j) {
    const int m = m_lo + j;
    if (j == 0 || m % kGroup == 0) {
      sm90::sem_wait(dq_sem + m / kGroup, dq_turn(p, blockIdx.y, m / kGroup * kGroup));
      sm90::fence_proxy_async_global();
    }
  };
  auto add_dq = [&](int j) {
    sm90::bulk_reduce_add_f32(p.dq_acc + ((size_t)bh * p.Sq_pad + (m_lo + j) * kBM) * DH,
                              sDQ(j), T::DQ_BYTES);
    sm90::bulk_commit();
  };
  auto release_dq = [&](int j) {
    const int m = m_lo + j;
    if (j == n_m - 1 || m % kGroup == kGroup - 1) {
      sm90::fence_proxy_async_global();
      sm90::sem_post(dq_sem + m / kGroup);
    }
  };

  float dk[DH / 2], dv[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dk[i] = dv[i] = 0.f;
  sm90::mbar_wait(kv_full, 0);

  for (int it = 0; it < n_m; ++it) {
    const int s = it % kStages;
    const uint32_t phase = (it / kStages) & 1;
    const int m0 = (m_lo + it) * kBM;
    if (threadIdx.x == 0 && it + 1 < n_m) load_step(it + 1);

    // S^T = K . Q^T and dP^T = V . dO^T (64 keys x 64 query rows, fp32)
    float sacc[kBM / 2], dpacc[kBM / 2];
    sm90::mbar_wait(q_full(s), phase);
    sm90::wg_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t ka = sK + (kk / 4) * kBN * 128 + wg * 64 * 128 + (kk % 4) * 32;
      const uint32_t qa = sQ(s) + (kk / 4) * kBM * 128 + (kk % 4) * 32;
      sm90::wgmma_ss64<0, 0>(sacc, sm90::desc_sw128(ka, 16), sm90::desc_sw128(qa, 16),
                             kk > 0);
    }
    sm90::wg_commit();
    sm90::mbar_wait(do_full(s), phase);
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      const uint32_t va = sV + (kk / 4) * kBN * 128 + wg * 64 * 128 + (kk % 4) * 32;
      const uint32_t da = sDO(s) + (kk / 4) * kBM * 128 + (kk % 4) * 32;
      sm90::wgmma_ss64<0, 0>(dpacc, sm90::desc_sw128(va, 16), sm90::desc_sw128(da, 16),
                             kk > 0);
    }
    sm90::wg_commit();
    sm90::wg_wait_one();
    sm90::reg_fence(sacc);

    // P^T: element 4 j + e is key kr + 8 (e / 2), query m0 + 8 j + col + e % 2
    const float* lse2 = reinterpret_cast<const float*>(sp + T::OFF_LSE + s * T::ROW_BYTES);
    const bool masked = m0 + kBM > p.Sq || key_lo + 64 > p.Skv ||
                        (p.causal && key_lo + 63 > m0) ||
                        (p.window > 0 && key_lo <= m0 + kBM - 1 - p.window);
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse2 + 8 * j + col);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sm90::ex2(sacc[4 * j + e] * p.scale_log2 - ((e & 1) ? l2.y : l2.x));
        if (masked) {
          const int qi = m0 + 8 * j + col + (e & 1), kj = kr + 8 * (e >> 1);
          bool ok = qi < p.Sq && kj < p.Skv;
          if (p.causal) ok = ok && kj <= qi;
          if (p.window > 0) ok = ok && kj > qi - p.window;
          if (!ok) x = 0.f;   // a select: exp of a masked score may be inf
        }
        sacc[4 * j + e] = x;
      }
    }
    uint32_t pbf[kBM / 4], dsbf[kBM / 4];
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j) {
      pbf[2 * j] = sm90::pack_bf16(sacc[4 * j], sacc[4 * j + 1]);
      pbf[2 * j + 1] = sm90::pack_bf16(sacc[4 * j + 2], sacc[4 * j + 3]);
    }
    sm90::wg_wait_all();
    sm90::reg_fence(dpacc);
    // dS^T = P^T (dP^T - delta) scale, rounded to bf16
    const float* delta = reinterpret_cast<const float*>(sp + T::OFF_DELTA + s * T::ROW_BYTES);
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(delta + 8 * j + col);
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[e] = sacc[4 * j + e] * (dpacc[4 * j + e] - ((e & 1) ? d2.y : d2.x)) * p.scale;
      dsbf[2 * j] = sm90::pack_bf16(ds[0], ds[1]);
      dsbf[2 * j + 1] = sm90::pack_bf16(ds[2], ds[3]);
    }

    // dV += P^T . dO and dK += dS^T . Q (A from registers, B MN-major: 16
    // query rows a step, LBO between the 64-column boxes)
    sm90::wg_fence();
    sm90::reg_fence(dv);
    sm90::reg_fence(dk);
#pragma unroll
    for (int kk = 0; kk < kBM / 16; ++kk) {
      const uint32_t a[4] = {pbf[4 * kk], pbf[4 * kk + 1], pbf[4 * kk + 2], pbf[4 * kk + 3]};
      sm90::wgmma_rs(dv, a, sm90::desc_sw128(sDO(s) + kk * 16 * 128, kBM * 128));
    }
#pragma unroll
    for (int kk = 0; kk < kBM / 16; ++kk) {
      const uint32_t a[4] = {dsbf[4 * kk], dsbf[4 * kk + 1], dsbf[4 * kk + 2],
                             dsbf[4 * kk + 3]};
      sm90::wgmma_rs(dk, a, sm90::desc_sw128(sQ(s) + kk * 16 * 128, kBM * 128));
    }
    sm90::wg_commit();
    if (threadIdx.x == 0 && it >= 1) {   // while the products run
      if (it >= 2) {
        sm90::bulk_wait();   // step it - 2's add, a step ago, has completed
        release_dq(it - 2);
      }
      wait_dq(it - 1);
      add_dq(it - 1);
    }

    // dS^T (128 keys x 64 query rows, bf16) into shared memory in the
    // 128-byte swizzle: row lrow's 16-byte chunk j at j ^ (lrow % 8). The
    // previous step's dQ products have read it (the barrier that closed it).
#pragma unroll
    for (int j = 0; j < kBM / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = lrow + 8 * r;
        *reinterpret_cast<uint32_t*>(sp + T::OFF_DS + row * 128 +
                                     ((j ^ (row & 7)) << 4) + 4 * (lane % 4)) =
            dsbf[2 * j + r];
      }
    sm90::fence_proxy_async();
    sm90::bar_sync(1, kThreads);

    // dQ (64 rows x Dh) = dS . K: A = dS^T read MN-major (16 keys a step),
    // B = K read MN-major, the warpgroup's 64-column box of Dh
    float dq[32];
    if (wg < NCH) {
      sm90::wg_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        sm90::wgmma_ss64<1, 1>(dq, sm90::desc_sw128(sDS + kk * 16 * 128, kBN * 128),
                               sm90::desc_sw128(sK + wg * kBN * 128 + kk * 16 * 128,
                                                kBN * 128),
                               kk > 0);
      sm90::wg_commit();
    }
    sm90::wg_wait_all();
    sm90::reg_fence(dv);
    sm90::reg_fence(dk);
    sm90::reg_fence(pbf);
    sm90::reg_fence(dsbf);
    if (wg < NCH) {
      sm90::reg_fence(dq);
      float* sdq = reinterpret_cast<float*>(sp + T::OFF_DQ + (it & 1) * T::DQ_BYTES);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = 16 * warp + lane / 4 + 8 * r;
          *reinterpret_cast<float2*>(sdq + row * DH + swz(row, 64 * wg + 8 * j + col)) =
              make_float2(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
        }
    }
    sm90::fence_proxy_async();
    sm90::bar_sync(1, kThreads);   // every read of stage s and of dS^T has ended
  }
  if (threadIdx.x == 0) {   // the last steps' dQ: released, added, released
    sm90::bulk_wait();
    if (n_m >= 2) release_dq(n_m - 2);
    wait_dq(n_m - 1);
    add_dq(n_m - 1);
    sm90::bulk_wait();
    release_dq(n_m - 1);
  }

  // dV over the K/V tiles, dK over the Q/dO ring (fp32, the same XOR), then
  // one bulk copy each into the head's slots
  float* sdv = reinterpret_cast<float*>(sp + T::OFF_K);
  float* sdk = reinterpret_cast<float*>(sp + T::OFF_Q);
#pragma unroll
  for (int j = 0; j < DH / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = lrow + 8 * r, at = row * DH + swz(row, 8 * j + col);
      *reinterpret_cast<float2*>(sdv + at) = make_float2(dv[4 * j + 2 * r], dv[4 * j + 2 * r + 1]);
      *reinterpret_cast<float2*>(sdk + at) = make_float2(dk[4 * j + 2 * r], dk[4 * j + 2 * r + 1]);
    }
  sm90::fence_proxy_async();
  sm90::bar_sync(1, kThreads);
  if (threadIdx.x == 0) {
    sm90::bulk_store(p.dk_part + part, base + T::OFF_Q, kBN * DH * 4);
    sm90::bulk_store(p.dv_part + part, base + T::OFF_K, kBN * DH * 4);
    sm90::bulk_commit();
    sm90::bulk_wait_read();
  }
}

struct PrepParams {
  const __nv_bfloat16 *o, *dout;
  const float* lse;         // (B, H, Sq)
  float *lse2, *delta;      // (B, H, Sq_pad)
  float4* acc;              // the fp32 dQ accumulator and its counters, cleared
  long long acc4;           // their size in float4
  long long o_sb, o_ss, o_sh, d_sb, d_ss, d_sh;
  int B, H, Sq, Sq_pad, Dh;
};

// one warp a (b, h, row) of the padded rows: delta = sum(dout * out) in fp32
// and lse log2(e) (0 past Sq); every thread clears a grid-stride share of
// the dQ accumulator and its counters
__global__ void flash_bwd_sm90_prep_kernel(const PrepParams p) {
  const long long gt = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long w = gt / 32, rows = (long long)p.B * p.H * p.Sq_pad;
  const int lane = threadIdx.x % 32;
  if (w < rows) {
    const int i = (int)(w % p.Sq_pad);
    const long long bh = w / p.Sq_pad;
    const int b = (int)(bh / p.H), h = (int)(bh % p.H);
    float acc = 0.f;
    if (i < p.Sq) {
      const __nv_bfloat16* o = p.o + b * p.o_sb + i * p.o_ss + h * p.o_sh;
      const __nv_bfloat16* d = p.dout + b * p.d_sb + i * p.d_ss + h * p.d_sh;
      for (int c = 2 * lane; c < p.Dh; c += 64) {
        const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o + c));
        const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(d + c));
        acc += x.x * y.x + x.y * y.y;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      p.delta[w] = acc;
      p.lse2[w] = i < p.Sq ? p.lse[bh * p.Sq + i] * kLog2e : 0.f;
    }
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long z = gt; z < p.acc4; z += stride) p.acc[z] = make_float4(0.f, 0.f, 0.f, 0.f);
}

struct ConvertParams {
  const float *dq_acc, *dk_part, *dv_part;
  __nv_bfloat16 *dq, *dk, *dv;   // contiguous (B, Sq, H, Dh), (B, Skv, KH, Dh)
  int B, H, KH, Sq, Skv, Sq_pad, Skv_pad, Dh;
};

// dQ, and dK and dV summed over their G query heads in a fixed order, to
// bf16 in the outputs' layout, two elements a thread
__global__ void flash_bwd_sm90_convert_kernel(const ConvertParams p) {
  const long long nq = (long long)p.B * p.Sq * p.H * p.Dh / 2;
  const long long nk = (long long)p.B * p.Skv * p.KH * p.Dh / 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long x = (long long)blockIdx.x * blockDim.x + threadIdx.x; x < nq + 2 * nk;
       x += stride) {
    if (x < nq) {
      const long long e = 2 * x, row = e / p.Dh;
      const int c = (int)(e % p.Dh), h = (int)(row % p.H), i = (int)(row / p.H % p.Sq);
      const long long b = row / p.H / p.Sq;
      const float2 v = *reinterpret_cast<const float2*>(
          p.dq_acc + ((b * p.H + h) * p.Sq_pad + i) * p.Dh + swz(i, c));
      *reinterpret_cast<__nv_bfloat162*>(p.dq + e) = __floats2bfloat162_rn(v.x, v.y);
    } else {
      const bool is_v = x - nq >= nk;
      const long long e = 2 * (x - nq - (is_v ? nk : 0)), row = e / p.Dh;
      const int c = (int)(e % p.Dh), kh = (int)(row % p.KH), j = (int)(row / p.KH % p.Skv);
      const long long b = row / p.KH / p.Skv;
      const int G = p.H / p.KH;
      const long long head = (long long)p.Skv_pad * p.Dh;   // one head's slot
      const float* src = (is_v ? p.dv_part : p.dk_part) +
                         ((b * p.H + (long long)kh * G) * p.Skv_pad + j) * p.Dh + swz(j, c);
      float2 v = *reinterpret_cast<const float2*>(src);
      for (int g = 1; g < G; ++g) {
        const float2 w = *reinterpret_cast<const float2*>(src + g * head);
        v.x += w.x;
        v.y += w.y;
      }
      *reinterpret_cast<__nv_bfloat162*>((is_v ? p.dv : p.dk) + e) =
          __floats2bfloat162_rn(v.x, v.y);
    }
  }
}

template <int DH>
int launch(Params& p, const void* q, const void* k, const void* v, const void* dout,
           int batch, const long long* qs, const long long* ks, const long long* vs,
           const long long* ds, cudaStream_t stream) {
  using T = Tiles<DH>;
  sm90::EncodeTiledFn fn = sm90::encode_fn();
  if (fn == nullptr) return (int)cudaErrorSymbolNotFound;
  // strides arrive as (batch, seq, head)
  int status = sm90::encode(fn, &p.tm_q, q, DH, p.Sq, p.H, batch, qs[1], qs[2], qs[0], kBM);
  if (status == 0)
    status = sm90::encode(fn, &p.tm_do, dout, DH, p.Sq, p.H, batch, ds[1], ds[2], ds[0], kBM);
  if (status == 0)
    status = sm90::encode(fn, &p.tm_k, k, DH, p.Skv, p.KH, batch, ks[1], ks[2], ks[0], kBN);
  if (status == 0)
    status = sm90::encode(fn, &p.tm_v, v, DH, p.Skv, p.KH, batch, vs[1], vs[2], vs[0], kBN);
  if (status != 0) return status;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_sm90_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(batch * p.H), (unsigned)(p.Skv_pad / kBN));
  flash_bwd_sm90_kernel<DH><<<grid, kThreads, T::SMEM, stream>>>(p);
  return (int)cudaGetLastError();
}

// The scratch of a call, in 4-byte words from its start: the fp32 dq
// accumulator and its int32 counters (padded to 16 bytes), which the prep
// kernel clears; the fp32 lse and delta rows; each query head's fp32 dk and
// dv.
struct Scratch {
  long long sq_pad, skv_pad, dq, dq_sem, lse2, delta, dk, dv, total;
  Scratch(long long batch, long long H, int Sq, int Skv, int Dh) {
    sq_pad = (Sq + kBM - 1) / kBM * kBM;
    skv_pad = (Skv + kBN - 1) / kBN * kBN;
    dq = 0;
    dq_sem = dq + batch * H * sq_pad * Dh;
    lse2 = (dq_sem + batch * H * ((sq_pad / kBM + kGroup - 1) / kGroup) + 3) / 4 * 4;
    delta = lse2 + batch * H * sq_pad;
    dk = delta + batch * H * sq_pad;
    dv = dk + batch * H * skv_pad * Dh;
    total = dv + batch * H * skv_pad * Dh;
  }
};

}  // namespace

// q, k, v, out, dout (bf16, the model's layout, strides in elements as
// (batch, seq, head) triples); lse (B, H, Sq) fp32 contiguous; dq, dk, dv
// contiguous bf16 outputs; a 16-byte aligned scratch of `scratch_floats`
// 4-byte words, at least flash_attention_bwd_sm90_scratch's. Three launches on
// `stream`; returns the last cudaGetLastError(), or kEncodeFailed + the
// CUresult of a refused tensor map.
extern "C" int flash_attention_bwd_sm90_bf16(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* dq, void* dk, void* dv, void* scratch,
    long long scratch_floats, int batch, int H, int KH, int Sq, int Skv, int Dh,
    long long q_sb, long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_ss, long long o_sh, long long d_sb, long long d_ss, long long d_sh,
    int causal, int window, float scale, void* stream) {
  if (batch < 1 || H < 1 || KH < 1 || H % KH != 0 || Sq < 1 || Skv < 1 || window < 0 ||
      (long long)batch * H > 0x7fffffffLL || (Skv + kBN - 1) / kBN > 65535 ||
      (Dh != 64 && Dh != 128) || !sm90::tma_ok(q, q_sb, q_ss, q_sh) ||
      !sm90::tma_ok(k, k_sb, k_ss, k_sh) || !sm90::tma_ok(v, v_sb, v_ss, v_sh) ||
      !sm90::tma_ok(dout, d_sb, d_ss, d_sh) || !sm90::tma_ok(o, o_sb, o_ss, o_sh) ||
      ((uintptr_t)lse % 4) != 0 || ((uintptr_t)scratch % 16) != 0 ||
      ((uintptr_t)dq % 4) != 0 || ((uintptr_t)dk % 4) != 0 || ((uintptr_t)dv % 4) != 0 ||
      scratch_floats < Scratch(batch, H, Sq, Skv, Dh).total)
    return (int)cudaErrorInvalidValue;
  const Scratch at(batch, H, Sq, Skv, Dh);
  const long long sq_pad = at.sq_pad, skv_pad = at.skv_pad;
  float* f = static_cast<float*>(scratch);
  Params p;
  p.dq_acc = f + at.dq;
  p.dk_part = f + at.dk;
  p.dv_part = f + at.dv;
  p.dq_sem = reinterpret_cast<int*>(f + at.dq_sem);
  float* lse2 = f + at.lse2;
  float* delta = f + at.delta;
  p.lse2 = lse2;
  p.delta = delta;
  p.H = H;
  p.KH = KH;
  p.Sq = Sq;
  p.Skv = Skv;
  p.Sq_pad = (int)sq_pad;
  p.Skv_pad = (int)skv_pad;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);

  PrepParams pp;
  pp.o = static_cast<const __nv_bfloat16*>(o);
  pp.dout = static_cast<const __nv_bfloat16*>(dout);
  pp.lse = static_cast<const float*>(lse);
  pp.lse2 = lse2;
  pp.delta = delta;
  pp.acc = reinterpret_cast<float4*>(f);
  pp.acc4 = at.lse2 / 4;
  pp.o_sb = o_sb;
  pp.o_ss = o_ss;
  pp.o_sh = o_sh;
  pp.d_sb = d_sb;
  pp.d_ss = d_ss;
  pp.d_sh = d_sh;
  pp.B = batch;
  pp.H = H;
  pp.Sq = Sq;
  pp.Sq_pad = (int)sq_pad;
  pp.Dh = Dh;
  const long long prep_blocks = ((long long)batch * H * sq_pad * 32 + 255) / 256;
  flash_bwd_sm90_prep_kernel<<<(unsigned)prep_blocks, 256, 0, s>>>(pp);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const long long qs[3] = {q_sb, q_ss, q_sh}, ks[3] = {k_sb, k_ss, k_sh},
                  vs[3] = {v_sb, v_ss, v_sh}, ds[3] = {d_sb, d_ss, d_sh};
  const int status = Dh == 64 ? launch<64>(p, q, k, v, dout, batch, qs, ks, vs, ds, s)
                              : launch<128>(p, q, k, v, dout, batch, qs, ks, vs, ds, s);
  if (status != 0) return status;

  ConvertParams cp;
  cp.dq_acc = p.dq_acc;
  cp.dk_part = p.dk_part;
  cp.dv_part = p.dv_part;
  cp.dq = static_cast<__nv_bfloat16*>(dq);
  cp.dk = static_cast<__nv_bfloat16*>(dk);
  cp.dv = static_cast<__nv_bfloat16*>(dv);
  cp.B = batch;
  cp.H = H;
  cp.KH = KH;
  cp.Sq = Sq;
  cp.Skv = Skv;
  cp.Sq_pad = (int)sq_pad;
  cp.Skv_pad = (int)skv_pad;
  cp.Dh = Dh;
  const long long pairs = ((long long)batch * Sq * H + 2LL * batch * Skv * KH) * Dh / 2;
  const long long conv_blocks = (pairs + 255) / 256 < 132 * 16 ? (pairs + 255) / 256 : 132 * 16;
  flash_bwd_sm90_convert_kernel<<<(unsigned)conv_blocks, 256, 0, s>>>(cp);
  return (int)cudaGetLastError();
}

// the scratch `flash_attention_bwd_sm90_bf16` needs for these sizes, in
// 4-byte words, into *words; cudaErrorInvalidValue for sizes it refuses
extern "C" int flash_attention_bwd_sm90_scratch(int batch, int H, int KH, int Sq, int Skv,
                                                int Dh, long long* words) {
  if (batch < 1 || H < 1 || KH < 1 || Sq < 1 || Skv < 1 || Dh < 1 || words == nullptr)
    return (int)cudaErrorInvalidValue;
  *words = Scratch(batch, H, Sq, Skv, Dh).total;
  return 0;
}

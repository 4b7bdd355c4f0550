// Block-wise symmetric int8 quantize / dequantize for the DFL wire payload:
// one launch each way for a whole parameter tree.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/quantize/quantize.py:
// `quantize` (body `_q_kernel`) and `dequantize` (body `_dq_kernel`).
//
// A launch takes a table of up to kMaxSegments segments, one per leaf of the
// tree (repro_torch/kernels/quantize/table.py builds it), by value: a
// __grid_constant__ kernel parameter, so there is no copy to the card and no
// sync. A segment's leaf is (lead, last) with the last axis cut into nblocks
// blocks of b <= 256 columns; its block rows are rows [row0, next row0) of
// the launch. Block row r of a segment is lead index r / nblocks, block
// r % nblocks; its columns k * b + c >= last read as 0 (the ragged tail,
// with no padded copy) and quantize to 0. The row API (R, C) is the
// one-segment case: lead R, last = b = C.
//
// quantize, per block row:
//   absmax = max |x|
//   scale  = bf16_rn(max(absmax / 127, 1e-12))            (the bf16 wire grid)
//   q      = clamp(rint(x / scale), -127, 127) as int8
// q goes to the wire layout (*lead, nblocks, b), padding columns included;
// the scale is stored as bf16 (the wire's type) or fp32 (the row API).
// dequantize, per block row: float(q) * scale, written for the columns
// < last straight into the leaf, in fp32 or rounded to bf16.
//
// Bitwise contract: both kernels equal the plain PyTorch versions in
// repro_torch/kernels/quantize/ref.py (and so the JAX package's
// core/compression.py) for q, scales and outputs. What that takes here:
// the max is order-free, so the warp-shuffle reduction is exact; the two
// divisions are IEEE round-to-nearest (__fdiv_rn; never --use_fast_math);
// round-half-to-even is rintf (roundf rounds half away from zero); the bf16
// casts are __float2bfloat16_rn, which is what .to(torch.bfloat16) of the
// fp32 product does. NaN inputs are outside the contract: fmaxf drops a NaN
// from the absmax where jnp.maximum would keep it.
//
// Bound on the card: bytes. Per element quantize reads 4 (or 2) bytes and
// writes 1; dequantize reads 1 and writes 4 (or 2); the arithmetic is at
// most 6 operations an element. So Hopper's TMA and tensor cores are not
// used: coalesced 16-byte loads with enough warps in flight reach the
// bandwidth. A warp owns one block row and keeps its values in registers
// (at most 8 a lane) between the absmax and the quantize pass, so x is read
// once and the reduction needs no shared memory or barrier. Where a
// segment's pointers are 16-byte aligned and b and last hold whole vectors,
// a lane moves 4 fp32 or 8 bf16 values a load and their q in one 4- or
// 8-byte store; else one value a load, lanes on consecutive addresses. On
// the LeNet tree (1168 block rows, 0.54 MB each way) one launch replaces
// the ten per-leaf launches and their scale casts: launch overhead, not
// bandwidth, still sets its time there.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kMaxCols = 256;
constexpr int kPerLane = kMaxCols / 32;
constexpr int kMaxSegments = 64;
// Segment flags (table.py X_BF16, S_BF16, VEC)
constexpr int kXBf16 = 1;  // x (quantize's input, dequantize's output) is bf16
constexpr int kSBf16 = 2;  // the scales are bf16, else fp32
constexpr int kVec = 4;    // 16-byte vectors of x

// One leaf of the launch; table.py SEGMENT has the same layout.
struct Segment {
  void* x;
  int8_t* q;
  void* s;
  long long row0;
  int last, b, nblocks, flags;
};
static_assert(sizeof(Segment) == 48, "layout shared with table.py SEGMENT");

struct Table {
  Segment seg[kMaxSegments];
  long long rows;
  int n;
};
static_assert(sizeof(Table) <= 4096, "the classic kernel parameter limit");

// Where one block row lies: its segment, its row in the segment (the scale's
// index), the element offset of its first column in x and its valid columns.
struct RowAt {
  const Segment* sg;
  long long r;
  long long x0;
  int valid;
};

__device__ __forceinline__ RowAt locate(const Table& t, long long row) {
  int lo = 0, hi = t.n - 1;  // the last segment with row0 <= row
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.seg[mid].row0 <= row) lo = mid; else hi = mid - 1;
  }
  const Segment* sg = &t.seg[lo];
  RowAt at;
  at.sg = sg;
  at.r = row - sg->row0;
  const long long lead = at.r / sg->nblocks;
  const int k = (int)(at.r - lead * sg->nblocks);
  at.x0 = lead * sg->last + (long long)k * sg->b;
  at.valid = min(sg->b, sg->last - k * sg->b);
  return at;
}

// V contiguous values of x at p, as floats
template <typename T, int V>
__device__ __forceinline__ void load_x(const T* p, float* v);
template <>
__device__ __forceinline__ void load_x<float, 1>(const float* p, float* v) {
  v[0] = *p;
}
template <>
__device__ __forceinline__ void load_x<float, 4>(const float* p, float* v) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x; v[1] = u.y; v[2] = u.z; v[3] = u.w;
}
template <>
__device__ __forceinline__ void load_x<__nv_bfloat16, 1>(const __nv_bfloat16* p,
                                                         float* v) {
  v[0] = __bfloat162float(*p);
}
template <>
__device__ __forceinline__ void load_x<__nv_bfloat16, 8>(const __nv_bfloat16* p,
                                                         float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x; v[2 * i + 1] = f.y;
  }
}

// V values to x at p, in x's type
template <typename T, int V>
__device__ __forceinline__ void store_x(T* p, const float* v);
template <>
__device__ __forceinline__ void store_x<float, 1>(float* p, const float* v) {
  *p = v[0];
}
template <>
__device__ __forceinline__ void store_x<float, 4>(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
template <>
__device__ __forceinline__ void store_x<__nv_bfloat16, 1>(__nv_bfloat16* p,
                                                          const float* v) {
  *p = __float2bfloat16_rn(v[0]);
}
template <>
__device__ __forceinline__ void store_x<__nv_bfloat16, 8>(__nv_bfloat16* p,
                                                          const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// V int8 values at p (V = 1, 4 or 8 bytes, aligned to V)
template <int V>
__device__ __forceinline__ void load_q(const int8_t* p, float* v) {
  if constexpr (V == 1) {
    v[0] = (float)*p;
  } else {
    using W = typename std::conditional<V == 4, uint32_t, unsigned long long>::type;
    const W w = *reinterpret_cast<const W*>(p);
#pragma unroll
    for (int e = 0; e < V; ++e) v[e] = (float)(int8_t)(w >> (8 * e));
  }
}

template <int V>
__device__ __forceinline__ void store_q(int8_t* p, const float* v, float scale) {
  using W = typename std::conditional<
      V == 1, uint8_t,
      typename std::conditional<V == 4, uint32_t, unsigned long long>::type>::type;
  W w = 0;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float r = rintf(__fdiv_rn(v[e], scale));
    const int8_t q = (int8_t)fminf(fmaxf(r, -127.f), 127.f);
    w |= (W)(uint8_t)q << (8 * e);
  }
  *reinterpret_cast<W*>(p) = w;
}

// Lane `lane` holds the columns V * lane + 32 * V * j + e (j < kPerLane / V,
// e < V) of a block row: consecutive lanes on consecutive vectors.
template <typename T, int V>
__device__ __forceinline__ void quantize_row(const Segment* sg, const RowAt& at,
                                             int lane) {
  const T* xr = reinterpret_cast<const T*>(sg->x) + at.x0;
  float v[kPerLane];
  float absmax = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane / V; ++j) {
    const int c = V * lane + 32 * V * j;
    if (c < at.valid) {  // V > 1: valid holds whole vectors
      load_x<T, V>(xr + c, v + V * j);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) v[V * j + e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < V; ++e) absmax = fmaxf(absmax, fabsf(v[V * j + e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    absmax = fmaxf(absmax, __shfl_xor_sync(0xffffffffu, absmax, off));
  const float scale = __bfloat162float(
      __float2bfloat16_rn(fmaxf(__fdiv_rn(absmax, 127.f), 1e-12f)));
  int8_t* qr = sg->q + at.r * sg->b;
#pragma unroll
  for (int j = 0; j < kPerLane / V; ++j) {
    const int c = V * lane + 32 * V * j;
    if (c < sg->b) store_q<V>(qr + c, v + V * j, scale);
  }
  if (lane == 0) {
    if (sg->flags & kSBf16)
      reinterpret_cast<__nv_bfloat16*>(sg->s)[at.r] = __float2bfloat16_rn(scale);
    else
      reinterpret_cast<float*>(sg->s)[at.r] = scale;
  }
}

template <typename T, int V>
__device__ __forceinline__ void dequantize_row(const Segment* sg, const RowAt& at,
                                               int lane) {
  const float scale =
      (sg->flags & kSBf16)
          ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(sg->s)[at.r])
          : reinterpret_cast<const float*>(sg->s)[at.r];
  const int8_t* qr = sg->q + at.r * sg->b;
  T* out = reinterpret_cast<T*>(sg->x) + at.x0;
  float v[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane / V; ++j) {  // every load before any store
    const int c = V * lane + 32 * V * j;
    if (c < at.valid) load_q<V>(qr + c, v + V * j);
  }
#pragma unroll
  for (int j = 0; j < kPerLane / V; ++j) {
    const int c = V * lane + 32 * V * j;
    if (c < at.valid) {
#pragma unroll
      for (int e = 0; e < V; ++e) v[V * j + e] *= scale;
      store_x<T, V>(out + c, v + V * j);
    }
  }
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    quantize_kernel(const __grid_constant__ Table t) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= t.rows) return;  // warp-uniform: one block row per warp
  const int lane = threadIdx.x & 31;
  const RowAt at = locate(t, row);
  const int f = at.sg->flags;
  if (f & kXBf16) {
    if (f & kVec) quantize_row<__nv_bfloat16, 8>(at.sg, at, lane);
    else quantize_row<__nv_bfloat16, 1>(at.sg, at, lane);
  } else {
    if (f & kVec) quantize_row<float, 4>(at.sg, at, lane);
    else quantize_row<float, 1>(at.sg, at, lane);
  }
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    dequantize_kernel(const __grid_constant__ Table t) {
  const long long row =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= t.rows) return;
  const int lane = threadIdx.x & 31;
  const RowAt at = locate(t, row);
  const int f = at.sg->flags;
  if (f & kXBf16) {
    if (f & kVec) dequantize_row<__nv_bfloat16, 8>(at.sg, at, lane);
    else dequantize_row<__nv_bfloat16, 1>(at.sg, at, lane);
  } else {
    if (f & kVec) dequantize_row<float, 4>(at.sg, at, lane);
    else dequantize_row<float, 1>(at.sg, at, lane);
  }
}

// The table from the host, checked: segments in row order from row 0, each
// with 1..256 columns a block and rows, and the vector path only where the
// widths and pointers allow it.
int make_table(const void* segments, int n, long long rows, Table* t) {
  if (segments == nullptr || n < 1 || n > kMaxSegments || rows < 1)
    return (int)cudaErrorInvalidValue;
  memset(t, 0, sizeof(Table));
  memcpy(t->seg, segments, (size_t)n * sizeof(Segment));
  t->rows = rows;
  t->n = n;
  for (int i = 0; i < n; ++i) {
    const Segment& s = t->seg[i];
    const long long end = i + 1 < n ? t->seg[i + 1].row0 : rows;
    if (s.b < 1 || s.b > kMaxCols || s.last < 1 || s.nblocks < 1 ||
        (long long)(s.nblocks - 1) * s.b >= s.last ||
        (long long)s.nblocks * s.b < s.last || (i == 0 && s.row0 != 0) ||
        end <= s.row0 || (end - s.row0) % s.nblocks != 0 || !s.x || !s.q || !s.s)
      return (int)cudaErrorInvalidValue;
    if (s.flags & kVec) {
      const int width = (s.flags & kXBf16) ? 8 : 4;
      if (s.b % width || s.last % width || (uintptr_t)s.x % 16 ||
          (uintptr_t)s.q % width)
        return (int)cudaErrorInvalidValue;
    }
  }
  if ((rows + kWarpsPerBlock - 1) / kWarpsPerBlock > INT_MAX)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

template <bool kQuantize>
int launch(const void* segments, int n, long long rows, void* stream) {
  Table t;
  const int status = make_table(segments, n, rows, &t);
  if (status != (int)cudaSuccess) return status;
  const unsigned blocks =
      (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (kQuantize)
    quantize_kernel<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(t);
  else
    dequantize_kernel<<<blocks, 32 * kWarpsPerBlock, 0, (cudaStream_t)stream>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// segments: n host-side Segment rows (table.py SEGMENT); rows: block rows
// of the launch. Returns the launch's cudaGetLastError() (0 = success).
int quantize_segments(const void* segments, int n, long long rows, void* stream) {
  return launch<true>(segments, n, rows, stream);
}

int dequantize_segments(const void* segments, int n, long long rows,
                        void* stream) {
  return launch<false>(segments, n, rows, stream);
}

}  // extern "C"

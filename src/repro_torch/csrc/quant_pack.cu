// Quantize / dequantize kernels of the int8 and int4 gossip wire.
//
// Replaces repro/kernels/codec/quant_pack.py: _quant_kernel (quantize_chunks)
// and _dequant_kernel (dequantize_chunks), with the int4 nibble pack and the
// sign-extending unpack of repro/kernels/codec/ops.py fused in.
//
// Layout: `rows` payloads of `size` f32 each, row-major and contiguous. Each
// row is cut into n_chunks = ceil(size / chunk) chunks; elements past `size`
// read as zero (the wire's per-row zero padding, without a padded copy).
// Codes are (rows * n_chunks, chunk) int8 or (rows * n_chunks, chunk / 2)
// uint8 with the even element in the low nibble; scales are one f32 per chunk.
//
// Bound: bytes. Quantize reads 4 B and writes 1 B (int8) or 0.5 B (int4) per
// element plus 4 B per chunk; one 5.3 M-element EfficientNet-B0 payload is
// 26.5 MB, 7.9 us at 3.35 TB/s. Dequantize moves the same bytes the other
// way.
//
// Quantize. The first design gave each chunk a 256-thread CTA with one float4
// a thread: 16 B in flight, two __syncthreads for a shared-memory absmax,
// then a second read of the chunk, so each of ~5 waves of short CTAs stalled
// on a cold load, a barrier and a second load (27 us on that payload, where
// dequantize, the same grid without the barrier and the second read, took
// 15). Now one warp owns a chunk (8 warps a CTA, the grid's y the row): a
// 1024-element chunk sits in registers, 8 float4 a lane loaded back to back
// (4 KB in flight a warp; at ~60 registers 32 warps an SM, so 4 224 chunks
// at once), the absmax is one redux.sync max on the bits of |x| (which order
// as the non-negative floats do; no shared memory, no barrier), and the
// codes come from the registers, stored as char4 (int8) or uchar2 (int4) a
// float4. A larger chunk loops inside the warp, reading the chunk a second
// time for the codes. What holds it now (PERF.md): a launch's fixed cost of
// ~7 us in the timing, and the dirty lines a timed launch finds in the L2;
// past those it streams at ~85% of the bound. Dequantize keeps its first
// design.
//
// Bit-exactness with jnp.round and numpy: scale = absmax / qmax and x / scale
// are true IEEE divides (no --use_fast_math, no reciprocal), and rintf rounds
// half to even.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // dequantize: one CTA per chunk
constexpr int kQuantWarps = 8;  // quantize: one warp per chunk, 8 a CTA
constexpr int kVecs = 8;        // float4s a lane holds: 1024 elements a warp
constexpr unsigned kFull = 0xffffffffu;

// Elements e..e+3 of a chunk whose first `left` elements are in the row; the
// rest read as 0. VEC: the row is 16-byte aligned and size % 4 == 0, so the 4
// are in range together.
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ in, int e, int left) {
  if (VEC) return e < left ? *reinterpret_cast<const float4*>(in + e) : float4{0, 0, 0, 0};
  float4 v;
  v.x = e < left ? in[e] : 0.f;
  v.y = e + 1 < left ? in[e + 1] : 0.f;
  v.z = e + 2 < left ? in[e + 2] : 0.f;
  v.w = e + 3 < left ? in[e + 3] : 0.f;
  return v;
}

__device__ __forceinline__ unsigned abs_bits(float4 v) {
  return max(max(__float_as_uint(v.x) & 0x7fffffffu, __float_as_uint(v.y) & 0x7fffffffu),
             max(__float_as_uint(v.z) & 0x7fffffffu, __float_as_uint(v.w) & 0x7fffffffu));
}

__device__ __forceinline__ int quant(float x, float scale, float qmax) {
  const float r = rintf(x / scale);  // IEEE divide, round half to even
  return static_cast<int>(fminf(fmaxf(r, -qmax), qmax));
}

// The codes of elements 4q..4q+3 of a chunk whose codes start at `out`.
template <int BITS>
__device__ __forceinline__ void store_codes(uint8_t* __restrict__ out, int q, float4 v,
                                            float scale) {
  constexpr float qmax = BITS == 8 ? 127.f : 7.f;
  const int a = quant(v.x, scale, qmax), b = quant(v.y, scale, qmax);
  const int c = quant(v.z, scale, qmax), d = quant(v.w, scale, qmax);
  if (BITS == 8) {
    reinterpret_cast<char4*>(out)[q] =
        make_char4((signed char)a, (signed char)b, (signed char)c, (signed char)d);
  } else {  // two's-complement nibbles, even element low (ops.py:39-41)
    reinterpret_cast<uchar2*>(out)[q] = make_uchar2((uint8_t)((a & 0xF) | ((b & 0xF) << 4)),
                                                    (uint8_t)((c & 0xF) | ((d & 0xF) << 4)));
  }
}

// One chunk by one warp: `in` at its first element, `left` of them in the row.
template <int BITS, bool VEC>
__device__ __forceinline__ void quantize_chunk(const float* __restrict__ in, int left,
                                               uint8_t* __restrict__ out,
                                               float* __restrict__ scale_out, int chunk,
                                               int lane) {
  const int nvec = chunk / 4;  // float4s in the chunk
  constexpr int kTile = 32 * kVecs;
  float4 v[kVecs];
  unsigned m = 0;  // bits of the lane's largest |x|
  if (nvec <= kTile) {  // the chunk sits in registers
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int q = i * 32 + lane;
      v[i] = q < nvec ? load4<VEC>(in, 4 * q, left) : float4{0, 0, 0, 0};
      m = max(m, abs_bits(v[i]));
    }
  } else {  // first pass: the absmax only
    for (int t = 0; t < nvec; t += kTile) {
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const int q = t + i * 32 + lane;
        v[i] = q < nvec ? load4<VEC>(in, 4 * q, left) : float4{0, 0, 0, 0};
      }
#pragma unroll
      for (int i = 0; i < kVecs; ++i) m = max(m, abs_bits(v[i]));
    }
  }
  const float absmax = __uint_as_float(__reduce_max_sync(kFull, m));
  const float scale = absmax > 0.f ? absmax / (BITS == 8 ? 127.f : 7.f) : 1.0f;
  if (lane == 0) *scale_out = scale;

  if (nvec <= kTile) {
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int q = i * 32 + lane;
      if (q < nvec) store_codes<BITS>(out, q, v[i], scale);
    }
  } else {  // second pass: read the chunk again for the codes
    for (int t = 0; t < nvec; t += kTile) {
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const int q = t + i * 32 + lane;
        v[i] = q < nvec ? load4<VEC>(in, 4 * q, left) : float4{0, 0, 0, 0};
      }
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const int q = t + i * 32 + lane;
        if (q < nvec) store_codes<BITS>(out, q, v[i], scale);
      }
    }
  }
}

// Grid: (chunks of a row / kQuantWarps, rows); a row loop where rows > 65535.
template <int BITS, bool VEC>
__global__ void __launch_bounds__(kQuantWarps * 32)
quantize_kernel(const float* __restrict__ x, uint8_t* __restrict__ codes,
                float* __restrict__ scales, long long rows, long long size,
                long long n_chunks, int chunk) {
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * kQuantWarps + (threadIdx.x >> 5);
  if (c >= n_chunks) return;  // warp-uniform
  const long long base = c * chunk;
  const int left = (int)(size - base < chunk ? size - base : chunk);
  for (long long row_id = blockIdx.y; row_id < rows; row_id += gridDim.y) {
    const long long blk = row_id * n_chunks + c;
    quantize_chunk<BITS, VEC>(x + row_id * size + base, left,
                              codes + blk * (BITS == 8 ? chunk : chunk / 2), scales + blk,
                              chunk, lane);
  }
}

template <int BITS, bool VEC>
int launch_quantize(const void* x, void* codes, void* scales, long long rows, long long size,
                    long long n_chunks, int chunk, cudaStream_t stream) {
  const dim3 grid((unsigned)((n_chunks + kQuantWarps - 1) / kQuantWarps),
                  (unsigned)(rows < 65535 ? rows : 65535));
  quantize_kernel<BITS, VEC><<<grid, kQuantWarps * 32, 0, stream>>>(
      (const float*)x, (uint8_t*)codes, (float*)scales, rows, size, n_chunks, chunk);
  return (int)cudaGetLastError();
}

__device__ __forceinline__ float nibble(uint8_t byte, int shift) {
  const int v = (byte >> shift) & 0xF;
  return static_cast<float>(v >= 8 ? v - 16 : v);  // 4-bit sign extension
}

__global__ void __launch_bounds__(kThreads)
dequantize_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ scales,
                  float* __restrict__ out, long long size, long long n_chunks,
                  int chunk, int bits, bool vec) {
  const long long blk = blockIdx.x;
  const long long row_id = blk / n_chunks;
  const long long base = (blk - row_id * n_chunks) * chunk;
  float* row = out + row_id * size;
  const float scale = scales[blk];
  for (int e = 4 * threadIdx.x; e < chunk; e += 4 * kThreads) {
    if (base + e >= size) break;
    float q[4];
    if (bits == 8) {
      const char4 c = *reinterpret_cast<const char4*>(codes + blk * chunk + e);
      q[0] = c.x; q[1] = c.y; q[2] = c.z; q[3] = c.w;
    } else {
      const uchar2 c = *reinterpret_cast<const uchar2*>(codes + blk * (chunk / 2) + e / 2);
      q[0] = nibble(c.x, 0); q[1] = nibble(c.x, 4);
      q[2] = nibble(c.y, 0); q[3] = nibble(c.y, 4);
    }
    if (vec) {  // size % 4 == 0: the 4 elements are all in range
      *reinterpret_cast<float4*>(row + base + e) =
          make_float4(q[0] * scale, q[1] * scale, q[2] * scale, q[3] * scale);
    } else {
      for (int j = 0; j < 4; ++j)
        if (base + e + j < size) row[base + e + j] = q[j] * scale;
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool bad_args(long long rows, long long n_chunks, int chunk, int bits) {
  return chunk <= 0 || chunk % 4 || (bits != 8 && bits != 4) ||
         rows * n_chunks > 0x7fffffffLL;  // dequantize: one block per chunk, grid.x
}

}  // namespace

// chunk must be a positive multiple of 4; bits 8 or 4.
extern "C" int rt_quantize(const void* x, void* codes, void* scales, long long rows,
                           long long size, long long n_chunks, int chunk, int bits,
                           void* stream) {
  if (rows <= 0 || n_chunks <= 0) return 0;
  if (bad_args(rows, n_chunks, chunk, bits)) return (int)cudaErrorInvalidValue;
  const bool vec = size % 4 == 0 && aligned16(x);
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 8)
    return vec ? launch_quantize<8, true>(x, codes, scales, rows, size, n_chunks, chunk, s)
               : launch_quantize<8, false>(x, codes, scales, rows, size, n_chunks, chunk, s);
  return vec ? launch_quantize<4, true>(x, codes, scales, rows, size, n_chunks, chunk, s)
             : launch_quantize<4, false>(x, codes, scales, rows, size, n_chunks, chunk, s);
}

extern "C" int rt_dequantize(const void* codes, const void* scales, void* out,
                             long long rows, long long size, long long n_chunks,
                             int chunk, int bits, void* stream) {
  if (rows <= 0 || n_chunks <= 0) return 0;
  if (bad_args(rows, n_chunks, chunk, bits)) return (int)cudaErrorInvalidValue;
  const bool vec = size % 4 == 0 && aligned16(out);
  dequantize_kernel<<<(unsigned)(rows * n_chunks), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)codes, (const float*)scales, (float*)out, size, n_chunks, chunk,
      bits, vec);
  return (int)cudaGetLastError();
}

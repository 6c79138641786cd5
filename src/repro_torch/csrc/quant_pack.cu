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
// way. Design: one 256-thread block per chunk, 4 consecutive elements per
// thread (float4 loads where the row is 16-byte aligned), a warp-shuffle and
// shared-memory absmax, then a second pass over the chunk (an L1/L2 hit)
// that writes the codes 4 (int8) or 2 (int4) bytes at a time.
//
// Bit-exactness with jnp.round and numpy: scale = absmax / qmax and x / scale
// are true IEEE divides (no --use_fast_math, no reciprocal), and rintf rounds
// half to even.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Elements e..e+3 of a row; those at or past `size` read as 0.
__device__ __forceinline__ float4 load4(const float* __restrict__ row, long long e,
                                        long long size, bool vec) {
  if (vec && e < size) return *reinterpret_cast<const float4*>(row + e);
  float4 v;
  v.x = e < size ? row[e] : 0.f;
  v.y = e + 1 < size ? row[e + 1] : 0.f;
  v.z = e + 2 < size ? row[e + 2] : 0.f;
  v.w = e + 3 < size ? row[e + 3] : 0.f;
  return v;
}

__device__ __forceinline__ int quant(float x, float scale, float qmax) {
  const float r = rintf(x / scale);  // IEEE divide, round half to even
  return static_cast<int>(fminf(fmaxf(r, -qmax), qmax));
}

__global__ void __launch_bounds__(kThreads)
quantize_kernel(const float* __restrict__ x, uint8_t* __restrict__ codes,
                float* __restrict__ scales, long long size, long long n_chunks,
                int chunk, int bits, bool vec) {
  const long long blk = blockIdx.x;  // global chunk id = row * n_chunks + c
  const long long row_id = blk / n_chunks;
  const long long base = (blk - row_id * n_chunks) * chunk;
  const float* row = x + row_id * size;

  float m = 0.f;
  for (int e = 4 * threadIdx.x; e < chunk; e += 4 * kThreads) {
    const float4 v = load4(row, base + e, size, vec);
    m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)), fmaxf(fabsf(v.z), fabsf(v.w))));
  }
  __shared__ float part[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  m = warp_max(m);
  if (lane == 0) part[warp] = m;
  __syncthreads();
  if (warp == 0) {
    m = warp_max(lane < kThreads / 32 ? part[lane] : 0.f);
    if (lane == 0) part[0] = m;
  }
  __syncthreads();
  const float absmax = part[0];
  const float qmax = bits == 8 ? 127.f : 7.f;
  const float scale = absmax > 0.f ? absmax / qmax : 1.0f;
  if (threadIdx.x == 0) scales[blk] = scale;

  for (int e = 4 * threadIdx.x; e < chunk; e += 4 * kThreads) {
    const float4 v = load4(row, base + e, size, vec);
    const int a = quant(v.x, scale, qmax), b = quant(v.y, scale, qmax);
    const int c = quant(v.z, scale, qmax), d = quant(v.w, scale, qmax);
    if (bits == 8) {
      char4 out = make_char4((signed char)a, (signed char)b, (signed char)c, (signed char)d);
      *reinterpret_cast<char4*>(codes + blk * chunk + e) = out;
    } else {
      // two's-complement nibbles, even element low (ops.py:39-41)
      uchar2 out = make_uchar2((uint8_t)((a & 0xF) | ((b & 0xF) << 4)),
                               (uint8_t)((c & 0xF) | ((d & 0xF) << 4)));
      *reinterpret_cast<uchar2*>(codes + blk * (chunk / 2) + e / 2) = out;
    }
  }
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
         rows * n_chunks > 0x7fffffffLL;  // one block per chunk: grid.x limit
}

}  // namespace

// chunk must be a positive multiple of 4; bits 8 or 4.
extern "C" int rt_quantize(const void* x, void* codes, void* scales, long long rows,
                           long long size, long long n_chunks, int chunk, int bits,
                           void* stream) {
  if (rows <= 0 || n_chunks <= 0) return 0;
  if (bad_args(rows, n_chunks, chunk, bits)) return (int)cudaErrorInvalidValue;
  const bool vec = size % 4 == 0 && aligned16(x);
  quantize_kernel<<<(unsigned)(rows * n_chunks), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (uint8_t*)codes, (float*)scales, size, n_chunks, chunk, bits, vec);
  return (int)cudaGetLastError();
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

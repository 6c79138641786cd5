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
// past those it streams at ~85% of the bound.
//
// Dequantize. A gossip hop decodes every leaf of a tree: the first design
// launched once a leaf (26 launches a hop for whisper-tiny, most of them on
// leaves whose bound is ~0, so the launch's fixed cost was the time) and gave
// each chunk a 256-thread CTA of one 4-byte code load a thread. Now one
// launch decodes a group of leaves (rt_dequantize_group; rt_dequantize
// decodes a lone leaf, passed by value). The group's arenas are leaf-major: leaf l's codes (rows,
// C_l, w), scales (rows, C_l) and output (rows, size_l) are each one
// contiguous slice, the codes and scales from chunk chunk0_l of the arena,
// the output from element out0_l (a multiple of 4), so quantize writes a
// leaf's codes with its own kernel and each decoded leaf is a view. A table
// of the leaves (struct Leaf) is staged in shared memory once a CTA; a warp
// finds the leaf of its chunk by binary search over it. One warp owns a
// chunk, as in quantize: lane l decodes the 4-element units l, l + 32, ...,
// 8 code loads (4 B int8, 2 B int4) issued back to back, then 8 float4
// stores, so every load and store instruction of the warp covers
// consecutive addresses; the scale is one address a warp. A grid of one wave
// (the CTAs the card holds at once, from the occupancy API) strides over
// the group's chunks, and a warp loads its next chunk's codes and scale
// before it stores this one's; a grid of more CTAs than fit (8 an SM at
// 80 registers, 2.7 waves) lost ~5% on large leaves. Loads of 16 codes a
// lane (16 B int8), with each lane's four float4 stores 64 B from the next
// lane's, were slower than the first design on a B0 row (PERF.md): the
// stores' spread, not the loads' width, decides (kUnit). A lone leaf
// (rt_dequantize; the Python wrapper sends a group of one there) of at least
// kCtaChunks chunks takes the first design's kernel instead
// (dequantize_cta_kernel: a 256-thread CTA a chunk, 4 elements a thread, 28
// registers, so 64 warps an SM), which streams a large leaf faster than a
// wave of 80-register warps (PERF.md: 4% on smollm-360m's 180.9 M leaf,
// 176,670 chunks) and loses on small ones (4% on a B0 row). Stores are
// float4 where the output is 16-byte aligned and the unit whole; a leaf
// whose size % 4 != 0 misaligns its later rows, which store element by
// element, as does a row's ragged tail.
//
// Bit-exactness with jnp.round and numpy: scale = absmax / qmax and x / scale
// are true IEEE divides (no --use_fast_math, no reciprocal), and rintf rounds
// half to even. Dequantize is one IEEE multiply an element (__fmul_rn: no
// contraction), so any grid, grouping or load width gives the same bits.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// -- dequantize ----------------------------------------------------------------

// One leaf of a group: its place in the arenas (chunks, f32 elements).
struct Leaf {
  long long chunk0;    // first chunk in the codes and scales arenas
  long long out0;      // first element in the output arena; a multiple of 4
  long long size;      // elements a row
  long long n_chunks;  // chunks a row; 0 for an empty leaf
};

constexpr int kMaxLeaves = 1024;   // a group's table in shared memory: 32 KB
constexpr int kDeqWarps = 8;       // warps a CTA
constexpr int kOwner = 32;         // threads that decode one chunk: a warp
constexpr int kUnit = 4;           // elements a code load decodes: one float4 store
constexpr int kLoads = 8;          // code loads a thread holds: a 1024-element chunk
constexpr bool kPrefetch = true;   // load the next chunk before storing this one
constexpr int kWaves = 1;          // the grid: this many waves of resident CTAs, striding
constexpr int kCtaThreads = 256;   // the CTA body: threads a chunk
constexpr long long kCtaChunks = 16384;  // a lone leaf of this many chunks: the CTA kernel

// Where one chunk of the group is written.
struct Dest {
  float* o;   // the chunk's first output element
  int left;   // its elements in the row: chunk, or fewer at a row's end
  bool vec;   // o is 16-byte aligned: float4 stores
};

// Chunk g's leaf is the last whose chunk0 <= g: an empty leaf shares its
// chunk0 with the leaf after it, so it is never the last.
__device__ __forceinline__ Dest locate(const Leaf* leaves, int n_leaves, long long g,
                                       int chunk, float* __restrict__ out) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].chunk0 <= g)
      lo = mid;
    else
      hi = mid - 1;
  }
  const Leaf& leaf = leaves[lo];
  const long long local = g - leaf.chunk0;
  const long long row = local / leaf.n_chunks;
  const long long base = (local - row * leaf.n_chunks) * chunk;
  Dest d;
  d.o = out + leaf.out0 + row * leaf.size + base;
  d.left = (int)(leaf.size - base < chunk ? leaf.size - base : chunk);
  d.vec = (reinterpret_cast<uintptr_t>(d.o) & 15) == 0;
  return d;
}

// The codes of kUnit consecutive elements: kUnit * BITS / 8 bytes, one load.
template <int BITS>
struct Unit {
  static constexpr int kBytes = kUnit * BITS / 8;
  unsigned w[(kBytes + 3) / 4];
};

template <int BITS>
__device__ __forceinline__ Unit<BITS> load_unit(const uint8_t* __restrict__ codes, int u) {
  constexpr int kBytes = Unit<BITS>::kBytes;
  Unit<BITS> c;
  if constexpr (kBytes == 16) {
    const uint4 v = reinterpret_cast<const uint4*>(codes)[u];
    c.w[0] = v.x, c.w[1] = v.y, c.w[2] = v.z, c.w[3] = v.w;
  } else if constexpr (kBytes == 8) {
    const uint2 v = reinterpret_cast<const uint2*>(codes)[u];
    c.w[0] = v.x, c.w[1] = v.y;
  } else if constexpr (kBytes == 4) {
    c.w[0] = reinterpret_cast<const unsigned*>(codes)[u];
  } else {
    static_assert(kBytes == 2, "a unit's codes are 2, 4, 8 or 16 bytes");
    c.w[0] = reinterpret_cast<const unsigned short*>(codes)[u];
  }
  return c;
}

// Code j of a 32-bit word of codes (little-endian; int4: the even element in
// the low nibble), sign-extended.
template <int BITS>
__device__ __forceinline__ float code(unsigned word, int j) {
  return static_cast<float>(static_cast<int>(word << (32 - BITS * (j + 1))) >> (32 - BITS));
}

// Unit u of a chunk: its kUnit elements, as far as d.left, times the scale.
template <int BITS>
__device__ __forceinline__ void store_unit(const Dest& d, int u, const Unit<BITS>& c,
                                           float scale) {
  constexpr int kPer = 32 / BITS;  // codes a word
  const int e0 = u * kUnit;
  if (d.vec && e0 + kUnit <= d.left) {
#pragma unroll
    for (int k = 0; k < kUnit / 4; ++k) {
      const unsigned word = c.w[4 * k / kPer];
      const int j = 4 * k % kPer;
      reinterpret_cast<float4*>(d.o + e0)[k] = make_float4(
          __fmul_rn(code<BITS>(word, j), scale), __fmul_rn(code<BITS>(word, j + 1), scale),
          __fmul_rn(code<BITS>(word, j + 2), scale), __fmul_rn(code<BITS>(word, j + 3), scale));
    }
  } else {
#pragma unroll
    for (int e = 0; e < kUnit; ++e)
      if (e0 + e < d.left) d.o[e0 + e] = __fmul_rn(code<BITS>(c.w[e / kPer], e % kPer), scale);
  }
}

// Units first + i * kOwner + rank of a chunk (those holding elements below
// `left`): kLoads loads issued back to back.
template <int BITS>
__device__ __forceinline__ void load_units(Unit<BITS> (&c)[kLoads],
                                           const uint8_t* __restrict__ codes, int first,
                                           int left, int rank) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int u = first + i * kOwner + rank;
    if (u * kUnit < left) c[i] = load_unit<BITS>(codes, u);
  }
}

template <int BITS>
__device__ __forceinline__ void store_units(const Dest& d, const Unit<BITS> (&c)[kLoads],
                                            int first, float scale, int rank) {
#pragma unroll
  for (int i = 0; i < kLoads; ++i) {
    const int u = first + i * kOwner + rank;
    if (u * kUnit < d.left) store_unit<BITS>(d, u, c[i], scale);
  }
}

// The group's chunks 0 .. total - 1, kOwner threads a chunk, striding over
// the grid; lane l decodes units l, l + 32, ...: each load and each store
// instruction of a warp covers consecutive addresses. The table comes from
// `table` (device memory), or is `one` alone.
template <int BITS>
__global__ void __launch_bounds__(kDeqWarps * 32)
dequantize_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ scales,
                  float* __restrict__ out, const Leaf* __restrict__ table, Leaf one,
                  int n_leaves, long long total, int chunk) {
  extern __shared__ Leaf leaves[];
  for (int i = threadIdx.x; i < n_leaves; i += blockDim.x) leaves[i] = table ? table[i] : one;
  __syncthreads();
  constexpr int kOwners = kDeqWarps * 32 / kOwner;  // chunks a CTA decodes at once
  const int rank = threadIdx.x % kOwner;
  const long long stride = (long long)gridDim.x * kOwners;
  long long g = (long long)blockIdx.x * kOwners + threadIdx.x / kOwner;
  const int width = chunk * BITS / 8;  // code bytes a chunk
  Unit<BITS> c[kLoads];
  if (chunk > kOwner * kLoads * kUnit) {  // a long chunk: tiles of kOwner x kLoads units
    for (; g < total; g += stride) {
      const Dest d = locate(leaves, n_leaves, g, chunk, out);
      const float s = scales[g];
      for (int t = 0; t * kUnit < d.left; t += kOwner * kLoads) {
        load_units<BITS>(c, codes + g * width, t, d.left, rank);
        store_units<BITS>(d, c, t, s, rank);
      }
    }
    return;
  }
  // the chunk in registers; the next one's codes and scale load before this
  // one's stores
  if (g >= total) return;
  Dest d = locate(leaves, n_leaves, g, chunk, out);
  float s = scales[g];
  load_units<BITS>(c, codes + g * width, 0, d.left, rank);
  for (;;) {
    const long long next = g + stride;
    const bool more = next < total;
    Unit<BITS> cn[kLoads];
    float sn = 0.f;
    Dest dn = d;
    if (kPrefetch && more) {
      dn = locate(leaves, n_leaves, next, chunk, out);
      sn = scales[next];
      load_units<BITS>(cn, codes + next * width, 0, dn.left, rank);
    }
    store_units<BITS>(d, c, 0, s, rank);
    if (!more) return;
    if (!kPrefetch) {
      dn = locate(leaves, n_leaves, next, chunk, out);
      sn = scales[next];
      load_units<BITS>(cn, codes + next * width, 0, dn.left, rank);
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) c[i] = cn[i];
    s = sn;
    d = dn;
    g = next;
  }
}

// A lone leaf of at least kCtaChunks chunks: the first design's kernel,
// unchanged but for BITS as a template argument: a 256-thread CTA a chunk,
// thread t decoding elements 4t..4t+3 (and 4 (t + 256) ... of a longer
// chunk) from one char4 (int8) or uchar2 (int4) code load. vec: size % 4 ==
// 0 and `out` 16-byte aligned, so every 4 elements store as one float4. (A
// version built from the warp body's load_unit / store_unit helpers, 24
// registers, took 0.334 ms on smollm-360m's 180.9 M leaf, where this one
// takes 0.3145, as the first design did.)
__device__ __forceinline__ float nibble(uint8_t byte, int shift) {
  const int v = (byte >> shift) & 0xF;
  return static_cast<float>(v >= 8 ? v - 16 : v);  // 4-bit sign extension
}

template <int BITS>
__global__ void __launch_bounds__(kCtaThreads)
dequantize_cta_kernel(const uint8_t* __restrict__ codes, const float* __restrict__ scales,
                      float* __restrict__ out, long long size, long long n_chunks, int chunk,
                      bool vec) {
  const long long blk = blockIdx.x;
  const long long row_id = blk / n_chunks;
  const long long base = (blk - row_id * n_chunks) * chunk;
  float* row = out + row_id * size;
  const float scale = scales[blk];
  for (int e = 4 * threadIdx.x; e < chunk; e += 4 * kCtaThreads) {
    if (base + e >= size) break;
    float q[4];
    if (BITS == 8) {
      const char4 c = *reinterpret_cast<const char4*>(codes + blk * chunk + e);
      q[0] = c.x; q[1] = c.y; q[2] = c.z; q[3] = c.w;
    } else {
      const uchar2 c = *reinterpret_cast<const uchar2*>(codes + blk * (chunk / 2) + e / 2);
      q[0] = nibble(c.x, 0); q[1] = nibble(c.x, 4);
      q[2] = nibble(c.y, 0); q[3] = nibble(c.y, 4);
    }
    if (vec) {  // the 4 elements are all in range
      *reinterpret_cast<float4*>(row + base + e) =
          make_float4(__fmul_rn(q[0], scale), __fmul_rn(q[1], scale), __fmul_rn(q[2], scale),
                      __fmul_rn(q[3], scale));
    } else {
      for (int j = 0; j < 4; ++j)
        if (base + e + j < size) row[base + e + j] = __fmul_rn(q[j], scale);
    }
  }
}

template <int BITS>
int launch_dequantize(const void* codes, const void* scales, void* out, const Leaf* table,
                      Leaf one, int n_leaves, long long total, int chunk, cudaStream_t stream) {
  static int resident = 0;  // the CTAs the card holds at once: one wave
  if (resident == 0) {
    int device = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dequantize_kernel<BITS>,
                                                  kDeqWarps * 32, kMaxLeaves * sizeof(Leaf));
    resident = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  }
  constexpr int kOwners = kDeqWarps * 32 / kOwner;
  long long grid = (total + kOwners - 1) / kOwners;
  const long long cap = (long long)resident * kWaves;
  if (grid > cap) grid = cap;
  if (grid > 0x7fffffffLL) grid = 0x7fffffffLL;
  dequantize_kernel<BITS><<<(unsigned)grid, kDeqWarps * 32, n_leaves * sizeof(Leaf), stream>>>(
      (const uint8_t*)codes, (const float*)scales, (float*)out, table, one, n_leaves, total,
      chunk);
  return (int)cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

bool bad_args(int chunk, int bits) { return chunk <= 0 || chunk % 4 || (bits != 8 && bits != 4); }

int dequantize(const void* codes, const void* scales, void* out, const Leaf* table, Leaf one,
               int n_leaves, long long total, int chunk, int bits, void* stream) {
  if (total <= 0) return 0;
  if (bad_args(chunk, bits) || n_leaves < 1 || n_leaves > kMaxLeaves)
    return (int)cudaErrorInvalidValue;
  // a unit's codes are one aligned load: kUnit elements of every chunk, and
  // the codes arena on that many codes' bytes
  const int unit_bytes = kUnit * bits / 8;
  if (chunk % kUnit || reinterpret_cast<uintptr_t>(codes) % unit_bytes)
    return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = (cudaStream_t)stream;
  if (!table && total >= kCtaChunks && total <= 0x7fffffffLL) {  // a lone large leaf
    const bool vec = one.size % 4 == 0 && aligned16(out);
    if (bits == 8)
      dequantize_cta_kernel<8><<<(unsigned)total, kCtaThreads, 0, s>>>(
          (const uint8_t*)codes, (const float*)scales, (float*)out, one.size, one.n_chunks,
          chunk, vec);
    else
      dequantize_cta_kernel<4><<<(unsigned)total, kCtaThreads, 0, s>>>(
          (const uint8_t*)codes, (const float*)scales, (float*)out, one.size, one.n_chunks,
          chunk, vec);
    return (int)cudaGetLastError();
  }
  if (bits == 8)
    return launch_dequantize<8>(codes, scales, out, table, one, n_leaves, total, chunk, s);
  return launch_dequantize<4>(codes, scales, out, table, one, n_leaves, total, chunk, s);
}

}  // namespace

// chunk must be a positive multiple of 4; bits 8 or 4.
extern "C" int rt_quantize(const void* x, void* codes, void* scales, long long rows,
                           long long size, long long n_chunks, int chunk, int bits,
                           void* stream) {
  if (rows <= 0 || n_chunks <= 0) return 0;
  if (bad_args(chunk, bits)) return (int)cudaErrorInvalidValue;
  const bool vec = size % 4 == 0 && aligned16(x);
  cudaStream_t s = (cudaStream_t)stream;
  if (bits == 8)
    return vec ? launch_quantize<8, true>(x, codes, scales, rows, size, n_chunks, chunk, s)
               : launch_quantize<8, false>(x, codes, scales, rows, size, n_chunks, chunk, s);
  return vec ? launch_quantize<4, true>(x, codes, scales, rows, size, n_chunks, chunk, s)
             : launch_quantize<4, false>(x, codes, scales, rows, size, n_chunks, chunk, s);
}

// One leaf: `rows` payloads of `size` elements, codes (rows * n_chunks, w).
extern "C" int rt_dequantize(const void* codes, const void* scales, void* out,
                             long long rows, long long size, long long n_chunks,
                             int chunk, int bits, void* stream) {
  if (rows <= 0 || n_chunks <= 0) return 0;
  const Leaf one{0, 0, size, n_chunks};
  return dequantize(codes, scales, out, nullptr, one, 1, rows * n_chunks, chunk, bits, stream);
}

// A group of leaves: `table` is n_leaves Leafs in device memory (n_leaves at
// most 1024), `total` the group's chunks (the codes / scales arenas' rows).
extern "C" int rt_dequantize_group(const void* codes, const void* scales, void* out,
                                   const void* table, int n_leaves, long long total,
                                   int chunk, int bits, void* stream) {
  if (table == nullptr) return (int)cudaErrorInvalidValue;
  return dequantize(codes, scales, out, (const Leaf*)table, Leaf{0, 0, 0, 0}, n_leaves, total,
                    chunk, bits, stream);
}

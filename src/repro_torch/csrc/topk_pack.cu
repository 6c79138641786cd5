// Block-local top-k select + pack kernel of the top-k gossip wire.
//
// Replaces repro/kernels/codec/topk_pack.py: _topk_kernel (topk_select_blocks).
//
// Layout: `rows` payloads of `size` f32 each, contiguous; each row is cut into
// n_blocks = ceil(size / block) blocks, elements past `size` reading as zero
// (the wire's per-row zero padding). Output per block: the k entries of
// largest |x| (ties to the lower index, as lax.top_k and the Pallas
// first-maximum argmax), packed in ascending index order as f32 values and
// i32 indices, (rows * n_blocks, k) each. An all-zero block selects 0..k-1.
//
// Bound: bytes. It reads 4 B per element and writes 8k B per block: one
// 3.5 M-element MobileNetV2 payload (13 672 blocks of 256, k = 13) moves
// 15.4 MB, 4.6 us at 3.35 TB/s. Operations: k rounds of a 5-step warp
// argmax per block, ~k * (block/32 + 10) instructions a lane, far below the
// card's integer rate. Design: one warp per block (8 warps a CTA), lane l
// holding elements j*32 + l for j < block/32 in registers (coalesced loads;
// element order = (j, lane) order, so the pack needs no sort). Each round
// every lane proposes its best unselected element, a butterfly shuffle
// reduction on the key (|x| desc, index asc) agrees on the winner, and its
// owner sets a bit. The pack walks j in order: __ballot_sync of the
// selected bits plus a prefix __popc gives each selected element its rank.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

template <int V>  // values a lane holds = block / 32
__global__ void __launch_bounds__(kWarps * 32)
topk_kernel(const float* __restrict__ x, float* __restrict__ vals, int* __restrict__ idx,
            long long size, long long n_blocks, long long total, int k) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= total) return;  // warp-uniform
  const long long row_id = r / n_blocks;
  const long long base = (r - row_id * n_blocks) * (32LL * V);
  const float* row = x + row_id * size;

  float v[V];
  float mag[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const long long e = base + j * 32 + lane;
    v[j] = e < size ? row[e] : 0.f;
    mag[j] = fabsf(v[j]);
  }

  unsigned sel = 0;  // bit j: element j*32 + lane is selected
  for (int t = 0; t < k; ++t) {
    float best = -1.f;
    int bidx = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      // strict '>' keeps the lowest j (lowest index) among equal magnitudes
      if (!((sel >> j) & 1u) && mag[j] > best) {
        best = mag[j];
        bidx = j * 32 + lane;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bidx, o);
      if (ob > best || (ob == best && oi < bidx)) {
        best = ob;
        bidx = oi;
      }
    }
    if ((bidx & 31) == lane) sel |= 1u << (bidx >> 5);
  }

  float* out_v = vals + r * k;
  int* out_i = idx + r * k;
  int rank0 = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const bool s = (sel >> j) & 1u;
    const unsigned ballot = __ballot_sync(0xffffffffu, s);
    if (s) {
      const int rank = rank0 + __popc(ballot & ((1u << lane) - 1u));
      out_v[rank] = v[j];
      out_i[rank] = j * 32 + lane;
    }
    rank0 += __popc(ballot);
  }
}

template <int V>
int launch(const float* x, float* vals, int* idx, long long size, long long n_blocks,
           long long total, int k, cudaStream_t stream) {
  const long long grid = (total + kWarps - 1) / kWarps;
  topk_kernel<V><<<(unsigned)grid, kWarps * 32, 0, stream>>>(x, vals, idx, size, n_blocks,
                                                            total, k);
  return (int)cudaGetLastError();
}

}  // namespace

#define TOPK_CASE(V) \
  case V:            \
    return launch<V>((const float*)x, (float*)vals, (int*)idx, size, n_blocks, total, k, s);

// block: a multiple of 32, at most 1024; 1 <= k <= block.
extern "C" int rt_topk_select(const void* x, void* vals, void* idx, long long rows,
                              long long size, long long n_blocks, int block, int k,
                              void* stream) {
  if (rows <= 0 || n_blocks <= 0) return 0;
  if (block <= 0 || block % 32 || block > 1024 || k < 1 || k > block)
    return (int)cudaErrorInvalidValue;
  const long long total = rows * n_blocks;
  if ((total + kWarps - 1) / kWarps > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (block / 32) {
    TOPK_CASE(1) TOPK_CASE(2) TOPK_CASE(3) TOPK_CASE(4) TOPK_CASE(5) TOPK_CASE(6)
    TOPK_CASE(7) TOPK_CASE(8) TOPK_CASE(9) TOPK_CASE(10) TOPK_CASE(11) TOPK_CASE(12)
    TOPK_CASE(13) TOPK_CASE(14) TOPK_CASE(15) TOPK_CASE(16) TOPK_CASE(17) TOPK_CASE(18)
    TOPK_CASE(19) TOPK_CASE(20) TOPK_CASE(21) TOPK_CASE(22) TOPK_CASE(23) TOPK_CASE(24)
    TOPK_CASE(25) TOPK_CASE(26) TOPK_CASE(27) TOPK_CASE(28) TOPK_CASE(29) TOPK_CASE(30)
    TOPK_CASE(31) TOPK_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
}

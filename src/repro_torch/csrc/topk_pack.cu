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
// 15.4 MB, 4.6 us at 3.35 TB/s. What held the first design back was its
// instruction count:
// k serial rounds of an argmax, each a scan of a lane's values and a 5-step
// shuffle butterfly (ten shuffles and their compares), ~1 200 instructions a
// warp, 35 us on that payload.
//
// Design: one warp per block, 8 warps a CTA, the grid's y the row (no
// division by the blocks of a row); lane l holds elements j*32 + l for
// j < block/32 in registers (coalesced loads, unchecked where the block is
// whole; element order = (j, lane) order, so the pack needs no sort). Keys
// are the uint32 bits of |x|, which order as the non-negative floats do. A
// threshold select finds T, the k-th largest key, by a bitwise search: each
// step counts the keys at or above a candidate (a subtract and a
// shift-accumulate a value, one redux.sync.add a warp) and keeps the bit
// where at least k remain. The warp's largest key bounds T from above and
// the smallest lane maximum from below (every lane holds a key at or above
// it, so for k <= 32 at least k do); the bits the two share are T's, so the
// search starts below them, and it stops as soon as exactly k keys lie at or
// above the candidate (~8 steps for normal data at k = 13 of 256, 13 from
// bit 30). Then every key above T is taken, and of the keys equal to T the
// lowest-index ones, k in all. The pack walks j in order: __ballot_sync of
// the selected bits plus a prefix __popc gives each selected element its
// rank. What holds it now (PERF.md): the integer instructions of ~8 search steps
// and the per-j pack, and a launch's fixed cost of ~7 us in the timing. The
// other design, k rounds of an argmax in two warp reductions (redux.sync max
// on each lane's best key, then min on the index among the lanes holding
// it), is timed beside it as a variant (python -m repro_torch.kernels.variants).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr unsigned kFull = 0xffffffffu;

// Keys of the warp at or above c (keys < 2^31, c <= 2^31: key - c wraps to
// 2^31 or more exactly where key < c, so its top bit counts those).
template <int V>
__device__ __forceinline__ unsigned count_ge(const unsigned (&key)[V], unsigned c) {
  unsigned below = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) below += (key[j] - c) >> 31;
  return 32u * V - __reduce_add_sync(kFull, below);
}

// Writes the selected elements (sel(j): element j*32 + lane) in ascending
// index order.
template <int V, class Sel>
__device__ __forceinline__ void pack(const float (&v)[V], Sel sel, float* out_v, int* out_i,
                                     int lane) {
  const unsigned below = (1u << lane) - 1u;
  int rank0 = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const bool s = sel(j);
    const unsigned ballot = __ballot_sync(kFull, s);
    if (s) {
      const int rank = rank0 + __popc(ballot & below);
      out_v[rank] = v[j];
      out_i[rank] = j * 32 + lane;
    }
    rank0 += __popc(ballot);
  }
}

// One block: `in` at its first element, `left` elements of the row from there.
template <int V>
__device__ __forceinline__ void select_block(const float* __restrict__ in, long long left,
                                             float* __restrict__ out_v,
                                             int* __restrict__ out_i, int k, int lane) {
  float v[V];
  unsigned key[V];
  if (left >= 32 * V) {  // a whole block: no bounds checks
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = in[j * 32 + lane];
  } else {
#pragma unroll
    for (int j = 0; j < V; ++j) v[j] = j * 32 + lane < left ? in[j * 32 + lane] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < V; ++j) key[j] = __float_as_uint(v[j]) & 0x7fffffffu;

  unsigned lane_max = key[0];
#pragma unroll
  for (int j = 1; j < V; ++j) lane_max = max(lane_max, key[j]);
  const unsigned hi = __reduce_max_sync(kFull, lane_max);
  const unsigned lb = k <= 32 ? __reduce_min_sync(kFull, lane_max) : 0u;
  // T lies in [lb, hi]: it shares the bits above the highest one where they
  // differ, and count_ge(lo) >= k holds from the start
  int b = lb == hi ? -1 : 31 - __clz(lb ^ hi);
  unsigned lo = b < 0 ? hi : lb & ~((2u << b) - 1u);
  bool exact = false;  // exactly k keys at or above lo
  for (; b >= 0; --b) {
    const unsigned c = lo | (1u << b);
    const unsigned n = count_ge<V>(key, c);
    if (n >= (unsigned)k) {
      lo = c;
      if (n == (unsigned)k) {
        exact = true;
        break;
      }
    }
  }
  if (exact) {
    pack<V>(v, [&](int j) { return key[j] >= lo; }, out_v, out_i, lane);
  } else {  // lo = T: the keys above it, then the lowest-index ties
    const int need = k - (int)count_ge<V>(key, lo + 1u);
    const unsigned below = (1u << lane) - 1u;
    int ties = 0;  // keys equal to T at lower indices
    pack<V>(v, [&](int j) {
      const bool eq = key[j] == lo;
      const unsigned be = __ballot_sync(kFull, eq);
      const int rank = ties + __popc(be & below);
      ties += __popc(be);
      return key[j] > lo || (eq && rank < need);
    }, out_v, out_i, lane);
  }
}

template <int V>  // values a lane holds = block / 32
__global__ void __launch_bounds__(kWarps * 32)
topk_kernel(const float* __restrict__ x, float* __restrict__ vals, int* __restrict__ idx,
            long long rows, long long size, long long n_blocks, int k) {
  const int lane = threadIdx.x & 31;
  const long long blk = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;  // warp-uniform
  const long long base = blk * (32LL * V);
  for (long long row_id = blockIdx.y; row_id < rows; row_id += gridDim.y) {
    const long long r = row_id * n_blocks + blk;
    select_block<V>(x + row_id * size + base, size - base, vals + r * k, idx + r * k, k,
                    lane);
  }
}

template <int V>
int launch(const float* x, float* vals, int* idx, long long rows, long long size,
           long long n_blocks, int k, cudaStream_t stream) {
  const dim3 grid((unsigned)((n_blocks + kWarps - 1) / kWarps),
                  (unsigned)(rows < 65535 ? rows : 65535));
  topk_kernel<V><<<grid, kWarps * 32, 0, stream>>>(x, vals, idx, rows, size, n_blocks, k);
  return (int)cudaGetLastError();
}

}  // namespace

#define TOPK_CASE(V) \
  case V:            \
    return launch<V>((const float*)x, (float*)vals, (int*)idx, rows, size, n_blocks, k, s);

// block: a multiple of 32, at most 1024; 1 <= k <= block.
extern "C" int rt_topk_select(const void* x, void* vals, void* idx, long long rows,
                              long long size, long long n_blocks, int block, int k,
                              void* stream) {
  if (rows <= 0 || n_blocks <= 0) return 0;
  if (block <= 0 || block % 32 || block > 1024 || k < 1 || k > block)
    return (int)cudaErrorInvalidValue;
  if ((n_blocks + kWarps - 1) / kWarps > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
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

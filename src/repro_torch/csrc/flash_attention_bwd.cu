// Flash attention backward: dQ, dK and dV of the forward in
// flash_attention.cu, from the row log-sum-exp (LSE) the forward writes.
//
// The TPU package has no backward kernel: its trainer differentiates the
// einsum attention of repro/models/attention.py with XLA. The port's forward
// runs its own kernel in every prefill layer, so training on the card needs
// that kernel's gradient; this is it.
//
// Layout: q, o, dO and dQ (b, sq, H, hd); k, v, dK and dV (b, skv, KV, hd),
// all contiguous, in one type (f32 or bf16; the sums run in f32); LSE and D
// (b, H, sq) f32. Query head h reads kv head h / (H / KV), so dK and dV of a
// kv head sum over its H / KV query heads.
//
// Math, per visible (query i, key j) pair; x = (q_i . k_j) hd^-0.5, t = c
// tanh(x / c) with the softcap c > 0, else t = x:
//   P = exp(t - LSE_i)       (0 where the causal or window mask hides j)
//   dP = dO_i . v_j,  D_i = dO_i . o_i,  dT = P (dP - D_i)
//   dX = dT (1 - (t / c)^2) with the softcap, else dT
//   dQ_i = hd^-0.5 sum_j dX k_j,  dK_j = hd^-0.5 sum_i dX q_i,  dV_j = sum_i P dO_i
// P is recomputed from the LSE; nothing of size s x s is stored.
//
// Bound: operations. Five products of hd per visible pair (S, dP, dQ, dK,
// dV): 10 hd flops. At smollm-360m's training shape (b 2, s 2048, 15 heads,
// hd 64, causal) that is 40 GFLOP, 0.041 ms at the bf16 tensor-core rate and
// 0.60 ms at the 67 TFLOP/s f32 rate; the inputs and outputs are 47 MB
// (0.014 ms at 3.35 TB/s).
//
// Design: two passes, no atomics (two runs give identical gradients):
//   1. dQ: one block per (64 query rows, query head, batch). It streams the
//      key tiles its rows can see (none past the causal diagonal, none wholly
//      below the window), recomputes S and dP on the tile, and accumulates
//      dQ.
//   2. dK and dV: one block per (64-key tile, kv head, batch). It holds its K
//      and V tile, streams the query tiles of every query head in the group
//      that can see it, and accumulates dK and dV over the whole group (GQA
//      takes no scratch and no reduction).
// Seven products a visible pair (S and dP in both passes) against the
// minimum five: the price of determinism without a cross-block sum of dQ.
// Both read D = rowsum(dO o O) from a scratch (b, H, sq), which a first
// launch writes on the tensor-core path and pass 1 on the SIMT path.
//
// bf16 (the training type): the tensor cores through wgmma, fed by TMA, both
// passes in one grid (after the D launch): the dK / dV blocks first, key
// tiles that the most queries see first, then the dQ blocks, longest first,
// so each pass's tail of short blocks runs beside the other's work (one grid
// took 19% less time than two launches at smollm's shape). A block is one
// consumer warpgroup (4 warps, the 64 rows of the block's tile) and one
// producer warp, one thread of which issues every copy: the block's own
// tiles (Q and dO, or K and V) once, then the streamed pair through a ring of
// stages, each completed on its "full" mbarrier and released on its "empty"
// one, in the forward's 128-byte swizzle (64-byte at hd 32; the helpers are
// shared with the forward in hopper.cuh); the dK / dV pass's producer lanes
// also stage each query tile's LSE and D. The dQ pass computes S = Q K^T and
// dP = dO V^T with both operands in shared memory (K-major), turns them into
// dX in registers (P's exponential ex2.approx, the softcap through
// tanh.approx and its chain factor; only tiles that cross the diagonal, the
// window's edge or a ragged end evaluate the per-pair mask), rounds it to
// bf16 in the accumulator layout, which is the A-operand layout of the next
// product, and issues dQ += dX K with K read MN-major through the transpose
// bit. The dK / dV pass computes S^T = K Q^T and dP^T = V dO^T, so its
// fragments are keys x queries and LSE and D index the columns; then dV +=
// P^T dO and dK += dX^T Q, dO and Q read MN-major. Both loops are
// software-pipelined: step i + 1's S and dP are issued right behind step i's
// update products, so the tensor cores run them while the warpgroup comes
// round to wait. At hd 256 a tile's dQ, or its dK and dV, split over two
// blocks of 128 columns that each recompute S and dP over the full head dim:
// 128 columns of dK and dV are 128 f32 registers a thread, as many as one
// warpgroup holds beside S and dP. A head dim that is no whole number of
// such splits (112, 160) is padded inside the kernel, never in memory: each
// tensor map keeps the true hd as its inner extent, so TMA fills the columns
// of the last loaded slab past hd with zeros (the transaction counts the
// whole box), and slabs wholly past hd are not loaded at all. S and dP take
// hd / 16 k-steps, the real columns only. hd 112 runs as one 128-column
// split; hd 160 as two of 128 (the tiles laid out 256 columns wide, as at hd
// 256), the second's last 96 columns never stored: a block's products over
// columns past hd land in accumulators that the epilogue drops, which stores
// the first hd columns at a row pitch of hd. Per visible pair, in products
// of one column: at hd 112 S and dP (twice each) over 112 columns and dQ, dK
// and dV over 128, 832 against 7 x 112 = 784 unpadded (+6%); at hd 160 S and
// dP twice in each pass (once a split) and dQ, dK and dV over 256 columns,
// 2048 against 1120 (+83%; hd 256's own split costs 57% over 7 x 256).
//
// f32, used by the parity checks: SIMT f32 arithmetic, 256 threads a block.
// Thread (ty, tx) of a 16 x 16 block owns score rows ty + 16 r and columns
// tx + 16 c of a tile; the accumulators' rows ty + 16 r and head-dim columns
// tx + 16 c. Shared-memory rows are padded to hd + 1 floats, so the column
// reads of a warp fall in distinct banks. Key tiles are 64 keys, 32 at hd
// 256 (there 64 query rows of Q and dO plus a K and a V tile take 201 KB of
// shared memory in pass 1 and 210 KB in pass 2).
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kBQ = 64;        // query rows per tile

template <int HD>
struct Bwd {
  static constexpr int BK = HD == 256 ? 32 : 64;  // keys per tile
  // key columns (pass 1) or key rows (pass 2) a thread owns
  static constexpr int KC = BK / 16;
  static constexpr int DC = HD / 16;              // head-dim columns a thread owns
  static constexpr int LD = HD + 1;               // padded row stride in shared memory
  static constexpr int PS = BK + 1;               // padded row stride of the P and dX tiles
  static constexpr size_t DQ_SMEM = sizeof(float) * ((2 * kBQ + 2 * BK) * LD + kBQ * PS);
  static constexpr size_t DKV_SMEM = sizeof(float) * ((2 * kBQ + 2 * BK) * LD + 2 * kBQ * PS);
};

template <typename T>
struct BwdArgs {
  const T* q;
  const T* k;
  const T* v;
  const T* o;
  const T* dout;
  const float* lse;  // (b, H, sq)
  float* dd;         // D = rowsum(dO o O), (b, H, sq): written by pass 1, read by pass 2
  T* dq;
  T* dk;
  T* dv;
  int sq, skv, h, kvh;
  int causal, window;
  float softcap, scale;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Whether query qi sees key kj (both paths' argument structs).
template <typename A>
__device__ __forceinline__ bool visible(const A& a, int qi, int kj) {
  return qi < a.sq && kj < a.skv && (!a.causal || kj <= qi) &&
         (a.window == 0 || kj > qi - a.window);
}

// P and dX of one pair from the raw product q . k, dP = dO . v, the row's
// LSE and D.
template <typename T>
__device__ __forceinline__ void pair_grads(const BwdArgs<T>& a, bool vis, float qk, float dp,
                                           float lse, float d, float& p, float& dx) {
  float t = qk * a.scale;
  if (a.softcap > 0.f) t = a.softcap * tanhf(t / a.softcap);
  p = vis ? expf(t - lse) : 0.f;
  dx = p * (dp - d);
  if (a.softcap > 0.f) {
    const float th = t / a.softcap;
    dx *= 1.f - th * th;
  }
}

// Rows [r0, r0 + n) of a (rows, row_stride) tensor's head slice into a
// kBQ- or BK-row tile of shared memory, zeros past `limit`.
template <int HD, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, long long row_stride, int r0,
                                          int n, int limit) {
  constexpr int LD = HD + 1;
  for (int i = threadIdx.x; i < n * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    dst[r * LD + d] = r0 + r < limit ? ld(src + (long long)(r0 + r) * row_stride + d) : 0.f;
  }
}

// Pass 1: D and dQ for 64 query rows of one head.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(BwdArgs<T> a) {
  using B = Bwd<HD>;
  constexpr int BK = B::BK, KC = B::KC, DC = B::DC, LD = B::LD, PS = B::PS;
  extern __shared__ float smem[];
  float* sQ = smem;            // kBQ x LD
  float* sdO = sQ + kBQ * LD;  // kBQ x LD
  float* sK = sdO + kBQ * LD;  // BK x LD
  float* sV = sK + BK * LD;    // BK x LD
  float* sdX = sV + BK * LD;   // kBQ x PS
  __shared__ float sL[kBQ], sD[kBQ];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q_tile = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = q_tile * kBQ, hq = blockIdx.y;
  const long long bi = blockIdx.z;
  const int hk = hq / (a.h / a.kvh);
  const long long q_rs = (long long)a.h * HD, k_rs = (long long)a.kvh * HD;
  const long long q_off = bi * a.sq * q_rs + (long long)hq * HD;
  const long long k_off = bi * a.skv * k_rs + (long long)hk * HD;
  const long long row_off = (bi * a.h + hq) * a.sq;

  load_tile<HD>(sQ, a.q + q_off, q_rs, q0, kBQ, a.sq);
  load_tile<HD>(sdO, a.dout + q_off, q_rs, q0, kBQ, a.sq);
  // D = rowsum(dO o O): a warp per row, lanes striding the head dim
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < kBQ; r += kThreads / 32) {
    const int qi = q0 + r;
    float acc = 0.f;
    if (qi < a.sq) {
      const T* o = a.o + q_off + qi * q_rs;
      const T* g = a.dout + q_off + qi * q_rs;
      for (int d = lane; d < HD; d += 32) acc = fmaf(ld(g + d), ld(o + d), acc);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (lane == 0) {
      sD[r] = acc;
      sL[r] = qi < a.sq ? a.lse[row_off + qi] : 0.f;
      if (qi < a.sq) a.dd[row_off + qi] = acc;
    }
  }
  __syncthreads();

  float lse[4], dd[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    lse[r] = sL[ty + 16 * r];
    dd[r] = sD[ty + 16 * r];
  }
  float acc[4][DC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;

  // the keys this q tile can see: [lo, hi)
  const int q_last = min(q0 + kBQ, a.sq) - 1;
  const int hi = a.causal ? min(a.skv, q_last + 1) : a.skv;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  for (int k0 = (lo / BK) * BK; k0 < hi; k0 += BK) {
    __syncthreads();  // the previous tile's sK, sV and sdX are no longer read
    load_tile<HD>(sK, a.k + k_off, k_rs, k0, BK, a.skv);
    load_tile<HD>(sV, a.v + k_off, k_rs, k0, BK, a.skv);
    __syncthreads();

    float s[4][KC], dp[4][KC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < KC; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[4], gv[4], kv[KC], vv[KC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qv[r] = sQ[(ty + 16 * r) * LD + d];
        gv[r] = sdO[(ty + 16 * r) * LD + d];
      }
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        kv[c] = sK[(tx + 16 * c) * LD + d];
        vv[c] = sV[(tx + 16 * c) * LD + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
          dp[r][c] = fmaf(gv[r], vv[c], dp[r][c]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        float p, dx;
        pair_grads(a, visible(a, q0 + ty + 16 * r, k0 + tx + 16 * c), s[r][c], dp[r][c],
                          lse[r], dd[r], p, dx);
        sdX[(ty + 16 * r) * PS + tx + 16 * c] = dx;
      }
    __syncthreads();  // sdX complete

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) w[r] = sdX[(ty + 16 * r) * PS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kk = sK[j * LD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(w[r], kk, acc[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= a.sq) continue;
    T* row = a.dq + q_off + qi * q_rs;
#pragma unroll
    for (int c = 0; c < DC; ++c) st(row + tx + 16 * c, acc[r][c] * a.scale);
  }
}

// Pass 2: dK and dV for one key tile of one kv head, summed over the query
// heads of its group.
template <int HD, typename T>
__global__ void __launch_bounds__(kThreads) bwd_dkdv_kernel(BwdArgs<T> a) {
  using B = Bwd<HD>;
  constexpr int BK = B::BK, KC = B::KC, DC = B::DC, LD = B::LD, PS = B::PS;
  extern __shared__ float smem[];
  float* sK = smem;            // BK x LD
  float* sV = sK + BK * LD;    // BK x LD
  float* sQ = sV + BK * LD;    // kBQ x LD
  float* sdO = sQ + kBQ * LD;  // kBQ x LD
  float* sP = sdO + kBQ * LD;  // kBQ x PS
  float* sdX = sP + kBQ * PS;  // kBQ x PS
  __shared__ float sL[kBQ], sD[kBQ];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * BK, hk = blockIdx.y;
  const long long bi = blockIdx.z;
  const int group = a.h / a.kvh;
  const long long q_rs = (long long)a.h * HD, k_rs = (long long)a.kvh * HD;
  const long long k_off = bi * a.skv * k_rs + (long long)hk * HD;

  load_tile<HD>(sK, a.k + k_off, k_rs, k0, BK, a.skv);
  load_tile<HD>(sV, a.v + k_off, k_rs, k0, BK, a.skv);

  // the queries that can see this key tile: [q_lo, q_hi)
  const int k_last = min(k0 + BK, a.skv) - 1;
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(a.sq, k_last + a.window) : a.sq;

  float dk[KC][DC], dv[KC][DC];
#pragma unroll
  for (int r = 0; r < KC; ++r)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[r][c] = dv[r][c] = 0.f;

  for (int g = 0; g < group; ++g) {
    const int hq = hk * group + g;
    const long long q_off = bi * a.sq * q_rs + (long long)hq * HD;
    const long long row_off = (bi * a.h + hq) * a.sq;
    for (int q0 = (q_lo / kBQ) * kBQ; q0 < q_hi; q0 += kBQ) {
      __syncthreads();  // the previous tile's sQ, sdO, sP and sdX are no longer read
      load_tile<HD>(sQ, a.q + q_off, q_rs, q0, kBQ, a.sq);
      load_tile<HD>(sdO, a.dout + q_off, q_rs, q0, kBQ, a.sq);
      if (tid < kBQ) {
        const bool in = q0 + tid < a.sq;
        sL[tid] = in ? a.lse[row_off + q0 + tid] : 0.f;
        sD[tid] = in ? a.dd[row_off + q0 + tid] : 0.f;
      }
      __syncthreads();

      // S and dP for query rows ty + 16 r, keys tx + 16 c
      float s[4][KC], dp[4][KC];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < KC; ++c) s[r][c] = dp[r][c] = 0.f;
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float qv[4], gv[4], kv[KC], vv[KC];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qv[r] = sQ[(ty + 16 * r) * LD + d];
          gv[r] = sdO[(ty + 16 * r) * LD + d];
        }
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          kv[c] = sK[(tx + 16 * c) * LD + d];
          vv[c] = sV[(tx + 16 * c) * LD + d];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
            dp[r][c] = fmaf(gv[r], vv[c], dp[r][c]);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty + 16 * r;
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          float p, dx;
          pair_grads(a, visible(a, q0 + i, k0 + tx + 16 * c), s[r][c], dp[r][c], sL[i],
                            sD[i], p, dx);
          sP[i * PS + tx + 16 * c] = p;
          sdX[i * PS + tx + 16 * c] = dx;
        }
      }
      __syncthreads();  // sP and sdX complete

      // dV += P^T dO and dK += dX^T Q for keys ty + 16 r, columns tx + 16 c
#pragma unroll 4
      for (int i = 0; i < kBQ; ++i) {
        float pw[KC], xw[KC];
#pragma unroll
        for (int r = 0; r < KC; ++r) {
          pw[r] = sP[i * PS + ty + 16 * r];
          xw[r] = sdX[i * PS + ty + 16 * r];
        }
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float qv = sQ[i * LD + tx + 16 * c], gv = sdO[i * LD + tx + 16 * c];
#pragma unroll
          for (int r = 0; r < KC; ++r) {
            dv[r][c] = fmaf(pw[r], gv, dv[r][c]);
            dk[r][c] = fmaf(xw[r], qv, dk[r][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < KC; ++r) {
    const int kj = k0 + ty + 16 * r;
    if (kj >= a.skv) continue;
    T* krow = a.dk + k_off + kj * k_rs;
    T* vrow = a.dv + k_off + kj * k_rs;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      st(krow + tx + 16 * c, dk[r][c] * a.scale);
      st(vrow + tx + 16 * c, dv[r][c]);
    }
  }
}

template <int HD, typename T>
int launch(const BwdArgs<T>& a, int b, cudaStream_t stream) {
  using B = Bwd<HD>;
  static std::atomic<uint32_t> dq_set{0}, dkv_set{0};
  cudaError_t err = opt_in_smem(bwd_dq_kernel<HD, T>, (int)B::DQ_SMEM, dq_set);
  if (err != cudaSuccess) return (int)err;
  err = opt_in_smem(bwd_dkdv_kernel<HD, T>, (int)B::DKV_SMEM, dkv_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((a.sq + kBQ - 1) / kBQ, a.h, b);
  bwd_dq_kernel<HD, T><<<grid_q, kThreads, B::DQ_SMEM, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((a.skv + B::BK - 1) / B::BK, a.kvh, b);
  bwd_dkdv_kernel<HD, T><<<grid_k, kThreads, B::DKV_SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------ bf16: wgmma fed by TMA

constexpr int kTcThreads = 160;  // one consumer warpgroup (threads 0-127), one producer warp
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct TcTile {
  static constexpr int SLAB = HD < 64 ? HD : 64;  // head-dim columns per swizzled slab
  static constexpr int ROW = SLAB * 2;            // bytes in one slab row: 128 (64 at hd 32)
  static constexpr int NLOAD = (HD + SLAB - 1) / SLAB;  // slabs that hold columns of hd
  static constexpr uint64_t SWIZZLE = ROW == 128 ? 1 : 2;  // wgmma layout: 128 B or 64 B
  // gradient columns one block accumulates: above 128 a tile's dQ (or dK and
  // dV) splits over blocks of 128 columns, each recomputing S and dP; the
  // tiles are laid out HP columns wide, hd padded to whole splits
  static constexpr int COLS = NLOAD * SLAB < 128 ? NLOAD * SLAB : 128;
  static constexpr int HP = (HD + COLS - 1) / COLS * COLS;
  static constexpr int SPLIT = HP / COLS;
  static constexpr int CSLAB = COLS / SLAB;
  // threads of the D launch a row: a power of two, one 16-byte load each
  static constexpr int D_LANES = HD <= 32 ? 4 : HD <= 64 ? 8 : HD <= 128 ? 16 : 32;
  // queries a dK / dV step streams: 32 at hd 64, which keeps the kernel at
  // 144 registers (2 blocks an SM: with 5 warps a block, a quadrant of the
  // register file holds 3 warps of at most 168 registers), 64 above (32 took
  // 12-20% longer at hd 128 and 256)
  static constexpr int BM = HD <= 64 ? 32 : 64;
  static constexpr int BN = 64;     // keys a dQ step streams
  // depth of the streamed ring: a stage is released half a step late (the
  // pipelined loops), so 3 where shared memory allows
  static constexpr int STAGES = HD <= 128 ? 3 : 2;
  static constexpr int FIX = 64 * HP * 2;  // a block's own 64-row tile of Q, dO or K, V
  static constexpr int Q_STEP = BM * HP * 2, K_STEP = BN * HP * 2;
  // the bytes TMA writes into each: the loaded slabs, zero-filled past hd
  static constexpr int FIX_TX = 64 * NLOAD * ROW, Q_TX = BM * NLOAD * ROW, K_TX = BN * NLOAD * ROW;
  // 1 KB of slack to align the tiles to the 1 KB swizzle atom, the two fixed
  // tiles, the ring of two streamed tiles, and 1 + 2 x STAGES mbarriers
  static constexpr int BARS = 8 * (1 + 2 * STAGES);
  static constexpr int DQ_SMEM = 1024 + 2 * FIX + 2 * STAGES * K_STEP + BARS;
  static constexpr int DKV_SMEM = 1024 + 2 * FIX + 2 * STAGES * Q_STEP + BARS;
  static_assert(HD % 16 == 0 && HD <= 8 * D_LANES && DQ_SMEM <= 232448 && DKV_SMEM <= 232448,
                "a head dim the tiles do not take");
};

struct TcArgs {
  const __nv_bfloat16* o;     // o and dO: the D launch reads them
  const __nv_bfloat16* dout;
  const float* lse;           // (b, H, sq), natural units
  float* dd;                  // D, (b, H, sq): written by the D launch, read by both passes
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int b, sq, skv, h, kvh;
  int causal, window;
  int softcap;       // whether t = c tanh(x / c)
  float pre, post;   // base-2 logit: post tanh(pre s) with the softcap, else pre s
  float scale;       // hd^-0.5
};

// P and dX of one pair: P = 2^(t - LSE log2 e) with t the base-2 logit
// (softcapped), dX = P (dP - D), times the softcap's chain factor 1 - tanh^2.
// Reads the raw score s = q . k and dP and writes neither (the pipelined
// loops keep product registers out of the elementwise code's writes).
__device__ __forceinline__ float tc_grads(const TcArgs& a, float s, float dp, float lse2, float d,
                                          float& p) {
  float chain = 1.f;
  if (a.softcap) {
    const float th = tanh_approx(a.pre * s);
    p = exp2_approx(fmaf(a.post, th, -lse2));
    chain = fmaf(-th, th, 1.f);
  } else {
    p = exp2_approx(fmaf(s, a.pre, -lse2));
  }
  return p * (dp - d) * chain;
}

// X = A B^T over the head dim, both K-major in shared memory: A a 64-row
// tile, B a tile of N rows; one commit group.
template <int HD, int N>
__device__ __forceinline__ void issue_ss(float (&x)[N / 2], uint64_t a, uint64_t b) {
  using T = TcTile<HD>;
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int slab = kk * 16 / T::SLAB, off = (kk * 16 % T::SLAB) * 2;
    Mma<N>::ss(x, desc_at(a, slab * 64 * T::ROW + off), desc_at(b, slab * N * T::ROW + off),
               kk > 0);
  }
  wg_commit();
}

// acc += A B over K rows: A from registers (K / 16 steps), B a K-row tile
// read MN-major (the transpose bit) from `b`, at its slabs from `slab0` on.
template <int HD, int K>
__device__ __forceinline__ void issue_rs(float (&acc)[TcTile<HD>::CSLAB][TcTile<HD>::SLAB / 2],
                                         const uint32_t (&a)[K / 16][4], uint64_t b, int slab0) {
  using T = TcTile<HD>;
#pragma unroll
  for (int j = 0; j < T::CSLAB; ++j)
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
      Mma<T::SLAB>::rs(acc[j], a[kk], desc_at(b, (slab0 + j) * K * T::ROW + kk * 16 * T::ROW));
}

// Zero an accumulator, pinned where it stands: the compiler would otherwise
// sink the zeroing to the first product, inside the pipeline of products
// already in flight, and ptxas then serializes every wgmma of the kernel.
template <int HD>
__device__ __forceinline__ void zero(float (&acc)[TcTile<HD>::CSLAB][TcTile<HD>::SLAB / 2]) {
#pragma unroll
  for (int j = 0; j < TcTile<HD>::CSLAB; ++j) {
#pragma unroll
    for (int e = 0; e < TcTile<HD>::SLAB / 2; ++e) acc[j][e] = 0.f;
    pin(acc[j]);
  }
}

// Rows r and r + 8 of a 64-row accumulator block (the thread's rows) to bf16
// rows of `out` (row stride `rs` elements), times `mul`: the first `cols`
// columns of the block's (the rest lie past hd).
template <int HD>
__device__ __forceinline__ void store_rows(
    __nv_bfloat16* out, long long rs, int r, int limit,
    const float (&acc)[TcTile<HD>::CSLAB][TcTile<HD>::SLAB / 2], float mul, int cq, int cols) {
  using T = TcTile<HD>;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (r + 8 * h >= limit) continue;
    __nv_bfloat16* row = out + (long long)(r + 8 * h) * rs + cq;
#pragma unroll
    for (int j = 0; j < T::CSLAB; ++j)
#pragma unroll
      for (int c = 0; c < T::SLAB / 8; ++c)
        if (j * T::SLAB + 8 * c < cols)
          *reinterpret_cast<uint32_t*>(row + j * T::SLAB + 8 * c) =
              pack_bf16(acc[j][4 * c + 2 * h] * mul, acc[j][4 * c + 2 * h + 1] * mul);
  }
}

// Whether a tile's elementwise pass evaluates the per-pair mask, as a type,
// so each of the two passes is compiled apart.
template <bool M>
struct Mask {
  static constexpr bool value = M;
};

// The fixed tiles' barrier, then each stage's "full" barrier (`arrivals`
// arrive on it) and its "empty" one.
__device__ __forceinline__ void init_barriers(uint32_t fix_full, uint32_t full, uint32_t empty,
                                              int stages, int arrivals) {
  if (threadIdx.x == 0) {
    mbar_init(fix_full, 1);
    for (int st = 0; st < stages; ++st) {
      mbar_init(full + 8 * st, arrivals);
      mbar_init(empty + 8 * st, 128);  // every consumer thread releases the stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// D = rowsum(dO o O) of every query row, (b, H, sq): D_LANES threads a row
// (a power of two), each 16 bytes of o and of dO, or nothing past hd. Both
// passes' blocks read it.
template <int HD>
__global__ void __launch_bounds__(256) bwd_d_kernel(TcArgs a) {
  constexpr int L = TcTile<HD>::D_LANES;
  const long long t = blockIdx.x * 256ll + threadIdx.x, row = t / L;  // (batch, query, head)
  const int c = (int)(t % L);
  const bool row_in = row < (long long)a.b * a.sq * a.h, in = row_in && c < HD / 8;
  float acc = 0.f;
  if (in) {
    const uint4 ov = *reinterpret_cast<const uint4*>(a.o + row * HD + c * 8);
    const uint4 gv = *reinterpret_cast<const uint4*>(a.dout + row * HD + c * 8);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
    const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const float2 of = __bfloat1622float2(op[x]), gf = __bfloat1622float2(gp[x]);
      acc = fmaf(of.x, gf.x, fmaf(of.y, gf.y, acc));
    }
  }
#pragma unroll
  for (int off = L / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (row_in && c == 0) {
    const long long hq = row % a.h, qi = row / a.h % a.sq, bi = row / a.h / a.sq;
    a.dd[(bi * a.h + hq) * a.sq + qi] = acc;
  }
}

// The dQ pass: dQ for 64 query rows of one head (the columns of one split),
// streaming the key tiles the rows can see; `block` counts the pass's
// blocks.
template <int HD>
__device__ __forceinline__ void dq_block(const CUtensorMap& tq, const CUtensorMap& tdo,
                                         const CUtensorMap& tk, const CUtensorMap& tv,
                                         const TcArgs& a, int block) {
  using T = TcTile<HD>;
  constexpr int BN = T::BN, ROW = T::ROW, SLAB = T::SLAB, S = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + T::FIX, sK = sdO + T::FIX, sV = sK + S * T::K_STEP;
  const uint32_t fix_full = sV + S * T::K_STEP, full = fix_full + 8, empty = full + 8 * S;

  // block -> (q tile, split, head, batch), the q tile slowest; causal q
  // tiles in reverse, so the longest start first
  const int per = T::SPLIT * a.h * a.b, n_qt = (a.sq + 63) / 64;
  int rest = block % per;
  const int q_tile = a.causal ? n_qt - 1 - block / per : block / per;
  const int split = rest % T::SPLIT;
  rest /= T::SPLIT;
  const int hq = rest % a.h, bi = rest / a.h, hk = hq / (a.h / a.kvh), q0 = q_tile * 64;
  // the key tiles these rows can see: [t_lo, t_hi)
  const int q_last = min(q0 + 64, a.sq) - 1;
  const int hi = a.causal ? min(a.skv, q_last + 1) : a.skv;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_lo = lo / BN, t_hi = hi > lo ? (hi + BN - 1) / BN : t_lo;

  init_barriers(fix_full, full, empty, S, 1);
  if (threadIdx.x >= 128) {  // producer warp: one thread issues every copy
    if (threadIdx.x == 128) {
      mbar_expect_tx(fix_full, 2 * T::FIX_TX);
      for (int j = 0; j < T::NLOAD; ++j) {
        tma_load(sQ + j * 64 * ROW, &tq, fix_full, j * SLAB, hq, q0, bi);
        tma_load(sdO + j * 64 * ROW, &tdo, fix_full, j * SLAB, hq, q0, bi);
      }
      for (int t = t_lo; t < t_hi; ++t) {
        const int i = t - t_lo, st = i % S, avail = ((i / S) & 1) ^ 1;
        mbar_wait(empty + 8 * st, avail);
        mbar_expect_tx(full + 8 * st, 2 * T::K_TX);
        for (int j = 0; j < T::NLOAD; ++j) {
          tma_load(sK + st * T::K_STEP + j * BN * ROW, &tk, full + 8 * st, j * SLAB, hk, t * BN,
                   bi);
          tma_load(sV + st * T::K_STEP + j * BN * ROW, &tv, full + 8 * st, j * SLAB, hk, t * BN,
                   bi);
        }
      }
    }
    return;
  }

  const int tid = threadIdx.x, lane = tid % 32, cq = 2 * (lane % 4);
  const int r0 = 16 * (tid / 32) + lane / 4;  // the thread's rows of the tile: r0, r0 + 8
  const long long row_off = ((long long)bi * a.h + hq) * a.sq;
  float lse2[2], dr[2];  // the thread's rows' LSE (base 2) and D
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + r0 + 8 * h;
    dr[h] = qi < a.sq ? a.dd[row_off + qi] : 0.f;
    lse2[h] = qi < a.sq ? a.lse[row_off + qi] * kLog2e : 0.f;
  }
  float dq[T::CSLAB][SLAB / 2];
  zero<HD>(dq);
  // Q, dO and K, V K-major (the leading offset is unused under a swizzle); K
  // also MN-major as dQ += dX K's B operand
  const uint64_t dQa = smem_desc(sQ, 16, 8 * ROW, T::SWIZZLE);
  const uint64_t ddOa = smem_desc(sdO, 16, 8 * ROW, T::SWIZZLE);
  const uint64_t dKb = smem_desc(sK, 16, 8 * ROW, T::SWIZZLE);
  const uint64_t dVb = smem_desc(sV, 16, 8 * ROW, T::SWIZZLE);
  const uint64_t dKt = smem_desc(sK, 8 * ROW, 8 * ROW, T::SWIZZLE);

  // Software-pipelined over the key tiles: tile i + 1's S and dP are issued
  // right behind tile i's dQ product, so the tensor cores run them while
  // this warpgroup comes round to wait for them; tile i's stage is released
  // once its dQ product has landed, at the top of step i + 1.
  const int n_iter = t_hi - t_lo;
  float s[BN / 2], dp[BN / 2];  // S = Q K^T and dP = dO V^T
  uint32_t x[BN / 16][4];       // dX, the A operand of dQ += dX K
  mbar_wait(fix_full, 0);
  if (n_iter > 0) mbar_wait(full, 0);
  issue_ss<HD, BN>(s, dQa, dKb);
  issue_ss<HD, BN>(dp, ddOa, dVb);
  for (int i = 0; i < n_iter; ++i) {
    const int st = i % S, k0 = (t_lo + i) * BN;
    // S and dP have landed, and tile i - 1's dQ product before them
    wg_wait();
    pin(s);
    pin(dp);
    if (i > 0) {
      pin(x);
      mbar_arrive(empty + 8 * ((i - 1) % S));
    }
    // only tiles that cross the diagonal, the window's edge, sq or skv
    // evaluate the mask
    const bool clear = q0 + 64 <= a.sq && k0 + BN <= a.skv && (!a.causal || k0 + BN - 1 <= q0) &&
                       (a.window == 0 || k0 > q0 + 63 - a.window);
    // dX rounded to bf16 in the A-operand layout; the mask a compile-time
    // choice, so a clear tile carries none of it
    auto grads = [&](auto masked) {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int h4 = 0; h4 < 4; ++h4) {
          float v2[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 8 * kk + 2 * h4 + c, h = h4 & 1;
            float pr;
            v2[c] = tc_grads(a, s[e], dp[e], lse2[h], dr[h], pr);
            if (decltype(masked)::value &&
                !visible(a, q0 + r0 + 8 * h, k0 + 8 * (e >> 2) + cq + c))
              v2[c] = 0.f;
          }
          x[kk][h4] = pack_bf16(v2[0], v2[1]);
        }
    };
    if (clear)
      grads(Mask<false>());
    else
      grads(Mask<true>());
    wg_fence();
    issue_rs<HD, BN>(dq, x, desc_at(dKt, st * T::K_STEP), split * T::CSLAB);
    wg_commit();
    // issued on every path (after the last step, on a stale stage, and
    // never read), so the product pipeline has one shape for ptxas
    const int nst = (i + 1) % S;
    if (i + 1 < n_iter) mbar_wait(full + 8 * nst, ((i + 1) / S) & 1);
    issue_ss<HD, BN>(s, dQa, desc_at(dKb, nst * T::K_STEP));
    issue_ss<HD, BN>(dp, ddOa, desc_at(dVb, nst * T::K_STEP));
  }
  wg_wait();
#pragma unroll
  for (int j = 0; j < T::CSLAB; ++j) pin(dq[j]);
  if (n_iter > 0) {
    pin(x);
    mbar_arrive(empty + 8 * ((n_iter - 1) % S));
  }
  const long long rs = (long long)a.h * HD;
  store_rows<HD>(a.dq + ((long long)bi * a.sq + q0) * rs + (long long)hq * HD + split * T::COLS,
                 rs, r0, a.sq - q0, dq, a.scale, cq, HD - split * T::COLS);
}

// The dK / dV pass: dK and dV for 64 keys of one kv head (the columns of one
// split), streaming the query tiles that see them, head after head of the
// kv head's group, so the group's sum stays in registers.
template <int HD>
__device__ __forceinline__ void dkdv_block(const CUtensorMap& tk, const CUtensorMap& tv,
                                           const CUtensorMap& tq, const CUtensorMap& tdo,
                                           const TcArgs& a, int block) {
  using T = TcTile<HD>;
  constexpr int BM = T::BM, ROW = T::ROW, SLAB = T::SLAB, S = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // each stage's LSE (base 2) and D of its BM queries, which the producer
  // warp's lanes store beside the TMA copies
  __shared__ float sLD[S][2][BM];
  const uint32_t sK = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + T::FIX, sQ = sV + T::FIX, sdO = sQ + S * T::Q_STEP;
  const uint32_t fix_full = sdO + S * T::Q_STEP, full = fix_full + 8, empty = full + 8 * S;

  // block -> (key tile, split, kv head, batch), the key tile slowest: under
  // causal the first key tiles, which the most queries see, start first
  const int per = T::SPLIT * a.kvh * a.b;
  int rest = block % per;
  const int k0 = block / per * 64;
  const int split = rest % T::SPLIT;
  rest /= T::SPLIT;
  const int hk = rest % a.kvh, bi = rest / a.kvh, group = a.h / a.kvh;
  // the query tiles that see these keys: [t_lo, t_hi), for each query head
  const int k_last = min(k0 + 64, a.skv) - 1;
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(a.sq, k_last + a.window) : a.sq;
  const int t_lo = q_lo / BM, t_hi = q_hi > q_lo ? (q_hi + BM - 1) / BM : t_lo;

  // a stage is full once its copies have landed and the 32 producer lanes
  // have stored its LSE and D
  init_barriers(fix_full, full, empty, S, 1 + 32);
  if (threadIdx.x >= 128) {  // producer warp
    const int lane = threadIdx.x - 128;
    if (lane == 0) {
      mbar_expect_tx(fix_full, 2 * T::FIX_TX);
      for (int j = 0; j < T::NLOAD; ++j) {
        tma_load(sK + j * 64 * ROW, &tk, fix_full, j * SLAB, hk, k0, bi);
        tma_load(sV + j * 64 * ROW, &tv, fix_full, j * SLAB, hk, k0, bi);
      }
    }
    int i = 0;
    for (int g = 0; g < group; ++g) {
      const int hq = hk * group + g;
      const long long row_off = ((long long)bi * a.h + hq) * a.sq;
      for (int t = t_lo; t < t_hi; ++t, ++i) {
        const int st = i % S, avail = ((i / S) & 1) ^ 1;
        mbar_wait(empty + 8 * st, avail);
        if (lane == 0) {
          mbar_expect_tx(full + 8 * st, 2 * T::Q_TX);
          for (int j = 0; j < T::NLOAD; ++j) {
            tma_load(sQ + st * T::Q_STEP + j * BM * ROW, &tq, full + 8 * st, j * SLAB, hq,
                     t * BM, bi);
            tma_load(sdO + st * T::Q_STEP + j * BM * ROW, &tdo, full + 8 * st, j * SLAB, hq,
                     t * BM, bi);
          }
        }
        for (int c = lane; c < BM; c += 32) {
          const int qi = t * BM + c;
          const bool in = qi < a.sq;
          sLD[st][0][c] = in ? a.lse[row_off + qi] * kLog2e : 0.f;
          sLD[st][1][c] = in ? a.dd[row_off + qi] : 0.f;
        }
        mbar_arrive(full + 8 * st);
      }
    }
    return;
  }

  const int tid = threadIdx.x, lane = tid % 32, cq = 2 * (lane % 4);
  const int r0 = 16 * (tid / 32) + lane / 4;  // the thread's keys of the tile: r0, r0 + 8
  float dk[T::CSLAB][SLAB / 2], dv[T::CSLAB][SLAB / 2];
  zero<HD>(dk);
  zero<HD>(dv);
  // K, V and Q, dO K-major for S^T = K Q^T and dP^T = V dO^T; Q and dO also
  // MN-major as the B operands of dK += dX^T Q and dV += P^T dO
  const uint64_t dKa = smem_desc(sK, 16, 8 * ROW, T::SWIZZLE);
  const uint64_t dVa = smem_desc(sV, 16, 8 * ROW, T::SWIZZLE);
  const uint64_t dQb = smem_desc(sQ, 16, 8 * ROW, T::SWIZZLE);
  const uint64_t ddOb = smem_desc(sdO, 16, 8 * ROW, T::SWIZZLE);
  const uint64_t dQt = smem_desc(sQ, 8 * ROW, 8 * ROW, T::SWIZZLE);
  const uint64_t ddOt = smem_desc(sdO, 8 * ROW, 8 * ROW, T::SWIZZLE);

  // Software-pipelined over the (query head, query tile) steps, as the dQ
  // pass: step i + 1's S^T and dP^T are issued right behind step i's dV and
  // dK products.
  const int n_t = t_hi - t_lo, n_iter = group * n_t;
  float s[BM / 2], dp[BM / 2];  // S^T and dP^T: keys x queries
  uint32_t p[BM / 16][4], x[BM / 16][4];  // P^T and dX^T, the A operands
  mbar_wait(fix_full, 0);
  if (n_iter > 0) mbar_wait(full, 0);
  issue_ss<HD, BM>(s, dKa, dQb);
  issue_ss<HD, BM>(dp, dVa, ddOb);
  for (int i = 0; i < n_iter; ++i) {
    const int st = i % S, q0 = (t_lo + i % n_t) * BM;
    const float* lse2 = sLD[st][0];
    const float* dcol = sLD[st][1];
    const bool clear = q0 + BM <= a.sq && k0 + 64 <= a.skv && (!a.causal || k0 + 63 <= q0) &&
                       (a.window == 0 || k0 > q0 + BM - 1 - a.window);
    // S^T and dP^T have landed, and step i - 1's products before them
    wg_wait();
    pin(s);
    pin(dp);
    if (i > 0) {
      pin(p);
      pin(x);
      mbar_arrive(empty + 8 * ((i - 1) % S));
    }
    // P^T and dX^T rounded to bf16 in the A-operand layout (the mask a
    // compile-time choice, so a clear tile carries none of it)
    auto grads = [&](auto masked) {
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk)
#pragma unroll
        for (int h4 = 0; h4 < 4; ++h4) {
          float p2[2], x2[2];
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int e = 8 * kk + 2 * h4 + c, col = 8 * (e >> 2) + cq + c;
            x2[c] = tc_grads(a, s[e], dp[e], lse2[col], dcol[col], p2[c]);
            if (decltype(masked)::value &&
                !visible(a, q0 + col, k0 + r0 + 8 * (h4 & 1)))
              p2[c] = x2[c] = 0.f;
          }
          p[kk][h4] = pack_bf16(p2[0], p2[1]);
          x[kk][h4] = pack_bf16(x2[0], x2[1]);
        }
    };
    if (clear)
      grads(Mask<false>());
    else
      grads(Mask<true>());
    wg_fence();
    issue_rs<HD, BM>(dv, p, desc_at(ddOt, st * T::Q_STEP), split * T::CSLAB);
    wg_commit();
    wg_fence();
    issue_rs<HD, BM>(dk, x, desc_at(dQt, st * T::Q_STEP), split * T::CSLAB);
    wg_commit();
    const int nst = (i + 1) % S;  // issued on every path, as in the dQ pass
    if (i + 1 < n_iter) mbar_wait(full + 8 * nst, ((i + 1) / S) & 1);
    issue_ss<HD, BM>(s, dKa, desc_at(dQb, nst * T::Q_STEP));
    issue_ss<HD, BM>(dp, dVa, desc_at(ddOb, nst * T::Q_STEP));
  }
  wg_wait();
#pragma unroll
  for (int j = 0; j < T::CSLAB; ++j) {
    pin(dk[j]);
    pin(dv[j]);
  }
  if (n_iter > 0) {
    pin(p);
    pin(x);
    mbar_arrive(empty + 8 * ((n_iter - 1) % S));
  }
  const long long rs = (long long)a.kvh * HD;
  const long long off = ((long long)bi * a.skv + k0) * rs + (long long)hk * HD + split * T::COLS;
  store_rows<HD>(a.dk + off, rs, r0, a.skv - k0, dk, a.scale, cq, HD - split * T::COLS);
  store_rows<HD>(a.dv + off, rs, r0, a.skv - k0, dv, 1.f, cq, HD - split * T::COLS);
}

// Both passes in one grid: the dK / dV blocks first (longest first), then
// the dQ blocks, so each pass's tail of short blocks runs beside the other's
// work.
template <int HD>
__global__ void __launch_bounds__(kTcThreads, 1)
bwd_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tdo,
              const __grid_constant__ CUtensorMap tk, const __grid_constant__ CUtensorMap tv,
              const __grid_constant__ CUtensorMap tq_bm, const __grid_constant__ CUtensorMap tdo_bm,
              TcArgs a, int n_dkdv) {
  if ((int)blockIdx.x < n_dkdv)
    dkdv_block<HD>(tk, tv, tq_bm, tdo_bm, a, blockIdx.x);
  else
    dq_block<HD>(tq, tdo, tk, tv, a, blockIdx.x - n_dkdv);
}

// D, then both passes in one grid, on the stream.
template <int HD>
int launch_tc(const void* q, const void* k, const void* v, const TcArgs& a, cudaStream_t stream) {
  using T = TcTile<HD>;
  const long long qs = (long long)a.h * HD, ks = (long long)a.kvh * HD;
  CUtensorMap q64, do64, qbm, dobm, k64, v64;
  if (!make_map(&q64, q, HD, a.h, a.sq, a.b, HD, qs, qs * a.sq, T::SLAB, 64) ||
      !make_map(&do64, a.dout, HD, a.h, a.sq, a.b, HD, qs, qs * a.sq, T::SLAB, 64) ||
      !make_map(&qbm, q, HD, a.h, a.sq, a.b, HD, qs, qs * a.sq, T::SLAB, T::BM) ||
      !make_map(&dobm, a.dout, HD, a.h, a.sq, a.b, HD, qs, qs * a.sq, T::SLAB, T::BM) ||
      !make_map(&k64, k, HD, a.kvh, a.skv, a.b, HD, ks, ks * a.skv, T::SLAB, 64) ||
      !make_map(&v64, v, HD, a.kvh, a.skv, a.b, HD, ks, ks * a.skv, T::SLAB, 64))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = T::DQ_SMEM > T::DKV_SMEM ? T::DQ_SMEM : T::DKV_SMEM;
  static std::atomic<uint32_t> smem_set{0};
  cudaError_t err = opt_in_smem(bwd_tc_kernel<HD>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  const long long threads = (long long)a.b * a.sq * a.h * T::D_LANES;
  bwd_d_kernel<HD><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_dkdv = (a.skv + 63) / 64 * T::SPLIT * a.kvh * a.b;
  const int n_dq = (a.sq + 63) / 64 * T::SPLIT * a.h * a.b;
  bwd_tc_kernel<HD><<<n_dkdv + n_dq, kTcThreads, smem, stream>>>(q64, do64, k64, v64, qbm, dobm,
                                                                 a, n_dkdv);
  return (int)cudaGetLastError();
}

int dispatch_f32(const BwdArgs<float>& a, int b, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32, float>(a, b, stream);
    case 64: return launch<64, float>(a, b, stream);
    case 112: return launch<112, float>(a, b, stream);
    case 128: return launch<128, float>(a, b, stream);
    case 160: return launch<160, float>(a, b, stream);
    case 256: return launch<256, float>(a, b, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch_bf16(const void* q, const void* k, const void* v, const TcArgs& a, int hd,
                  cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_tc<32>(q, k, v, a, stream);
    case 64: return launch_tc<64>(q, k, v, a, stream);
    case 112: return launch_tc<112>(q, k, v, a, stream);
    case 128: return launch_tc<128>(q, k, v, a, stream);
    case 160: return launch_tc<160>(q, k, v, a, stream);
    case 256: return launch_tc<256>(q, k, v, a, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o, dout, dq (b, sq, h, hd); k, v, dk, dv (b, skv, kvh, hd); lse and the
// scratch dd (b, h, sq) f32; all contiguous, 16-byte aligned. dtype 0 = f32,
// 1 = bf16; hd in {32, 64, 112, 128, 160, 256}; kvh divides h; b and h at most 65535.
// `ws` is unused: it keeps the signature of the earlier kernels, so the
// variants harness can load either file through one entry point.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* lse, const void* dout, void* dd, void* dq,
                                      void* dk, void* dv, void* ws, int b, int sq, int skv, int h,
                                      int kvh, int hd, int causal, int window, float softcap,
                                      int dtype, void* stream) {
  (void)ws;
  if (b <= 0 || sq <= 0 || skv <= 0) return 0;
  if (h <= 0 || kvh <= 0 || h % kvh || h > 65535 || b > 65535 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float scale = 1.0f / sqrtf((float)hd);
  if (dtype == 0) {
    const BwdArgs<float> a{static_cast<const float*>(q),    static_cast<const float*>(k),
                           static_cast<const float*>(v),    static_cast<const float*>(o),
                           static_cast<const float*>(dout), static_cast<const float*>(lse),
                           static_cast<float*>(dd),         static_cast<float*>(dq),
                           static_cast<float*>(dk),         static_cast<float*>(dv),
                           sq, skv, h, kvh, causal, window, softcap, scale};
    return dispatch_f32(a, b, hd, s);
  }
  if (dtype == 1) {
    const TcArgs a{static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
                   static_cast<const float*>(lse), static_cast<float*>(dd),
                   static_cast<__nv_bfloat16*>(dq), static_cast<__nv_bfloat16*>(dk),
                   static_cast<__nv_bfloat16*>(dv), b, sq, skv, h, kvh, causal, window,
                   softcap > 0.f, softcap > 0.f ? scale / softcap : scale * kLog2e,
                   softcap * kLog2e, scale};
    return dispatch_bf16(q, k, v, a, hd, s);
  }
  return (int)cudaErrorInvalidValue;
}

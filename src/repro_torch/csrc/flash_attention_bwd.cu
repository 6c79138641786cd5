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
// Design: two launches from one entry point (three on the tensor cores under
// GQA, below), no atomics (two runs give identical gradients):
//   1. dQ: one block per (64 query rows, query head, batch). It computes D
//      for its rows (written to a scratch (b, H, sq) for pass 2), then streams
//      the key tiles its rows can see (none past the causal diagonal, none
//      wholly below the window) through shared memory, recomputes S and dP on
//      the tile, and accumulates dQ in registers.
//   2. dK and dV: one block per (64-key tile, kv head, batch). It holds its K
//      and V tile in shared memory, streams the query tiles of every query
//      head in the group that can see it, and accumulates dK and dV in
//      registers.
// Causal query tiles launch longest first in pass 1; in pass 2 the first key
// tiles, which the most queries see, are the first blocks anyway.
//
// bf16 at hd <= 128 (smollm's training path): the tensor cores through
// mma.sync m16n8k16 (bf16 in, f32 sums), 4 warps a block, each owning 16 of
// the tile's 64 rows. The tiles sit in shared memory as bf16 rows padded by
// 16 bytes (conflict-free fragment loads); the streamed ones (K and V in
// pass 1, Q, dO, LSE and D in pass 2) arrive by cp.async into two stages,
// the next tile's copies in flight while the current one is computed. S and
// dP come out of the products in the accumulator layout, which is the
// A-operand layout of the next product once rounded to bf16 (P and dX never
// leave registers); tiles wholly inside the visible region skip the per-pair
// mask, and P's exponential is ex2.approx. Every other fragment comes from
// shared memory by ldmatrix.x4 (one A fragment or
// the B fragments of two n-blocks an instruction); the B operand of dQ +=
// dX K, dV += P^T dO and dK += dX^T Q reads its tile down the rows through
// ldmatrix's transpose. Pass 2 takes one block per (key tile, query head,
// batch), so a key tile's work does not run serially over its H / KV query
// heads; under GQA each block writes its head's share of dK and dV to an
// f32 scratch, and a third launch sums the shares in head order.
//
// f32, and bf16 at hd 256: SIMT f32 arithmetic, 256 threads a block. Thread
// (ty, tx) of a 16 x 16 block owns score rows ty + 16 r and columns tx + 16 c
// of a tile; the accumulators' rows ty + 16 r and head-dim columns tx + 16 c.
// Shared-memory rows are padded to hd + 1 floats, so the column reads of a
// warp fall in distinct banks. Key tiles are 64 keys, 32 at hd 256 (there 64
// query rows of Q and dO plus a K and a V tile take 201 KB of shared memory
// in pass 1 and 210 KB in pass 2).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

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
  float* ws;  // tensor-core pass 2 under GQA: per-query-head dK and dV, 2 x (b, skv, H, hd) f32
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float x) { *p = x; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T>
__device__ __forceinline__ bool visible(const BwdArgs<T>& a, int qi, int kj) {
  return qi < a.sq && kj < a.skv && (!a.causal || kj <= qi) &&
         (a.window == 0 || kj > qi - a.window);
}

// P and dX of one pair from the raw product q . k, dP = dO . v, the row's
// LSE and D. With Approx the exponential is ex2.approx (2^-22 of its value),
// for the tensor-core passes, which round P and dX to bf16 next.
template <bool Approx, typename T>
__device__ __forceinline__ void pair_grads(const BwdArgs<T>& a, bool vis, float qk, float dp,
                                           float lse, float d, float& p, float& dx) {
  float t = qk * a.scale;
  if (a.softcap > 0.f) t = a.softcap * tanhf(t / a.softcap);
  float e;
  if (Approx)
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(e) : "f"((t - lse) * 1.4426950408889634f));
  else
    e = expf(t - lse);
  p = vis ? e : 0.f;
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
        pair_grads<false>(a, visible(a, q0 + ty + 16 * r, k0 + tx + 16 * c), s[r][c], dp[r][c],
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
          pair_grads<false>(a, visible(a, q0 + i, k0 + tx + 16 * c), s[r][c], dp[r][c], sL[i],
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

// ------------------------------------------- bf16 at hd <= 128: mma.sync

constexpr int kMmaThreads = 128;  // 4 warps, 16 rows of a 64-row tile each
constexpr int kMT = 64;           // query rows (pass 1) or keys (pass 2) per tile

template <int HD>
struct MmaTile {
  static constexpr int LDS = HD + 8;  // bf16 row stride in shared memory: 16 bytes of pad
  static constexpr int KS = HD / 16;  // k-steps of 16 over the head dim
  static constexpr int NH = HD / 8;   // n-blocks of 8 over the head dim
  // the block's two fixed tiles and two stages of the two streamed ones
  static constexpr size_t SMEM = sizeof(__nv_bfloat16) * 6 * kMT * LDS;
};

typedef __nv_bfloat16 bf16;

// D (16 x 8, f32) += A (16 x 16) B (16 x 8), bf16 operands. Thread t of the
// warp, g = t / 4, c = 2 (t % 4): A's registers hold (row g, cols c, c + 1),
// (g + 8, c..), (g, c + 8..), (g + 8, c + 8..); B's (k c, c + 1; n g) and
// (k c + 8, c + 9; n g); D's (row g, cols c, c + 1) and (g + 8, c, c + 1).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2f(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four 8 x 8 bf16 matrices from shared memory, lane l giving the address of
// row l % 8 of matrix l / 8; register i holds matrix i's fragment: (row g,
// cols c, c + 1), or with .trans (rows c, c + 1; col g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// cp.async: 16 (or 4) bytes from global to shared memory without passing
// through registers; with `in` false nothing is read and zeros are written.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's committed copy groups are in
// flight.
__device__ __forceinline__ void cp_async_wait(bool pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 64 rows of a head slice into a bf16 tile of shared memory, 16 bytes a
// thread by cp.async, zeros past `limit`.
template <int HD>
__device__ __forceinline__ void load_bf16_tile(bf16* dst, const bf16* src, long long row_stride,
                                               int r0, int limit) {
  constexpr int V = HD / 8;
  for (int i = threadIdx.x; i < kMT * V; i += kMmaThreads) {
    const int r = i / V, col = (i % V) * 8;
    const bool in = r0 + r < limit;
    cp_async16(dst + r * MmaTile<HD>::LDS + col, in ? src + (r0 + r) * row_stride + col : src,
               in);
  }
}

// S = X Y^T and dP = Z W^T over the head dim for the warp's 16 rows of X and
// Z (row offset r) against the 64 rows of Y and W: 8 n-blocks of 8. One
// ldmatrix.x4 gives an A fragment (16 rows x 16 columns) or the B fragments
// of two n-blocks.
template <int HD>
__device__ __forceinline__ void scores(float (&s)[8][4], float (&dp)[8][4], const bf16* x,
                                       const bf16* z, const bf16* y, const bf16* w, int r,
                                       int lane) {
  constexpr int LDS = MmaTile<HD>::LDS;
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
  // A: matrices (rows 0-7, cols 0-7), (8-15, 0-7), (0-7, 8-15), (8-15, 8-15)
  const int a_off = (r + (lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 8;
  // B of n-blocks nb, nb + 1: (rows 0-7, k 0-7), (0-7, k 8-15), (8-15, 0-7), (8-15, 8-15)
  const int b_off = ((lane & 7) + (lane >> 4) * 8) * LDS + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks) {
    uint32_t ax[4], az[4];
    ldmatrix_x4(ax, x + a_off + ks * 16);
    ldmatrix_x4(az, z + a_off + ks * 16);
#pragma unroll
    for (int nb = 0; nb < 8; nb += 2) {
      uint32_t by[4], bw[4];
      ldmatrix_x4(by, y + nb * 8 * LDS + b_off + ks * 16);
      ldmatrix_x4(bw, w + nb * 8 * LDS + b_off + ks * 16);
      mma16816(s[nb], ax, by[0], by[1]);
      mma16816(s[nb + 1], ax, by[2], by[3]);
      mma16816(dp[nb], az, bw[0], bw[1]);
      mma16816(dp[nb + 1], az, bw[2], bw[3]);
    }
  }
}

// acc (16 x HD) += A B over 64 rows of k: A from the fragments `f` (16 x 64,
// the C layout of `scores`, rounded to bf16), B the 64 x HD tile `b` read
// down its rows (ldmatrix .trans: two n-blocks an instruction).
template <int HD>
__device__ __forceinline__ void accumulate(float (&acc)[HD / 8][4], const float (&f)[8][4],
                                           const bf16* b, int lane) {
  constexpr int LDS = MmaTile<HD>::LDS;
  // matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
  const int b_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {pack2f(f[2 * kk][0], f[2 * kk][1]), pack2f(f[2 * kk][2], f[2 * kk][3]),
                           pack2f(f[2 * kk + 1][0], f[2 * kk + 1][1]),
                           pack2f(f[2 * kk + 1][2], f[2 * kk + 1][3])};
#pragma unroll
    for (int nb = 0; nb < HD / 8; nb += 2) {
      uint32_t bm[4];
      ldmatrix_x4_trans(bm, b + kk * 16 * LDS + nb * 8 + b_off);
      mma16816(acc[nb], a, bm[0], bm[1]);
      mma16816(acc[nb + 1], a, bm[2], bm[3]);
    }
  }
}

// Whether every (query, key) pair of a 64 x 64 tile is visible: such a tile
// (all but the diagonal and window-edge ones) skips the per-pair mask.
__device__ __forceinline__ bool clear_tile(const BwdArgs<bf16>& a, int q0, int k0) {
  return q0 + kMT <= a.sq && k0 + kMT <= a.skv && (!a.causal || k0 + kMT - 1 <= q0) &&
         (a.window == 0 || k0 > q0 + kMT - 1 - a.window);
}

// dX in place of the scores of the warp's 16 query rows (pass 1); Clear
// drops the mask.
template <bool Clear>
__device__ __forceinline__ void dq_tile_grads(const BwdArgs<bf16>& a, float (&s)[8][4],
                                              const float (&dp)[8][4], int qr, int k0,
                                              const float (&lse)[2], const float (&dd)[2], int c) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1;
      const bool vis = Clear || visible(a, qr + 8 * h, k0 + nb * 8 + c + (e & 1));
      float p;
      pair_grads<true>(a, vis, s[nb][e], dp[nb][e], lse[h], dd[h], p, s[nb][e]);
    }
}

// P in place of the scores and dX in place of dP for the warp's 16 keys
// (pass 2), the 64 queries' LSE and D from `lse` and `dd`; Clear drops the
// mask.
template <bool Clear>
__device__ __forceinline__ void dkdv_tile_grads(const BwdArgs<bf16>& a, float (&s)[8][4],
                                                float (&dp)[8][4], int q0, int kr,
                                                const float* lse, const float* dd, int c) {
#pragma unroll
  for (int nb = 0; nb < 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = nb * 8 + c + (e & 1);
      const bool vis = Clear || visible(a, q0 + i, kr + 8 * (e >> 1));
      pair_grads<true>(a, vis, s[nb][e], dp[nb][e], lse[i], dd[i], s[nb][e], dp[nb][e]);
    }
}

// Pass 1 on the tensor cores: D and dQ for 64 query rows of one head, a warp
// per 16 rows.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads) bwd_dq_mma_kernel(BwdArgs<bf16> a) {
  constexpr int LDS = MmaTile<HD>::LDS, NH = MmaTile<HD>::NH;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(mma_smem);
  bf16* sdO = sQ + kMT * LDS;
  bf16* sK = sdO + kMT * LDS;   // two stages of K, then two of V
  bf16* sV = sK + 2 * kMT * LDS;
  __shared__ float sL[kMT], sD[kMT];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = 2 * (lane % 4);
  const int q_tile = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = q_tile * kMT, hq = blockIdx.y;
  const long long bi = blockIdx.z;
  const int hk = hq / (a.h / a.kvh);
  const long long q_rs = (long long)a.h * HD, k_rs = (long long)a.kvh * HD;
  const long long q_off = bi * a.sq * q_rs + (long long)hq * HD;
  const long long k_off = bi * a.skv * k_rs + (long long)hk * HD;
  const long long row_off = (bi * a.h + hq) * a.sq;

  // the keys this q tile can see: tiles [t0, t_end), each streamed into one
  // of two stages while the other's is computed
  const int q_last = min(q0 + kMT, a.sq) - 1;
  const int hi = a.causal ? min(a.skv, q_last + 1) : a.skv;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t0 = lo / kMT, t_end = hi > lo ? (hi + kMT - 1) / kMT : t0;
  auto issue = [&](int t) {
    const int st = (t - t0) & 1;
    load_bf16_tile<HD>(sK + st * kMT * LDS, a.k + k_off, k_rs, t * kMT, a.skv);
    load_bf16_tile<HD>(sV + st * kMT * LDS, a.v + k_off, k_rs, t * kMT, a.skv);
    cp_async_commit();
  };
  load_bf16_tile<HD>(sQ, a.q + q_off, q_rs, q0, a.sq);
  load_bf16_tile<HD>(sdO, a.dout + q_off, q_rs, q0, a.sq);
  if (t0 < t_end)
    issue(t0);  // with Q and dO in its group
  else
    cp_async_commit();
  for (int r = warp; r < kMT; r += kMmaThreads / 32) {  // D = rowsum(dO o O)
    const int qi = q0 + r;
    float acc = 0.f;
    if (qi < a.sq) {
      const bf16* o = a.o + q_off + qi * q_rs;
      const bf16* gr = a.dout + q_off + qi * q_rs;
      for (int d = lane; d < HD; d += 32) acc = fmaf(ld(gr + d), ld(o + d), acc);
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

  const int r0 = 16 * warp;  // the warp's rows: r0 + g and r0 + g + 8
  const float lse[2] = {sL[r0 + g], sL[r0 + g + 8]}, dd[2] = {sD[r0 + g], sD[r0 + g + 8]};
  float dq[NH][4];
#pragma unroll
  for (int nb = 0; nb < NH; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[nb][e] = 0.f;

  for (int t = t0; t < t_end; ++t) {
    const int k0 = t * kMT, st = (t - t0) & 1;
    if (t + 1 < t_end) issue(t + 1);  // into the stage tile t - 1 used
    cp_async_wait(t + 1 < t_end);
    __syncthreads();  // tile t has landed for every thread
    const bf16* tK = sK + st * kMT * LDS;
    float s[8][4], dp[8][4];
    scores<HD>(s, dp, sQ, sdO, tK, sV + st * kMT * LDS, r0, lane);
    if (clear_tile(a, q0, k0))
      dq_tile_grads<true>(a, s, dp, q0 + r0 + g, k0, lse, dd, c);
    else
      dq_tile_grads<false>(a, s, dp, q0 + r0 + g, k0, lse, dd, c);
    accumulate<HD>(dq, s, tK, lane);
    __syncthreads();  // the stage is free for tile t + 2
  }
  cp_async_wait(false);  // no copy outlives the block

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = q0 + r0 + g + 8 * h;
    if (qi >= a.sq) continue;
    bf16* row = a.dq + q_off + qi * q_rs;
#pragma unroll
    for (int nb = 0; nb < NH; ++nb)
      *reinterpret_cast<uint32_t*>(row + nb * 8 + c) =
          pack2f(dq[nb][2 * h] * a.scale, dq[nb][2 * h + 1] * a.scale);
  }
}

// Pass 2 on the tensor cores: dK and dV for 64 keys of one kv head from one
// of its query heads, a warp per 16 keys. Without GQA that is dK and dV; with
// it the head's share goes to the scratch `ws` in f32, and
// bwd_group_sum_kernel sums the group's shares in head order.
template <int HD>
__global__ void __launch_bounds__(kMmaThreads) bwd_dkdv_mma_kernel(BwdArgs<bf16> a) {
  constexpr int LDS = MmaTile<HD>::LDS, NH = MmaTile<HD>::NH;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* sK = reinterpret_cast<bf16*>(mma_smem);
  bf16* sV = sK + kMT * LDS;
  bf16* sQ = sV + kMT * LDS;     // two stages of Q, then two of dO
  bf16* sdO = sQ + 2 * kMT * LDS;
  __shared__ float sL[2][kMT], sD[2][kMT];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, c = 2 * (lane % 4);
  const int k0 = blockIdx.x * kMT, hq = blockIdx.y;
  const long long bi = blockIdx.z;
  const int hk = hq / (a.h / a.kvh);
  const long long q_rs = (long long)a.h * HD, k_rs = (long long)a.kvh * HD;
  const long long k_off = bi * a.skv * k_rs + (long long)hk * HD;
  const long long q_off = bi * a.sq * q_rs + (long long)hq * HD;
  const long long row_off = (bi * a.h + hq) * a.sq;
  // the queries that can see this key tile: tiles [t0, t_end), each streamed
  // into one of two stages while the other's is computed
  const int k_last = min(k0 + kMT, a.skv) - 1;
  const int q_lo = a.causal ? k0 : 0;
  const int q_hi = a.window > 0 ? min(a.sq, k_last + a.window) : a.sq;
  const int t0 = q_lo / kMT, t_end = q_hi > q_lo ? (q_hi + kMT - 1) / kMT : t0;
  auto issue = [&](int t) {
    const int st = (t - t0) & 1, q0 = t * kMT;
    load_bf16_tile<HD>(sQ + st * kMT * LDS, a.q + q_off, q_rs, q0, a.sq);
    load_bf16_tile<HD>(sdO + st * kMT * LDS, a.dout + q_off, q_rs, q0, a.sq);
    if (threadIdx.x < 2 * kMT) {  // LSE and D of the tile's rows
      const int j = threadIdx.x % kMT;
      const bool in = q0 + j < a.sq;
      const float* src = threadIdx.x < kMT ? a.lse : a.dd;
      cp_async4((threadIdx.x < kMT ? sL[st] : sD[st]) + j, in ? src + row_off + q0 + j : src, in);
    }
    cp_async_commit();
  };
  load_bf16_tile<HD>(sK, a.k + k_off, k_rs, k0, a.skv);
  load_bf16_tile<HD>(sV, a.v + k_off, k_rs, k0, a.skv);
  if (t0 < t_end)
    issue(t0);  // with K and V in its group
  else
    cp_async_commit();
  const int r0 = 16 * warp;  // the warp's keys: r0 + g and r0 + g + 8
  float dk[NH][4], dv[NH][4];
#pragma unroll
  for (int nb = 0; nb < NH; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nb][e] = dv[nb][e] = 0.f;

  for (int t = t0; t < t_end; ++t) {
    const int q0 = t * kMT, st = (t - t0) & 1;
    if (t + 1 < t_end) issue(t + 1);  // into the stage tile t - 1 used
    cp_async_wait(t + 1 < t_end);
    __syncthreads();  // tile t has landed for every thread
    const bf16* tQ = sQ + st * kMT * LDS;
    const bf16* tdO = sdO + st * kMT * LDS;
    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys x 64 queries
    float s[8][4], dp[8][4];
    scores<HD>(s, dp, sK, sV, tQ, tdO, r0, lane);
    if (clear_tile(a, q0, k0))
      dkdv_tile_grads<true>(a, s, dp, q0, k0 + r0 + g, sL[st], sD[st], c);
    else
      dkdv_tile_grads<false>(a, s, dp, q0, k0 + r0 + g, sL[st], sD[st], c);
    accumulate<HD>(dv, s, tdO, lane);  // dV += P^T dO
    accumulate<HD>(dk, dp, tQ, lane);  // dK += dX^T Q
    __syncthreads();  // the stage is free for tile t + 2
  }
  cp_async_wait(false);  // no copy outlives the block

  const bool direct = a.h == a.kvh;
  const long long ws_half = (long long)gridDim.z * a.skv * q_rs;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kj = k0 + r0 + g + 8 * h;
    if (kj >= a.skv) continue;
    if (direct) {
      bf16* krow = a.dk + k_off + kj * k_rs;
      bf16* vrow = a.dv + k_off + kj * k_rs;
#pragma unroll
      for (int nb = 0; nb < NH; ++nb) {
        *reinterpret_cast<uint32_t*>(krow + nb * 8 + c) =
            pack2f(dk[nb][2 * h] * a.scale, dk[nb][2 * h + 1] * a.scale);
        *reinterpret_cast<uint32_t*>(vrow + nb * 8 + c) =
            pack2f(dv[nb][2 * h], dv[nb][2 * h + 1]);
      }
    } else {
      float* wrow = a.ws + (bi * a.skv + kj) * q_rs + (long long)hq * HD;
#pragma unroll
      for (int nb = 0; nb < NH; ++nb) {
        *reinterpret_cast<float2*>(wrow + nb * 8 + c) =
            make_float2(dk[nb][2 * h] * a.scale, dk[nb][2 * h + 1] * a.scale);
        *reinterpret_cast<float2*>(wrow + ws_half + nb * 8 + c) =
            make_float2(dv[nb][2 * h], dv[nb][2 * h + 1]);
      }
    }
  }
}

// Under GQA: dK and dV of each kv head, the sum in head order of its query
// heads' shares in `ws` (deterministic), rounded to bf16.
__global__ void __launch_bounds__(256) bwd_group_sum_kernel(BwdArgs<bf16> a, int hd,
                                                            long long n_out) {
  const int group = a.h / a.kvh;
  const long long ws_half = n_out * group;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n_out;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / hd;  // (b, s, kv head)
    const int d = (int)(i % hd), hk = (int)(row % a.kvh);
    const float* w = a.ws + ((row / a.kvh) * a.h + (long long)hk * group) * hd + d;
    float sk = 0.f, sv = 0.f;
    for (int gi = 0; gi < group; ++gi) {
      sk += w[gi * hd];
      sv += w[ws_half + gi * hd];
    }
    a.dk[i] = __float2bfloat16(sk);
    a.dv[i] = __float2bfloat16(sv);
  }
}

// Opt a kernel in to `bytes` of dynamic shared memory, once per device.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, int bytes, std::atomic<uint32_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = 1u << (dev & 31);
  if (done.load(std::memory_order_acquire) & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
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

template <int HD>
int launch_mma(const BwdArgs<bf16>& a, int b, cudaStream_t stream) {
  constexpr size_t bytes = MmaTile<HD>::SMEM;
  static std::atomic<uint32_t> dq_set{0}, dkv_set{0};
  cudaError_t err = opt_in_smem(bwd_dq_mma_kernel<HD>, (int)bytes, dq_set);
  if (err != cudaSuccess) return (int)err;
  err = opt_in_smem(bwd_dkdv_mma_kernel<HD>, (int)bytes, dkv_set);
  if (err != cudaSuccess) return (int)err;
  bwd_dq_mma_kernel<HD><<<dim3((a.sq + kMT - 1) / kMT, a.h, b), kMmaThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd_dkdv_mma_kernel<HD>
      <<<dim3((a.skv + kMT - 1) / kMT, a.h, b), kMmaThreads, bytes, stream>>>(a);
  if (a.h == a.kvh) return (int)cudaGetLastError();
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n_out = (long long)b * a.skv * a.kvh * HD;
  const int blocks = (int)((n_out + 255) / 256 < 4096 ? (n_out + 255) / 256 : 4096);
  bwd_group_sum_kernel<<<blocks, 256, 0, stream>>>(a, HD, n_out);
  return (int)cudaGetLastError();
}

int dispatch(const BwdArgs<float>& a, int b, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<32, float>(a, b, stream);
    case 64: return launch<64, float>(a, b, stream);
    case 128: return launch<128, float>(a, b, stream);
    case 256: return launch<256, float>(a, b, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// bf16 takes the tensor cores at hd <= 128, the SIMT kernels at hd 256
// (where 16 keys' dK and dV of a warp would not fit its registers)
int dispatch(const BwdArgs<bf16>& a, int b, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_mma<32>(a, b, stream);
    case 64: return launch_mma<64>(a, b, stream);
    case 128: return launch_mma<128>(a, b, stream);
    case 256: return launch<256, bf16>(a, b, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
BwdArgs<T> make_args(const void* q, const void* k, const void* v, const void* o,
                     const void* dout, const void* lse, void* dd, void* dq, void* dk, void* dv,
                     void* ws, int sq, int skv, int h, int kvh, int hd, int causal, int window,
                     float softcap) {
  return BwdArgs<T>{static_cast<const T*>(q),    static_cast<const T*>(k),
                    static_cast<const T*>(v),    static_cast<const T*>(o),
                    static_cast<const T*>(dout), static_cast<const float*>(lse),
                    static_cast<float*>(dd),     static_cast<T*>(dq),
                    static_cast<T*>(dk),         static_cast<T*>(dv),
                    sq, skv, h, kvh, causal, window, softcap, 1.0f / sqrtf((float)hd),
                    static_cast<float*>(ws)};
}

}  // namespace

// q, o, dout, dq (b, sq, h, hd); k, v, dk, dv (b, skv, kvh, hd); lse and the
// scratch dd (b, h, sq) f32; all contiguous. The scratch ws, 2 x (b, skv, h,
// hd) f32, is read only for bf16 at hd <= 128 with kvh < h (null otherwise).
// dtype 0 = f32, 1 = bf16; hd in {32, 64, 128, 256}; kvh divides h; b and h
// at most 65535.
extern "C" int rt_flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                      const void* lse, const void* dout, void* dd, void* dq,
                                      void* dk, void* dv, void* ws, int b, int sq, int skv, int h,
                                      int kvh, int hd, int causal, int window, float softcap,
                                      int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0) return 0;
  if (h <= 0 || kvh <= 0 || h % kvh || h > 65535 || b > 65535 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return dispatch(make_args<float>(q, k, v, o, dout, lse, dd, dq, dk, dv, ws, sq, skv, h, kvh,
                                     hd, causal, window, softcap),
                    b, hd, s);
  if (dtype == 1)
    return dispatch(make_args<__nv_bfloat16>(q, k, v, o, dout, lse, dd, dq, dk, dv, ws, sq, skv,
                                             h, kvh, hd, causal, window, softcap),
                    b, hd, s);
  return (int)cudaErrorInvalidValue;
}

// Mamba1 selective scan, backward: the reverse-mode gradient of
// csrc/selective_scan.cu's function, h_t = a_t h_{t-1} + b_t with
// a_t = exp(dt_t A), b_t = dt_t x_t B_t, A = -exp(A_log), from h_0 = 0, and
// y_t = h_t . C_t + D x_t.
//
// Replaces no TPU kernel: the JAX package differentiates the jnp
// chunked_selective_scan with XLA (repro/models/mamba.py: mamba1_forward).
// The port's Mamba1 block runs the forward kernel, so its training step
// needs this one (kernels/scan/ops.py: SelectiveScan).
//
// Inputs: dt (b, s, di) f32, B and C (b, s, n) f32, x (b, s, di) f32 or
// bf16, A_log (di, n) f32, D (di,) f32, the forward's chunk-edge states
// h_chunks (b, ceil(s / 64), di, n) f32 (the state entering each 64-step
// chunk), dy (b, s, di) in y's type, f32 or bf16, and dh_last (b, di, n)
// f32 or null. With g_t = dL/dh_t = dy_t C_t + a_{t+1} g_{t+1}, seeded by
// dh_last, it writes
//   ddt_t = sum_n g_t (h_{t-1} a_t A + x_t B_t)        (b, s, di) f32
//   dx_t  = dt_t sum_n g_t B_t + D dy_t               (b, s, di) in x's type
//   dB_t  = sum_d g_t dt_t x_t,  dC_t = sum_d dy_t h_t (b, s, n) f32
//   dA_log = A sum_{b,t} g_t h_{t-1} a_t dt_t          (di, n) f32
//   dD = sum_{b,t} dy_t x_t                           (di,) f32
//
// Bound: bytes. Each input read once and each output written once: dt, dy
// and ddt in f32, x and dx in bf16, the chunk states and B, C, dB, dC, at
// falcon-mamba-7b's (1, 2048, 8192, 16) 285 MB, 85 us at 3.35 TB/s. Its 18
// f32 operations a (t, channel, state) (6 to recompute h, 12 for the
// adjoint and the five sums) are 4.8 GFLOP, 72 us at 67 TFLOP/s.
//
// Design. The forward's decomposition, run backwards. A block of 256 threads
// (8 warps) takes 64 channels of one batch row; lane l of a warp holds
// channel l % 8 and the 16-step segment l / 8 of a 64-step chunk, as in the
// forward. The block walks the chunks from the last to the first. For each
// group of two states (a, h and the segment's partial sums for 16 steps
// of two chains fill 255 registers; four would spill):
//   1. h recomputed: the forward's segment pairs (a = exp2(dt A log2 e) by
//      ex2.approx, the same instruction and operands as the forward), the
//      warp's scan over its 4 segments and the chunk's entering state
//      from h_chunks give each segment's entering state; a serial pass keeps
//      a_t and h_t for the 16 steps in registers.
//   2. The adjoint. With r_t = a_t g_t, the step is r_t = a_t (c_t +
//      r_{t+1}), c_t = dy_t C_t: a pair (a_t, a_t c_t) local to step t, so
//      the segments' pairs compose as the forward's do and the warp scans
//      them in reverse (shfl_down; the one-step shift of a_{t+1} in g_t is
//      inside r). A segment's pair is (exp2(A log2 e sum dt), its serial
//      sum), the state carried between chunks is r at the chunk's first step
//      (seeded with dh_last; steps past s have a = 1 and c = 0 and pass it
//      through). A second serial pass from the segment's true r gives g_t
//      and every term: ddt and dx in 16 per-step accumulators summed over
//      the states, dA and dD in registers, and in place of a_t and h_t the
//      step's g_t dt_t x_t and dy_t h_t, which dB and dC sum over channels.
//   3. dB and dC over the 64 channels, in a fixed order (every gradient is
//      bit-identical from run to run): a butterfly over the warp's 8 channel
//      lanes (3 shuffle levels, halving the values a lane keeps, 14 shuffles
//      for 16 steps), then the 8 warps' sums in shared memory, added in warp
//      order by the block, one partial (64 steps, n) a chunk to global
//      memory. A second, small launch adds the di / 64 blocks' partials in
//      block order, and dA_log and dD over the batch rows. The partials are
//      (2, b, di / 64, s, n) f32: 33.5 MB written and read at falcon-mamba's
//      shape, against 134 MB for one partial a 16-channel block.
// The constants below are the design's choices; kernels/variants.py builds
// other values of them beside it. Measured there on an H100 80GB HBM3 at
// 700 W (falcon-mamba's (1, 2048, 8192, 16), one run): this design 0.515
// ms; 16 warps an SM of 4 channels x 8 segments of 8 steps at 128
// registers 0.62 ms at one state a group and 0.68 at two (it spills); one
// state a group here 0.54; clusters of 2 blocks adding dB / dC through
// distributed shared memory 0.56; without the dB / dC butterfly 0.41. So
// the kernel is bound by its instruction issue (shuffles and arithmetic),
// not by latency that more warps would hide: the 8-step segments' third
// scan level costs more than the extra warps give back. At n = 32, 16
// warps would need the shared memory's warp sums in passes of kPass states
// (a block may have 232,448 bytes); here one pass holds them all.
// Padding states (A = 0, B = C = 0, h = 0, dh_last = 0) and channels past di
// carry zeros through every sum; steps past s and padding states write
// nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kChBits = 3;
constexpr int kCh = 1 << kChBits;           // channels per warp
constexpr int kSegs = 4;                    // time segments per warp
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockCh = kCh * kWarps;      // 64 channels per block
constexpr int kItems = 16;                  // steps per thread per chunk
constexpr int kGroup = 2;                   // states a thread runs side by side
constexpr int kPass = 32;                   // states whose warp sums shared memory holds
constexpr int kChunk = kSegs * kItems;      // 64 steps
constexpr int kRow = kChunk + 4;            // padded row of the B / C tiles
constexpr int kMaxN = 32;
constexpr int kFinishThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
static_assert(kCh * kSegs == 32 && kItems % 4 == 0 && kItems >= kCh && kPass % kGroup == 0,
              "a warp is kCh channels x kSegs segments; B and C read 4 steps at a time");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// 4 consecutive floats of a B or C row from shared memory, in one read
__device__ __forceinline__ void read4(float (&v)[4], const float* p) {
  const float4 w = *reinterpret_cast<const float4*>(p);
  v[0] = w.x, v[1] = w.y, v[2] = w.z, v[3] = w.w;
}

__host__ __device__ inline int padded(int n) { return (n + kGroup - 1) / kGroup * kGroup; }
// a step's row in sRed: the states of one pass and a pad
__host__ __device__ inline int red_row(int np) { return (np < kPass ? np : kPass) + 1; }

struct Smem {  // offsets, in floats, into the dynamic shared memory
  int bc, hc, r, a, da, red, total;
  __host__ __device__ explicit Smem(int np) {
    bc = 0;                                // [2][B | C][np][kRow], by chunk parity
    hc = bc + 4 * np * kRow;               // [2][np][kBlockCh]: the chunk's entering h
    r = hc + 2 * np * kBlockCh;            // [2][np][kBlockCh]: the carried r
    a = r + 2 * np * kBlockCh;             // [np][kBlockCh]: A log2 e
    da = a + np * kBlockCh;                // [np][kBlockCh]: sum of g a h dt
    red = da + np * kBlockCh;              // [dB | dC][kWarps][kChunk][red_row]
    total = red + 2 * kWarps * kChunk * red_row(np);
  }
};

// Stage chunk k's B, C (transposed to (np, kChunk)) and entering states
// into the parity's buffers by asynchronous copies; zeros past s, n and di.
__device__ __forceinline__ void stage(float* sB, float* sC, float* sHc, const float* Bm,
                                      const float* Cm, const float* hc, long long row0,
                                      long long hc_row, int t0, int s, int di, int n, int np) {
  for (int i = threadIdx.x; i < kChunk * np; i += kThreads) {
    const int tt = i % kChunk, j = i / kChunk;
    const bool in = t0 + tt < s && j < n;
    const long long src = in ? (row0 + t0 + tt) * n + j : 0;
    cp_async4(sB + j * kRow + tt, Bm + src, in);
    cp_async4(sC + j * kRow + tt, Cm + src, in);
  }
  for (int i = threadIdx.x; i < kBlockCh * np; i += kThreads) {
    const int cc = i / np, j = i % np;
    const int c = blockIdx.x * kBlockCh + cc;
    const bool in = c < di && j < n;
    cp_async4(sHc + j * kBlockCh + cc, hc + (in ? (hc_row + c) * n + j : 0), in);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The thread's kItems steps of dt, x and dy from (t_first, c), zeros past s.
template <typename TX, typename TY>
__device__ __forceinline__ void load_steps(float (&d)[kItems], TX (&xv)[kItems],
                                           TY (&gy)[kItems], const float* dt, const TX* x,
                                           const TY* dy, long long base, int t_first, int s,
                                           int di, bool live) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool in = live && t_first + i < s;
    d[i] = in ? dt[base + (long long)i * di] : 0.f;
    xv[i] = in ? x[base + (long long)i * di] : TX(0.f);
    gy[i] = in ? dy[base + (long long)i * di] : TY(0.f);
  }
}

// Sum v over the warp's kCh channel lanes (lane bits below kCh), halving the
// steps a lane keeps at each level L: lanes 2^L apart swap halves and add,
// each keeping the half its lane bit names. On return v[0 .. kItems / kCh)
// hold the sums of the steps from butterfly_first(cb) on.
template <int L = 0>
__device__ __forceinline__ void butterfly(float (&v)[kItems], int cb) {
  if constexpr (L < kChBits) {
    constexpr int m = 1 << L, half = kItems >> (L + 1);
    const bool hi = cb & m;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float send = hi ? v[i] : v[i + half];
      const float keep = hi ? v[i + half] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
    butterfly<L + 1>(v, cb);
  }
}

__device__ __forceinline__ int butterfly_first(int cb) {
  int first = 0;
#pragma unroll
  for (int l = 0; l < kChBits; ++l) first += cb & (1 << l) ? kItems >> (l + 1) : 0;
  return first;
}

// The block's partial of dB and dC for the states [j0, j0 + cnt) of the
// chunk at t0: the warps' sums in sRed, added in warp order. The partials
// are (dB | dC, batch, block, s, n).
__device__ __forceinline__ void block_sums(const float* sRed, float* part_bc, int rrow, int t0,
                                           int j0, int cnt, int s, int n) {
  const long long part_row = (long long)blockIdx.y * gridDim.x + blockIdx.x;
  const long long part_q = (long long)gridDim.y * gridDim.x * s * n;
  for (int o = threadIdx.x; o < 2 * kChunk * cnt; o += kThreads) {
    const int qd = o / (kChunk * cnt), t = (o / cnt) % kChunk, jj = o % cnt;
    if (t0 + t >= s) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += sRed[((qd * kWarps + w) * kChunk + t) * rrow + jj];
    part_bc[qd * part_q + (part_row * s + t0 + t) * n + j0 + jj] = sum;
  }
}

template <typename TX, typename TY>
__global__ void __launch_bounds__(kThreads, 1)
scan_bwd_kernel(const float* __restrict__ dt, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const TX* __restrict__ x,
                const float* __restrict__ A_log, const float* __restrict__ D,
                const float* __restrict__ hc, const TY* __restrict__ dy,
                const float* __restrict__ dh_last, float* __restrict__ ddt,
                TX* __restrict__ dx, float* __restrict__ part_bc,
                float* __restrict__ part_a, float* __restrict__ part_d, int s, int di, int n) {
  extern __shared__ float smem[];
  const int np = padded(n), rrow = red_row(np);
  const Smem L(np);
  float* sA = smem + L.a;
  float* sDA = smem + L.da;
  float* sRed = smem + L.red;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, seg = lane / kCh, cb = lane % kCh;
  const int bc = warp * kCh + cb;                    // channel within the block
  const int first = seg * kItems;                    // the thread's first step in a chunk
  const int t_red = first + butterfly_first(cb);     // its first step after the butterfly
  const int c = blockIdx.x * kBlockCh + bc;
  const bool live = c < di;
  const int n_chunks = (s + kChunk - 1) / kChunk;
  const long long row0 = (long long)blockIdx.y * s;  // first (batch, t) row
  const long long hc0 = (long long)blockIdx.y * n_chunks * di;
  const float Dc = live ? D[c] : 0.f;
  const int last_pass = kPass < kMaxN ? (np - 1) / kPass * kPass : 0;  // the last pass's first state

  for (int i = threadIdx.x; i < np * kBlockCh; i += kThreads) {
    const int j = i / kBlockCh, cc = blockIdx.x * kBlockCh + i % kBlockCh;
    const bool in = cc < di && j < n;
    sA[i] = in ? -expf(A_log[(long long)cc * n + j]) * kLog2e : 0.f;
    sDA[i] = 0.f;
    smem[L.r + i] = in && dh_last != nullptr
                        ? dh_last[((long long)blockIdx.y * di + cc) * n + j] : 0.f;
  }

  float dtv[kItems];
  TX xv[kItems];
  TY gy[kItems];
  float dD = 0.f;
  if (n_chunks > 0) {
    const int t0 = (n_chunks - 1) * kChunk;
    stage(smem + L.bc, smem + L.bc + np * kRow, smem + L.hc, Bm, Cm, hc, row0,
          hc0 + (long long)(n_chunks - 1) * di, t0, s, di, n, np);
    load_steps(dtv, xv, gy, dt, x, dy, (row0 + t0 + first) * di + c, t0 + first, s, di, live);
  }
  for (int it = 0; it < n_chunks; ++it) {
    const int k = n_chunks - 1 - it, par = it & 1, t0 = k * kChunk;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // this chunk's tiles landed; the last chunk's sums are read
    const float* sB = smem + L.bc + par * 2 * np * kRow;
    const float* sC = sB + np * kRow;
    const float* sHc = smem + L.hc + par * np * kBlockCh;
    const float* r_in = smem + L.r + par * np * kBlockCh;
    float* r_out = smem + L.r + (par ^ 1) * np * kBlockCh;
    if (k > 0) {
      float* nb = smem + L.bc + (par ^ 1) * 2 * np * kRow;
      stage(nb, nb + np * kRow, smem + L.hc + (par ^ 1) * np * kBlockCh, Bm, Cm, hc, row0,
            hc0 + (long long)(k - 1) * di, t0 - kChunk, s, di, n, np);
    }
    const int t_first = t0 + first;
    float gB[kItems], gAh[kItems], dsum = 0.f;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      dsum += dtv[i];
      gB[i] = 0.f;
      gAh[i] = 0.f;
      dD = fmaf(to_f32(gy[i]), to_f32(xv[i]), dD);
    }

    for (int j0 = 0; j0 < np; j0 += kGroup) {
      if constexpr (kPass < kMaxN) {
        if (j0 > 0 && j0 % kPass == 0) {  // sRed is full: the last kPass states' partial
          __syncthreads();
          block_sums(sRed, part_bc, rrow, t0, j0 - kPass, kPass, s, n);
          __syncthreads();
        }
      }
      const int jr = kPass < kMaxN ? j0 % kPass : j0;  // the group's first column in sRed
      float A2[kGroup], pa[kGroup], pb[kGroup], hs[kGroup], a[kGroup][kItems],
          h[kGroup][kItems];
      // 1. h, as the forward computes it: the segment's pair, the warp's
      // scan, the entering state, a serial pass
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        A2[u] = sA[(j0 + u) * kBlockCh + bc];
        pb[u] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        float bq[kGroup][4];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) read4(bq[u], sB + (j0 + u) * kRow + first + 4 * q);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const int i = 4 * q + e;
            a[u][i] = exp2_approx(dtv[i] * A2[u]);
            pb[u] = fmaf(a[u][i], pb[u], dtv[i] * to_f32(xv[i]) * bq[u][e]);
          }
      }
      float seg_a[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) seg_a[u] = pa[u] = exp2_approx(dsum * A2[u]);
#pragma unroll
      for (int up = kCh; up < 32; up *= 2)
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const float qa = __shfl_up_sync(0xffffffffu, pa[u], up);
          const float qb = __shfl_up_sync(0xffffffffu, pb[u], up);
          if (lane >= up) {
            pb[u] = fmaf(pa[u], qb, pb[u]);
            pa[u] *= qa;
          }
        }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float qa = __shfl_up_sync(0xffffffffu, pa[u], kCh);
        const float qb = __shfl_up_sync(0xffffffffu, pb[u], kCh);
        const float ea = seg == 0 ? 1.f : qa, eb = seg == 0 ? 0.f : qb;
        hs[u] = fmaf(ea, sHc[(j0 + u) * kBlockCh + bc], eb);
      }
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        float bq[kGroup][4];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) read4(bq[u], sB + (j0 + u) * kRow + first + 4 * q);
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const int i = 4 * q + e;
            const float prev = i == 0 ? hs[u] : h[u][i - 1];
            h[u][i] = fmaf(a[u][i], prev, dtv[i] * to_f32(xv[i]) * bq[u][e]);
          }
      }

      // 2. the adjoint: the segment's reverse pair, the warp's reverse scan,
      // the entering r, then the serial pass with every term
      float ra[kGroup], rb[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        ra[u] = seg_a[u];
        rb[u] = 0.f;
      }
#pragma unroll
      for (int q = kItems / 4 - 1; q >= 0; --q) {
        float cq[kGroup][4];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) read4(cq[u], sC + (j0 + u) * kRow + first + 4 * q);
#pragma unroll
        for (int e = 3; e >= 0; --e)
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const int i = 4 * q + e;
            rb[u] = a[u][i] * fmaf(to_f32(gy[i]), cq[u][e], rb[u]);
          }
      }
#pragma unroll
      for (int down = kCh; down < 32; down *= 2)
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const float qa = __shfl_down_sync(0xffffffffu, ra[u], down);
          const float qb = __shfl_down_sync(0xffffffffu, rb[u], down);
          if (lane + down < 32) {
            rb[u] = fmaf(ra[u], qb, rb[u]);
            ra[u] *= qa;
          }
        }
      float rr[kGroup], dA[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float qa = __shfl_down_sync(0xffffffffu, ra[u], kCh);
        const float qb = __shfl_down_sync(0xffffffffu, rb[u], kCh);
        const float ea = seg == kSegs - 1 ? 1.f : qa, eb = seg == kSegs - 1 ? 0.f : qb;
        const float r_chunk = r_in[(j0 + u) * kBlockCh + bc];
        if (seg == 0) r_out[(j0 + u) * kBlockCh + bc] = fmaf(ra[u], r_chunk, rb[u]);
        rr[u] = fmaf(ea, r_chunk, eb);
        dA[u] = 0.f;
      }
#pragma unroll
      for (int q = kItems / 4 - 1; q >= 0; --q) {
        float bq[kGroup][4], cq[kGroup][4];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          read4(bq[u], sB + (j0 + u) * kRow + first + 4 * q);
          read4(cq[u], sC + (j0 + u) * kRow + first + 4 * q);
        }
#pragma unroll
        for (int e = 3; e >= 0; --e)
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const int i = 4 * q + e;
            const float gyi = to_f32(gy[i]);
            const float g = fmaf(gyi, cq[u][e], rr[u]);
            const float prev = i == 0 ? hs[u] : h[u][i - 1];
            const float qv = g * a[u][i] * prev;
            gAh[i] = fmaf(A2[u], qv, gAh[i]);
            dA[u] = fmaf(qv, dtv[i], dA[u]);
            gB[i] = fmaf(g, bq[u][e], gB[i]);
            rr[u] = a[u][i] * g;
            a[u][i] = g * (dtv[i] * to_f32(xv[i]));  // step i's share of dB
            h[u][i] = gyi * h[u][i];                 // and of dC
          }
      }
      // dA over the warp's segments, into the block's sum
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
#pragma unroll
        for (int m = kCh; m < 32; m *= 2) dA[u] += __shfl_xor_sync(0xffffffffu, dA[u], m);
        if (seg == 0) sDA[(j0 + u) * kBlockCh + bc] += dA[u];
      }
      // 3. dB and dC over the warp's channels, into the warp's row of sRed
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        butterfly(a[u], cb);
        butterfly(h[u], cb);
#pragma unroll
        for (int e = 0; e < kItems / kCh; ++e) {
          sRed[(warp * kChunk + t_red + e) * rrow + jr + u] = a[u][e];
          sRed[((kWarps + warp) * kChunk + t_red + e) * rrow + jr + u] = h[u][e];
        }
      }
    }

    // this chunk's ddt and dx, then the next chunk's dt, x and dy
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      if (live && t_first + i < s) {
        const long long at = (row0 + t_first + i) * di + c;
        ddt[at] = fmaf(kLn2, gAh[i], to_f32(xv[i]) * gB[i]);
        store(&dx[at], fmaf(dtv[i], gB[i], Dc * to_f32(gy[i])));
      }
    }
    if (k > 0)
      load_steps(dtv, xv, gy, dt, x, dy, (row0 + t_first - kChunk) * di + c,
                 t_first - kChunk, s, di, live);
    __syncthreads();  // every warp's dB / dC sums of the last pass are in sRed
    block_sums(sRed, part_bc, rrow, t0, last_pass,
               (n < last_pass + kPass ? n : last_pass + kPass) - last_pass, s, n);
  }

  // dD over the warp's segments; dA_log's and dD's partial for this batch row
#pragma unroll
  for (int m = kCh; m < 32; m *= 2) dD += __shfl_xor_sync(0xffffffffu, dD, m);
  __syncthreads();  // every warp's dA is in sDA
  if (seg == 0 && live) part_d[(long long)blockIdx.y * di + c] = dD;
  for (int i = threadIdx.x; i < kBlockCh * n; i += kThreads) {
    const int cc = blockIdx.x * kBlockCh + i / n, j = i % n;
    if (cc < di)
      part_a[((long long)blockIdx.y * di + cc) * n + j] =
          -expf(A_log[(long long)cc * n + j]) * sDA[j * kBlockCh + i / n];
  }
}

// dB, dC: the blocks' partials added in block order; dA_log, dD: the batch
// rows' partials added in row order.
__global__ void __launch_bounds__(kFinishThreads)
scan_bwd_finish_kernel(const float* __restrict__ part_bc, const float* __restrict__ part_a,
                       const float* __restrict__ part_d, float* __restrict__ dB,
                       float* __restrict__ dC, float* __restrict__ dA_log,
                       float* __restrict__ dD, int b, int s, int di, int n, int blocks) {
  const long long bsn = (long long)b * s * n, dn = (long long)di * n;
  const long long total = 2 * bsn + dn + di;
  for (long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x; o < total;
       o += (long long)gridDim.x * blockDim.x) {
    if (o < 2 * bsn) {
      const long long qd = o / bsn, rem = o % bsn;
      const long long bb = rem / ((long long)s * n), tn = rem % ((long long)s * n);
      const float* p = part_bc + qd * (long long)b * blocks * s * n + bb * blocks * s * n + tn;
      float sum = 0.f;
      for (int k = 0; k < blocks; ++k) sum += p[(long long)k * s * n];
      (qd == 0 ? dB : dC)[rem] = sum;
    } else if (o < 2 * bsn + dn) {
      const long long i = o - 2 * bsn;
      float sum = 0.f;
      for (int bb = 0; bb < b; ++bb) sum += part_a[bb * dn + i];
      dA_log[i] = sum;
    } else {
      const long long i = o - 2 * bsn - dn;
      float sum = 0.f;
      for (int bb = 0; bb < b; ++bb) sum += part_d[bb * (long long)di + i];
      dD[i] = sum;
    }
  }
}

template <typename TX, typename TY>
int launch(const float* dt, const float* Bm, const float* Cm, const void* x, const float* A_log,
           const float* D, const float* hc, const void* dy, const float* dh_last, float* ddt,
           void* dx, float* dB, float* dC, float* dA_log, float* dD, float* work, int b, int s,
           int di, int n, cudaStream_t st) {
  const int np = padded(n), blocks = (di + kBlockCh - 1) / kBlockCh;
  const size_t bytes = sizeof(float) * Smem(np).total;
  cudaError_t err = cudaFuncSetAttribute(scan_bwd_kernel<TX, TY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  float* part_bc = work;
  float* part_a = part_bc + 2LL * b * blocks * s * n;
  float* part_d = part_a + (long long)b * di * n;
  scan_bwd_kernel<TX, TY><<<dim3(blocks, b), kThreads, bytes, st>>>(
      dt, Bm, Cm, static_cast<const TX*>(x), A_log, D, hc, static_cast<const TY*>(dy), dh_last,
      ddt, static_cast<TX*>(dx), part_bc, part_a, part_d, s, di, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long total = 2LL * b * s * n + (long long)di * n + di;
  const int grid = (int)((total + kFinishThreads - 1) / kFinishThreads);
  scan_bwd_finish_kernel<<<grid, kFinishThreads, 0, st>>>(part_bc, part_a, part_d, dB, dC,
                                                          dA_log, dD, b, s, di, n, blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// The f32 elements of the workspace the backward needs: the per-block dB /
// dC partials and the per-batch-row dA_log / dD partials.
extern "C" long long rt_selective_scan_bwd_workspace(int b, int s, int di, int n) {
  const long long blocks = (di + kBlockCh - 1) / kBlockCh;
  return 2LL * b * blocks * s * n + (long long)b * di * n + (long long)b * di;
}

// x_dtype, dy_dtype: 0 = float32, 1 = bfloat16. 1 <= n <= 32; b <= 65535;
// dh_last may be null (a zero gradient of the last state); work holds
// rt_selective_scan_bwd_workspace(b, s, di, n) floats.
extern "C" int rt_selective_scan_bwd(const void* dt, const void* Bm, const void* Cm,
                                     const void* x, const void* A_log, const void* D,
                                     const void* h_chunks, const void* dy, const void* dh_last,
                                     void* ddt, void* dx, void* dB, void* dC, void* dA_log,
                                     void* dD, void* work, long long work_elems, int b, int s,
                                     int di, int n, int x_dtype, int dy_dtype, void* stream) {
  if (b <= 0 || di <= 0) return 0;
  if (n < 1 || n > kMaxN || s < 0 || b > 65535 || (x_dtype != 0 && x_dtype != 1) ||
      (dy_dtype != 0 && dy_dtype != 1) ||
      work_elems < rt_selective_scan_bwd_workspace(b, s, di, n))
    return (int)cudaErrorInvalidValue;
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_B = static_cast<const float*>(Bm);
  const float* f_C = static_cast<const float*>(Cm);
  const float* f_A = static_cast<const float*>(A_log);
  const float* f_D = static_cast<const float*>(D);
  const float* f_hc = static_cast<const float*>(h_chunks);
  const float* f_dh = static_cast<const float*>(dh_last);
  float* f_ddt = static_cast<float*>(ddt);
  float* f_dB = static_cast<float*>(dB);
  float* f_dC = static_cast<float*>(dC);
  float* f_dA = static_cast<float*>(dA_log);
  float* f_dD = static_cast<float*>(dD);
  float* f_w = static_cast<float*>(work);
  cudaStream_t st = (cudaStream_t)stream;
#define RT_SCAN_BWD(TX, TY)                                                                   \
  launch<TX, TY>(f_dt, f_B, f_C, x, f_A, f_D, f_hc, dy, f_dh, f_ddt, dx, f_dB, f_dC, f_dA, \
                 f_dD, f_w, b, s, di, n, st)
  if (x_dtype == 0 && dy_dtype == 0) return RT_SCAN_BWD(float, float);
  if (x_dtype == 0) return RT_SCAN_BWD(float, __nv_bfloat16);
  if (dy_dtype == 0) return RT_SCAN_BWD(__nv_bfloat16, float);
  return RT_SCAN_BWD(__nv_bfloat16, __nv_bfloat16);
#undef RT_SCAN_BWD
}

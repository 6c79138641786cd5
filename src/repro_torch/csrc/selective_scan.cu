// Mamba1 selective scan: h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t,
// y_t = h_t . C_t + D x_t, with A = -exp(A_log), from h_0 = 0.
//
// Replaces repro/kernels/scan/mamba_scan.py: _scan_kernel
// (mamba_selective_scan). The port's Mamba1 block calls it once per layer of
// the prefill forward, in place of the JAX package's chunked_selective_scan.
//
// Layout: dt (b, s, di) f32, B and C (b, s, n) f32, x (b, s, di) f32 or bf16,
// A_log (di, n) f32, D (di,) f32, all contiguous; y (b, s, di) in the type
// the caller asks for (the Mamba1 block asks for f32: it gates y with
// silu(z) before rounding), h_last (b, di, n) f32, and, when the caller
// passes h_chunks (training: the backward, csrc/selective_scan_bwd.cu, reads
// it), the state entering each 64-step chunk, (b, ceil(s / 64), di, n) f32.
// A null h_chunks writes nothing more and leaves y bit for bit as it was.
//
// Bound: bytes. The kernel reads dt, x, B, C once and writes y once: at
// falcon-mamba-7b (b 1, s 2048, di 8192, n 16, x bf16, y f32) 168 MB, 50 us
// at 3.35 TB/s; its ~9 flops per (t, channel, state) are 2.4 GFLOP, 36 us at
// the 67 TFLOP/s f32 rate. So the kernel has to spend few instructions per
// (t, channel, state) and keep every SM busy.
//
// Design: a block-parallel scan over time (the idea of the Mamba authors'
// CUDA kernel, laid out for this repo's (b, s, di) tensors). Each (batch,
// channel, state) is an independent linear recurrence h_t = a_t h_{t-1} +
// b_t, and pairs (a, b) compose associatively: (a2, b2) after (a1, b1) is
// (a2 a1, a2 b1 + b2). A block of 64 threads takes 16 channels of one batch
// row (grid di / 16 x b: 512 blocks at b 1); each warp owns 8 of them, so
// every time step's 8 values of dt, x and y are one 32-byte sector. Lane l
// holds channel l % 8 and time segment l / 8 of a 64-step chunk: 16
// consecutive steps a thread. Each chunk's loads are issued one chunk
// ahead, so no chunk waits on its own: the block stages B and C transposed
// ((n, 64), rows padded to 68 floats) by cp.async into a double buffer in
// shared memory, read back 4 steps per 128-bit load, and each thread loads
// its 16 steps of dt and x into registers. Then for each group of four
// states (four independent chains side by side, so their latencies overlap;
// n is padded to whole groups with states that have A = 0 and B = C = 0;
// four a group took 4-5% less time than two at falcon-mamba's width, with
// 252 registers a thread and no spills):
//   1. a = exp2(dt (A log2 e)) and b = dt x B for the 16 steps, kept in
//      registers (A log2 e computed once per block, in shared memory); the
//      segment's pair from a serial pass (its a-product is exp2((A log2 e)
//      sum dt), one exp2 a segment);
//   2. an inclusive scan of the pairs over the warp's 4 segments (2 shuffle
//      steps) and its exclusive form; the state carried into the chunk comes
//      from shared memory, written by the same warp's last segment one chunk
//      before, so warps never wait on each other inside the loop over n;
//   3. a second serial pass from the segment's true entering state adds
//      h_t C_t into the thread's 16 y accumulators.
// So y needs no cross-lane reduction: the sum over n is the loop. Per
// (t, state) a thread issues one exp2, about 6 more arithmetic instructions
// and half a shared load; the combine adds about 1.5 more. D x is added in
// the accumulators' start value and y is written once per step. exp2 is
// ex2.approx.ftz (2 ulp; a flushed denormal a is a state that has decayed
// anyway), held within 1e-4 of max|y| of the plain version at falcon-mamba's
// width on the card. Steps of the chunk past s run as a = 1, b = 0 (the
// state passes through) and write nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kCh = 8;                      // channels per warp
constexpr int kSegs = 4;                    // time segments per warp
constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockCh = kCh * kWarps;      // channels per block
constexpr int kItems = 16;                  // steps per thread per chunk
constexpr int kGroup = 4;                   // states a thread scans side by side
constexpr int kChunk = kSegs * kItems;      // 64 steps
constexpr int kRow = kChunk + 4;            // padded row of the B / C tiles
constexpr int kMaxN = 32;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 4 bytes global -> shared, asynchronously; zeros when !in (nothing is read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool in) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(in ? 4 : 0)
               : "memory");
}

// States rounded up to whole groups; a padding state has A = 0 and B = C = 0,
// so it passes a zero state through and adds nothing to y.
__host__ __device__ inline int padded(int n) { return (n + kGroup - 1) / kGroup * kGroup; }

size_t smem_bytes(int n) {
  // B and C tiles, A log2 e, and the carried state, all but A
  // double-buffered by chunk parity
  const int np = padded(n);
  return sizeof(float) * (4 * np * kRow + np * kBlockCh + 2 * np * kBlockCh);
}

// Stage the chunk at t0's B and C, transposed to (np, kChunk), into sB / sC
// with asynchronous copies (one step's row a thread); rows past s and the
// padding state are zeros.
__device__ __forceinline__ void stage_bc(float* sB, float* sC, const float* Bm, const float* Cm,
                                         long long row0, int t0, int s, int n, int np) {
  for (int tt = threadIdx.x; tt < kChunk; tt += kThreads) {
    const bool in = t0 + tt < s;
    const long long row = in ? (row0 + t0 + tt) * n : 0;
    for (int j = 0; j < np; ++j) {
      cp_async4(sB + j * kRow + tt, Bm + row + (j < n ? j : 0), in && j < n);
      cp_async4(sC + j * kRow + tt, Cm + row + (j < n ? j : 0), in && j < n);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The thread's kItems steps of dt and x from (t_first, c), zeros past s.
template <typename TX>
__device__ __forceinline__ void load_steps(float (&d)[kItems], TX (&xv)[kItems],
                                           const float* dt, const TX* x, long long base,
                                           int t_first, int s, int di, bool live) {
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool in = live && t_first + i < s;
    d[i] = in ? dt[base + (long long)i * di] : 0.f;
    xv[i] = in ? x[base + (long long)i * di] : TX(0.f);
  }
}

template <typename TX, typename TY>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ dt, const float* __restrict__ Bm,
            const float* __restrict__ Cm, const TX* __restrict__ x,
            const float* __restrict__ A_log, const float* __restrict__ D,
            TY* __restrict__ y, float* __restrict__ h_last, float* __restrict__ h_chunks,
            int s, int di, int n) {
  extern __shared__ float smem[];
  const int np = padded(n);
  float* sBC = smem;                    // [2][B | C][np][kRow]: transposed B and C by chunk parity
  float* sA = sBC + 4 * np * kRow;      // np x kBlockCh: A log2 e
  float* sH = sA + np * kBlockCh;       // [2][np][kBlockCh]: the carried state

  const int lane = threadIdx.x % 32, seg = lane / kCh;
  const int bc = threadIdx.x / 32 * kCh + lane % kCh;  // channel within the block
  const int first = seg * kItems;                      // the thread's first step in a chunk
  const int c = blockIdx.x * kBlockCh + bc;
  const bool live = c < di;
  const long long row0 = (long long)blockIdx.y * s;   // first (batch, t) row
  const float Dc = live ? D[c] : 0.f;

  for (int i = threadIdx.x; i < np * kBlockCh; i += kThreads) {
    const int j = i / kBlockCh, cc = blockIdx.x * kBlockCh + i % kBlockCh;
    sA[i] = cc < di && j < n ? -expf(A_log[(long long)cc * n + j]) * kLog2e : 0.f;
    sH[i] = 0.f;
  }

  // Each chunk's loads are issued one chunk ahead: B and C by asynchronous
  // copies into the other half of the double buffer, dt and x into
  // registers, so no chunk waits on its own loads.
  float dtn[kItems];
  TX xn[kItems];
  if (s > 0) {
    stage_bc(sBC, sBC + np * kRow, Bm, Cm, row0, 0, s, n, np);
    load_steps(dtn, xn, dt, x, row0 * di + first * (long long)di + c, first, s, di, live);
  }
  int chunk = 0;
  for (int t0 = 0; t0 < s; t0 += kChunk, ++chunk) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // this chunk's B / C landed; the last chunk's are read
    const float* carry_in = sH + (chunk & 1) * np * kBlockCh;
    if (h_chunks != nullptr) {  // the state entering the chunk, n states a channel
      const long long base0 = ((long long)blockIdx.y * ((s + kChunk - 1) / kChunk) + chunk) * di;
      for (int i = threadIdx.x; i < kBlockCh * n; i += kThreads) {
        const int cc = blockIdx.x * kBlockCh + i / n, j = i % n;
        if (cc < di) h_chunks[(base0 + cc) * n + j] = carry_in[j * kBlockCh + i / n];
      }
    }
    const float* sB = sBC + (chunk & 1) * 2 * np * kRow;
    const float* sC = sB + np * kRow;
    const int t_first = t0 + first;
    const long long base = (row0 + t_first) * di + c;  // the thread's first (t, c)
    float dtv[kItems], dtx[kItems], acc[kItems];
    float dsum = 0.f;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const float xv = to_f32(xn[i]);
      dtv[i] = dtn[i];
      dtx[i] = dtn[i] * xv;
      acc[i] = Dc * xv;
      dsum += dtn[i];
    }
    if (t0 + kChunk < s) {
      float* next = sBC + ((chunk & 1) ^ 1) * 2 * np * kRow;
      stage_bc(next, next + np * kRow, Bm, Cm, row0, t0 + kChunk, s, n, np);
      load_steps(dtn, xn, dt, x, base + (long long)kChunk * di, t_first + kChunk, s, di, live);
    }

    float* carry_out = sH + ((chunk & 1) ^ 1) * np * kBlockCh;
    for (int j0 = 0; j0 < np; j0 += kGroup) {  // kGroup independent states at a time
      float A2[kGroup], pa[kGroup], pb[kGroup], a[kGroup][kItems], b[kGroup][kItems];
      // 1. this segment's (a, b) pairs and its composed pair (pa, pb)
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        A2[u] = sA[(j0 + u) * kBlockCh + bc];
        pb[u] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        float bq[kGroup][4];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const float4 bv = reinterpret_cast<const float4*>(sB + (j0 + u) * kRow + first)[q];
          bq[u][0] = bv.x, bq[u][1] = bv.y, bq[u][2] = bv.z, bq[u][3] = bv.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const int i = 4 * q + e;
            a[u][i] = exp2_approx(dtv[i] * A2[u]);
            b[u][i] = dtx[i] * bq[u][e];
            pb[u] = fmaf(a[u][i], pb[u], b[u][i]);
          }
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) pa[u] = exp2_approx(dsum * A2[u]);
      // 2. inclusive scan over the warp's segments (lanes 8 apart), then the
      // pair of the segments before this one
#pragma unroll
      for (int off = kCh; off < kCh * kSegs; off *= 2)
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const float qa = __shfl_up_sync(0xffffffffu, pa[u], off);
          const float qb = __shfl_up_sync(0xffffffffu, pb[u], off);
          if (lane >= off) {
            pb[u] = fmaf(pa[u], qb, pb[u]);
            pa[u] *= qa;
          }
        }
      float hs[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const float qa = __shfl_up_sync(0xffffffffu, pa[u], kCh);
        const float qb = __shfl_up_sync(0xffffffffu, pb[u], kCh);
        const float ea = seg == 0 ? 1.f : qa, eb = seg == 0 ? 0.f : qb;
        const float h_in = carry_in[(j0 + u) * kBlockCh + bc];
        if (seg == kSegs - 1) carry_out[(j0 + u) * kBlockCh + bc] = fmaf(pa[u], h_in, pb[u]);
        hs[u] = fmaf(ea, h_in, eb);
      }
      // 3. the segment again from its true entering state: y += h C
#pragma unroll
      for (int q = 0; q < kItems / 4; ++q) {
        float cq[kGroup][4];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const float4 cv = reinterpret_cast<const float4*>(sC + (j0 + u) * kRow + first)[q];
          cq[u][0] = cv.x, cq[u][1] = cv.y, cq[u][2] = cv.z, cq[u][3] = cv.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const int i = 4 * q + e;
            hs[u] = fmaf(a[u][i], hs[u], b[u][i]);
            acc[i] = fmaf(hs[u], cq[u][e], acc[i]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < kItems; ++i)
      if (live && t_first + i < s) store(&y[base + (long long)i * di], acc[i]);
  }
  __syncthreads();  // the carried state is complete (or still zero when s = 0)
  if (seg == 0 && live) {
    const float* h_end = sH + (chunk & 1) * np * kBlockCh;
    float* out = h_last + ((long long)blockIdx.y * di + c) * n;
    for (int j = 0; j < n; ++j) out[j] = h_end[j * kBlockCh + bc];
  }
}

template <typename TX, typename TY>
int launch(const float* dt, const float* Bm, const float* Cm, const void* x, const float* A_log,
           const float* D, void* y, float* h, float* hc, int b, int s, int di, int n,
           cudaStream_t st) {
  const size_t bytes = smem_bytes(n);
  cudaError_t err = cudaFuncSetAttribute(scan_kernel<TX, TY>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((di + kBlockCh - 1) / kBlockCh, b);
  scan_kernel<TX, TY><<<grid, kThreads, bytes, st>>>(dt, Bm, Cm, static_cast<const TX*>(x),
                                                     A_log, D, static_cast<TY*>(y), h, hc, s, di, n);
  return (int)cudaGetLastError();
}

}  // namespace

// x_dtype, y_dtype: 0 = float32, 1 = bfloat16. 1 <= n <= 32; b <= 65535.
// h_chunks may be null (no chunk-edge states written).
extern "C" int rt_selective_scan(const void* dt, const void* Bm, const void* Cm, const void* x,
                                 const void* A_log, const void* D, void* y, void* h_last,
                                 void* h_chunks, int b, int s, int di, int n, int x_dtype,
                                 int y_dtype, void* stream) {
  if (b <= 0 || di <= 0) return 0;
  if (n < 1 || n > kMaxN || s < 0 || b > 65535 || (x_dtype != 0 && x_dtype != 1) ||
      (y_dtype != 0 && y_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_B = static_cast<const float*>(Bm);
  const float* f_C = static_cast<const float*>(Cm);
  const float* f_A = static_cast<const float*>(A_log);
  const float* f_D = static_cast<const float*>(D);
  float* f_h = static_cast<float*>(h_last);
  float* f_hc = static_cast<float*>(h_chunks);
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == 0 && y_dtype == 0)
    return launch<float, float>(f_dt, f_B, f_C, x, f_A, f_D, y, f_h, f_hc, b, s, di, n, st);
  if (x_dtype == 0)
    return launch<float, __nv_bfloat16>(f_dt, f_B, f_C, x, f_A, f_D, y, f_h, f_hc, b, s, di, n, st);
  if (y_dtype == 0)
    return launch<__nv_bfloat16, float>(f_dt, f_B, f_C, x, f_A, f_D, y, f_h, f_hc, b, s, di, n, st);
  return launch<__nv_bfloat16, __nv_bfloat16>(f_dt, f_B, f_C, x, f_A, f_D, y, f_h, f_hc, b, s, di,
                                              n, st);
}

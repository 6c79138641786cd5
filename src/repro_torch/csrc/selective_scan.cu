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
// silu(z) before rounding), h_last (b, di, n) f32.
//
// Bound: bytes. The kernel reads dt, x, B, C once and writes y once: at
// falcon-mamba-7b (b 1, s 2048, di 8192, n 16, x bf16, y f32) 168 MB, 50 us
// at 3.35 TB/s; its ~9 flops per (t, channel, state) are 2.4 GFLOP, 36 us at
// the 67 TFLOP/s f32 rate. Design: one thread per (batch, channel, state)
// lane, L = n rounded up to a power of two (8 to 32) lanes per channel, so
// the state lives in one register for the whole sequence and y reduces over
// the lanes with warp shuffles. A block of 256 threads holds 256 / L
// channels of one batch row (grid: di / (256 / L) x b; 512 blocks at b 1,
// not the TPU grid's b x di / 128 = 64). It stages 32 time steps of dt, x,
// B and C in shared memory with coalesced loads, walks them, and writes the
// staged y back coalesced. expf, not __expf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 32;      // time steps staged per chunk
constexpr int kMaxN = 32;   // state size limit (lanes of one warp)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename TX, typename TY, int L>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const float* __restrict__ dt, const float* __restrict__ Bm,
            const float* __restrict__ Cm, const TX* __restrict__ x,
            const float* __restrict__ A_log, const float* __restrict__ D,
            TY* __restrict__ y, float* __restrict__ h_last, int s, int di, int n) {
  constexpr int CH = kThreads / L;  // channels per block
  __shared__ float s_dt[kT][CH], s_x[kT][CH], s_y[kT][CH];
  __shared__ float s_B[kT][kMaxN], s_C[kT][kMaxN];

  const int lane = threadIdx.x % L, cl = threadIdx.x / L;
  const int c0 = blockIdx.x * CH, c = c0 + cl;
  const long long row0 = (long long)blockIdx.y * s;  // first (batch, t) row
  const bool live = c < di && lane < n;
  const float A = live ? -expf(A_log[(long long)c * n + lane]) : 0.f;
  const float Dc = c < di ? D[c] : 0.f;
  float h = 0.f;

  for (int t0 = 0; t0 < s; t0 += kT) {
    const int tn = min(kT, s - t0);
    for (int i = threadIdx.x; i < kT * CH; i += kThreads) {
      const int tt = i / CH, cc = i % CH;
      const bool in = tt < tn && c0 + cc < di;
      const long long off = (row0 + t0 + tt) * di + c0 + cc;
      s_dt[tt][cc] = in ? dt[off] : 0.f;
      s_x[tt][cc] = in ? to_f32(x[off]) : 0.f;
    }
    for (int i = threadIdx.x; i < kT * n; i += kThreads) {
      const int tt = i / n, j = i % n;
      const bool in = tt < tn;
      const long long off = (row0 + t0 + tt) * n + j;
      s_B[tt][j] = in ? Bm[off] : 0.f;
      s_C[tt][j] = in ? Cm[off] : 0.f;
    }
    __syncthreads();
    for (int tt = 0; tt < tn; ++tt) {
      const float d = s_dt[tt][cl], xv = s_x[tt][cl];
      float yv = 0.f;
      if (live) {
        h = expf(d * A) * h + (d * xv) * s_B[tt][lane];
        yv = h * s_C[tt][lane];
      }
#pragma unroll
      for (int off = L / 2; off > 0; off >>= 1) yv += __shfl_xor_sync(0xffffffffu, yv, off);
      if (lane == 0) s_y[tt][cl] = yv + Dc * xv;
    }
    __syncthreads();  // s_y complete
    for (int i = threadIdx.x; i < kT * CH; i += kThreads) {
      const int tt = i / CH, cc = i % CH;
      if (tt < tn && c0 + cc < di) store(&y[(row0 + t0 + tt) * di + c0 + cc], s_y[tt][cc]);
    }
    __syncthreads();  // s_y read before the next chunk writes it
  }
  if (live) h_last[((long long)blockIdx.y * di + c) * n + lane] = h;
}

template <typename TX, typename TY, int L>
int launch(const float* dt, const float* Bm, const float* Cm, const void* x, const float* A_log,
           const float* D, void* y, float* h, int b, int s, int di, int n, cudaStream_t st) {
  constexpr int CH = kThreads / L;
  const dim3 grid((di + CH - 1) / CH, b);
  scan_kernel<TX, TY, L><<<grid, kThreads, 0, st>>>(dt, Bm, Cm, static_cast<const TX*>(x),
                                                    A_log, D, static_cast<TY*>(y), h, s, di, n);
  return (int)cudaGetLastError();
}

template <typename TX, typename TY>
int by_lanes(const float* dt, const float* Bm, const float* Cm, const void* x, const float* A_log,
             const float* D, void* y, float* h, int b, int s, int di, int n, cudaStream_t st) {
  if (n <= 8) return launch<TX, TY, 8>(dt, Bm, Cm, x, A_log, D, y, h, b, s, di, n, st);
  if (n <= 16) return launch<TX, TY, 16>(dt, Bm, Cm, x, A_log, D, y, h, b, s, di, n, st);
  return launch<TX, TY, 32>(dt, Bm, Cm, x, A_log, D, y, h, b, s, di, n, st);
}

}  // namespace

// x_dtype, y_dtype: 0 = float32, 1 = bfloat16. 1 <= n <= 32; b <= 65535.
extern "C" int rt_selective_scan(const void* dt, const void* Bm, const void* Cm, const void* x,
                                 const void* A_log, const void* D, void* y, void* h_last,
                                 int b, int s, int di, int n, int x_dtype, int y_dtype,
                                 void* stream) {
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
  cudaStream_t st = (cudaStream_t)stream;
  if (x_dtype == 0 && y_dtype == 0)
    return by_lanes<float, float>(f_dt, f_B, f_C, x, f_A, f_D, y, f_h, b, s, di, n, st);
  if (x_dtype == 0)
    return by_lanes<float, __nv_bfloat16>(f_dt, f_B, f_C, x, f_A, f_D, y, f_h, b, s, di, n, st);
  if (y_dtype == 0)
    return by_lanes<__nv_bfloat16, float>(f_dt, f_B, f_C, x, f_A, f_D, y, f_h, b, s, di, n, st);
  return by_lanes<__nv_bfloat16, __nv_bfloat16>(f_dt, f_B, f_C, x, f_A, f_D, y, f_h, b, s, di,
                                                n, st);
}

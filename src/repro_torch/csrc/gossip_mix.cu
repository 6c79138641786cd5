// FedAvg mix kernel: the weighted sum over the N model copies a node holds.
//
// Replaces repro/kernels/mixing/gossip_mix.py: _mix_kernel (gossip_mix).
// The port uses it as the FedAvg reduction of the dissemination, segmented
// and flooding bodies, where the JAX package writes jnp.mean.
//
// Layout: buf (batch, n, p) contiguous in f32 or bf16, weights (n,) f32,
// out (batch, p) in buf's type; batch is the node axis, so one launch reduces
// every node's (n, p) buffer. out[b, c] = sum_i w[i] * buf[b, i, c], summed
// in f32 in order i = 0..n-1, each product and sum rounded on its own
// (__fmul_rn, __fadd_rn: no FMA contraction), so the plain PyTorch loop over
// i reproduces it bit for bit.
//
// Bound: bytes, (n + 1) * p * 4 per node in f32: at EfficientNet-B0 width
// (p = 5.3 M) and n = 10, 2.33 GB for all ten nodes, 0.70 ms at 3.35 TB/s.
// 2 flops per element read is far below the f32 rate. Design: each thread
// owns 4 consecutive columns of one batch row and walks i, with float4 loads
// and stores where p % 4 == 0 and the pointers are 16-byte aligned.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
mix_kernel(const T* __restrict__ buf, const float* __restrict__ w, T* __restrict__ out,
           int n, long long p, bool vec) {
  const long long col = ((long long)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (col >= p) return;
  const long long b = blockIdx.y;
  const T* src = buf + b * n * p + col;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      for (int i = 0; i < n; ++i) {
        const float wi = w[i];
        const float4 x = *reinterpret_cast<const float4*>(src + i * p);
        acc[0] = __fadd_rn(acc[0], __fmul_rn(wi, x.x));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(wi, x.y));
        acc[2] = __fadd_rn(acc[2], __fmul_rn(wi, x.z));
        acc[3] = __fadd_rn(acc[3], __fmul_rn(wi, x.w));
      }
      *reinterpret_cast<float4*>(out + b * p + col) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
      return;
    }
  }
  const int m = p - col < 4 ? (int)(p - col) : 4;
  for (int i = 0; i < n; ++i) {
    const float wi = w[i];
    for (int j = 0; j < m; ++j) acc[j] = __fadd_rn(acc[j], __fmul_rn(wi, to_f32(src[i * p + j])));
  }
  for (int j = 0; j < m; ++j) store(out + b * p + col + j, acc[j]);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. batch <= 65535 (grid.y).
extern "C" int rt_gossip_mix(const void* buf, const void* w, void* out, long long batch,
                             int n, long long p, int dtype, void* stream) {
  if (batch <= 0 || p <= 0) return 0;
  const long long grid_x = (p + 4LL * kThreads - 1) / (4LL * kThreads);
  if (n <= 0 || batch > 65535 || grid_x > 0x7fffffffLL || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)grid_x, (unsigned)batch);
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    const bool vec = p % 4 == 0 && aligned16(buf) && aligned16(out);
    mix_kernel<float><<<grid, kThreads, 0, s>>>((const float*)buf, (const float*)w,
                                                (float*)out, n, p, vec);
  } else {
    mix_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)buf, (const float*)w, (__nv_bfloat16*)out, n, p, false);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* rt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

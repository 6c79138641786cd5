// Flash attention forward: blocked attention with an online softmax.
//
// Replaces repro/kernels/attention/flash.py: _flash_kernel (flash_attention).
// The port's dense models call it for every self-attention layer of the
// prefill forward (models/attention.py routes arange positions here).
//
// Layout: q (b, sq, H, hd), k and v (b, skv, KV, hd), read in place through
// their batch, sequence and head strides (the head dim contiguous); query
// head h reads kv head h / (H / KV), so GQA needs no expanded K/V copy. The
// output o is (b, sq, H, hd) contiguous, in q's type (f32 or bf16).
// Semantics as the TPU kernel: s = (q . k) * hd^-0.5, then the tanh softcap
// when softcap > 0, then the causal (k <= q) and sliding-window (k > q -
// window) masks; m, l and the accumulator are carried in f32 and the output
// is acc / max(l, 1e-20). Masked scores get p = 0 outright, so a tile whose
// keys a row cannot see adds nothing to that row.
//
// Bound: operations. One (query, key) pair costs 4 * hd flops (two products
// of hd); at smollm-360m's prefill (b 4, s 2048, 15 heads, hd 64, causal)
// that is 32 GFLOP, 33 us at the 989 TFLOP/s bf16 tensor-core rate, against
// 42 MB of q, k, v and o (13 us at 3.35 TB/s). Design, simple first: SIMT
// f32 math (no tensor cores yet). One block of 256 threads per (q tile of 64
// rows, head, batch); K and V stream through shared memory in tiles of 64
// keys (dynamic shared memory: 214 KB at hd 256), and only the tiles a q
// tile can see are visited (none past the causal diagonal, none wholly
// below the window). Thread (ty, tx) owns rows ty + 16 r (r < 4) of both the
// score tile (columns tx + 16 c) and the output (columns tx + 16 c), so the
// row max and row sum reduce over the 16 lanes of a half-warp and the
// rescale factor never leaves the thread. Rows past sq and keys past skv are
// masked, so any sequence length works.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per streamed tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kPS = kBK + 1;   // padded row stride of the probability tile
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int sq, skv, h, kvh;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
  int causal, window;
  float softcap, scale;
};

template <int HD>
constexpr size_t smem_bytes() {
  // sQ and sK padded to HD + 1 floats a row (conflict-free column reads)
  return sizeof(float) * (2 * kBQ * (HD + 1) + kBK * HD + kBQ * kPS);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads) flash_kernel(Args a) {
  constexpr int QS = HD + 1;
  constexpr int DC = HD / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  float* sQ = smem;              // kBQ x QS
  float* sK = sQ + kBQ * QS;     // kBK x QS
  float* sV = sK + kBK * QS;     // kBK x HD
  float* sP = sV + kBK * HD;     // kBQ x kPS

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const int hq = blockIdx.y;
  const long long bi = blockIdx.z;
  const int hk = hq / (a.h / a.kvh);
  const T* q = static_cast<const T*>(a.q) + bi * a.q_sb + hq * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + bi * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + bi * a.v_sb + hk * a.v_sh;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    sQ[r * QS + d] = q0 + r < a.sq ? to_f32(q[(q0 + r) * a.q_ss + d]) : 0.f;
  }

  // the keys this q tile can see: [lo, hi)
  const int q_last = min(q0 + kBQ, a.sq) - 1;
  const int hi = a.causal ? min(a.skv, q_last + 1) : a.skv;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;

  float acc[4][DC];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[r][c] = 0.f;
  }

  for (int k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();  // the previous tile's sK, sV and sP are no longer read
    for (int i = tid; i < kBK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const bool in = k0 + r < a.skv;
      sK[r * QS + d] = in ? to_f32(k[(k0 + r) * a.k_ss + d]) : 0.f;
      sV[i] = in ? to_f32(v[(k0 + r) * a.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = sQ[(ty + 16 * r) * QS + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = sK[(tx + 16 * c) * QS + d];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[r][c] = fmaf(qv[r], kv[c], s[r][c]);
    }

#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q0 + ty + 16 * r;
      bool vis[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        float x = s[r][c] * a.scale;
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        bool ok = kj < a.skv;
        if (a.causal) ok = ok && kj <= qi;
        if (a.window > 0) ok = ok && kj > qi - a.window;
        vis[c] = ok;
        s[r][c] = x;
        if (ok) mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = vis[c] ? expf(s[r][c] - m_new) : 0.f;
        sP[(ty + 16 * r) * kPS + tx + 16 * c] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[r][c] *= alpha;
    }
    __syncthreads();  // sP complete

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float p[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) p[r] = sP[(ty + 16 * r) * kPS + j];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = sV[j * HD + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][c] = fmaf(p[r], vv, acc[r][c]);
      }
    }
  }

  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= a.sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-20f);
    T* row = o + ((bi * a.sq + qi) * a.h + hq) * HD;
#pragma unroll
    for (int c = 0; c < DC; ++c) store(row + tx + 16 * c, acc[r][c] * inv);
  }
}

template <typename T, int HD>
int launch(const Args& a, int b, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, b);
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const Args& a, int b, int hd, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(a, b, stream);
    case 64: return launch<T, 64>(a, b, stream);
    case 128: return launch<T, 128>(a, b, stream);
    case 256: return launch<T, 256>(a, b, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and o alike). hd in {32, 64,
// 128, 256}; kvh divides h; b and h at most 65535 (grid.z, grid.y).
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* o,
                                  int b, int sq, int skv, int h, int kvh, int hd,
                                  long long q_sb, long long q_ss, long long q_sh,
                                  long long k_sb, long long k_ss, long long k_sh,
                                  long long v_sb, long long v_ss, long long v_sh,
                                  int causal, int window, float softcap, int dtype,
                                  void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0) return 0;
  if (h <= 0 || kvh <= 0 || h % kvh || h > 65535 || b > 65535 || window < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Args a{q, k, v, o, sq, skv, h, kvh, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
         causal, window, softcap, 1.0f / sqrtf((float)hd)};
  cudaStream_t s = (cudaStream_t)stream;
  return dtype == 0 ? dispatch<float>(a, b, hd, s) : dispatch<__nv_bfloat16>(a, b, hd, s);
}

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
// is acc / max(l, 1e-20). With a non-null `lse` the epilogue also writes each
// row's log-sum-exp of the (softcapped, masked) scores, m + log(max(l,
// 1e-20)) in natural units, (b, H, sq) f32, which the backward kernel
// (flash_attention_bwd.cu) recomputes P from; a null `lse` writes nothing
// more. Masked scores get p = 0 outright, so a tile whose
// keys a row cannot see adds nothing to that row. Only the key tiles a q
// tile can see are visited (none past the causal diagonal, none wholly below
// the window); rows past sq and keys past skv are masked, so any sequence
// length works.
//
// Bound: operations. One (query, key) pair costs 4 * hd flops (two products
// of hd); at smollm-360m's prefill (b 4, s 2048, 15 heads, hd 64, causal)
// that is 32 GFLOP, 33 us at the 989 TFLOP/s bf16 tensor-core rate, against
// 42 MB of q, k, v and o (13 us at 3.35 TB/s).
//
// Two kernels, one per dtype (two C entry points):
//
// bf16, the serving type: tensor cores. One CTA of 288 threads per (q tile
// of 128 rows, head, batch); causal q tiles launch longest first. Warpgroups
// 0 and 1 consume, 64 rows each; warp 8 produces (one thread issues every
// copy). ptxas allows a thread at most 168 registers (the register file's
// four quadrants hold nine warps three to one quadrant: 16384 / 96 = 170,
// most likely); a producer warpgroup with setmaxnreg 24 / 240 compiled to
// the same 168 and the same spills, so nothing moves registers at run time
// (spills at hd 256 only: PERF.md). The Q tile arrives once by TMA; K and V
// tiles stream through rings by TMA (4 stages at hd <= 64, 3 at hd 128, 2
// at hd 256), each tile completed on its own "full" mbarrier and released
// on its own "empty" one. Tiles are 64 keys at hd 64 and 256 (at hd 256 Q,
// two K and two V stages take 192 KB of shared memory), 128 at hd 32 and
// 128. TMA writes each tile as 64-column slabs of 128-byte rows in the
// 128-byte swizzle (a 32-column slab in the 64-byte swizzle at hd 32), the
// layout the wgmma descriptors name. S = Q K^T is
// wgmma m64nBKk16 with both operands in shared memory (K-major) and f32
// accumulators; the softcap (tanh.approx, see tanh_softcap), masks and the
// online softmax (base 2, the scale folded into one FMA before ex2) run on
// the accumulator fragment, a row's max and sum reducing over the 4 threads
// that hold it; only tiles that cross the diagonal, the window edge or skv
// evaluate the mask. P is rounded to bf16 in registers and P V is wgmma with
// A = P from registers and B = V from shared memory, read MN-major through
// the transpose bit (no copy), one m64n64k16 per 64-column slab of the head
// dim, at the end of each tile. The two warpgroups interleave, so one's
// softmax runs while the other's products do. (Issuing tile j - 1's P V
// behind tile j's S, to overlap it with tile j's softmax inside a
// warpgroup, holds two P tiles in registers and measured slower at every
// head dim.) TMA fills rows past sq and keys past skv with zeros. The tensor
// maps are built per call from the strides the caller passes, so GQA and
// views into a fused projection need no copy; their base must be 16-byte
// aligned and their strides multiples of 16 bytes (the wrapper raises
// otherwise).
//
// f32, used by the parity checks only: SIMT f32 math (the tensor cores take
// no f32 input at the f32 tolerance). One block of 256 threads per (q tile of
// 64 rows, head, batch); K and V stream through shared memory in tiles of 64
// keys (214 KB at hd 256). Thread (ty, tx) owns rows ty + 16 r (r < 4) of
// both the score tile (columns tx + 16 c) and the output (columns tx + 16 c),
// so the row max and row sum reduce over the 16 lanes of a half-warp.
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kNegInf = -1.0e30f;

// ---------------------------------------------------------------- f32: SIMT

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per streamed tile
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kPS = kBK + 1;   // padded row stride of the probability tile

struct Args {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;  // (b, H, sq), or null
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

template <int HD>
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
  const float* q = a.q + bi * a.q_sb + hq * a.q_sh;
  const float* k = a.k + bi * a.k_sb + hk * a.k_sh;
  const float* v = a.v + bi * a.v_sb + hk * a.v_sh;

  for (int i = tid; i < kBQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    sQ[r * QS + d] = q0 + r < a.sq ? q[(q0 + r) * a.q_ss + d] : 0.f;
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
      sK[r * QS + d] = in ? k[(k0 + r) * a.k_ss + d] : 0.f;
      sV[i] = in ? v[(k0 + r) * a.v_ss + d] : 0.f;
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

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q0 + ty + 16 * r;
    if (qi >= a.sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-20f);
    if (a.lse != nullptr && tx == 0)
      a.lse[(bi * a.h + hq) * a.sq + qi] = m[r] + logf(fmaxf(l[r], 1e-20f));
    float* row = a.o + ((bi * a.sq + qi) * a.h + hq) * HD;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tx + 16 * c] = acc[r][c] * inv;
  }
}

// Opt the kernel in to `bytes` of dynamic shared memory, once per device
// (`done` holds a bit per device that has it); the launch path then pays no
// attribute call.
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

template <int HD>
int launch_f32(const Args& a, int b, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  static std::atomic<uint32_t> smem_set{0};
  cudaError_t err = opt_in_smem(flash_kernel<HD>, (int)bytes, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.sq + kBQ - 1) / kBQ, a.h, b);
  flash_kernel<HD><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------ bf16: tensor cores

constexpr int kTQ = 128;          // query rows per CTA: two consumer warpgroups of 64
constexpr int kTCThreads = 288;   // warpgroups 0-1 consume, warp 8 produces

template <int HD>
struct Tile {
  // keys per streamed tile: 64 at hd 256, where registers and shared memory
  // bind, and at hd 64, where 64 took 11% less time than 128 at smollm's
  // shape (ptxas: 90 registers against 128, so two CTAs fit an SM); 128 at
  // hd 32 and 128
  static constexpr int BK = HD == 64 || HD == 256 ? 64 : 128;
  // K / V ring depth: as deep as the 227 KB of shared memory allows
  static constexpr int STAGES = HD <= 64 ? 4 : HD == 128 ? 3 : 2;
  static constexpr int SLAB = HD < 64 ? HD : 64;    // head-dim columns per swizzled slab
  static constexpr int ROW = SLAB * 2;              // bytes in one slab row: 128 (64 at hd 32)
  static constexpr int NSLAB = HD / SLAB;
  static constexpr int Q_BYTES = kTQ * HD * 2;
  static constexpr int KV_BYTES = BK * HD * 2;      // one K or V tile
  // 1 KB of slack to align the tiles to the 1 KB swizzle atom, then Q, the K
  // and V rings, and 1 + 4 x STAGES mbarriers
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * (1 + 4 * STAGES);
  static constexpr uint64_t SWIZZLE = ROW == 128 ? 1 : 2;  // wgmma layout: 128 B or 64 B
};

struct TcArgs {
  __nv_bfloat16* o;
  float* lse;             // (b, H, sq) in natural units, or null
  int sq, skv, h, kvh;
  int causal, window;
  int softcap;            // whether to apply c tanh(s / c)
  float pre, post;        // t = post * tanh(pre * s) with softcap, else t = pre * s (log2 units)
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the barrier's phase differs from `parity`. A wait that lasts
// seconds can only be a fault (a copy that never lands), so it traps: the
// launch then fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 33)) __trap();
  }
}

// TMA: one box of a 4-d tensor map (hd, heads, s, b) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode in bits 62-63.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (swizzle << 62);
}

// A descriptor `bytes` further on. The add sits in the loop that issues the
// product (volatile asm), so the compiler does not hoist one 64-bit
// descriptor per k-step out of the key loop and hold them all in registers.
__device__ __forceinline__ uint64_t desc_at(uint64_t desc, uint32_t bytes) {
  uint64_t out;
  asm volatile("add.s64 %0, %1, %2;\n" : "=l"(out) : "l"(desc), "l"((uint64_t)(bytes >> 4)));
  return out;
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of a wgmma accumulator
// across the asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh for the softcap: tanh.approx.f32, one instruction, which errs by up
// to 2^-11 of its value (up to 0.02 of a logit at cap 50). Held on the card
// with scores near the cap, where that error is largest, the kernel reads
// 1.52 rounding units of the f32 attention, against 1.38 with a tanh
// accurate to 1e-7 (1 - 2 / (e^2x + 1) from ex2 and rcp), which takes two
// MUFU operations a score and 1-3% more time at gemma2's shape (PERF.md).
__device__ __forceinline__ float tanh_softcap(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D (64 x N, f32) += A (64 x 16) B (16 x N), bf16 operands. The accumulator
// fragment: thread t of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4
// and that + 8, columns 8 c + 2 (t % 4) + {0, 1}, in d[4 c + 2 row + col].
// _ss: A and B in shared memory, both K-major. _rs: A from registers in the
// m16n8k16 A-fragment layout, B in shared memory MN-major (transposed).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
struct Mma;
template <>
struct Mma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
    wgmma_ss_n64(d, da, db, acc);
  }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
    wgmma_rs_n64(d, a, db);
  }
};
template <>
struct Mma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
    wgmma_ss_n128(d, da, db, acc);
  }
};
template <>
struct Mma<32> {
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
    wgmma_rs_n32(d, a, db);
  }
};

__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep P's registers alive (and unchanged) until the product reading them
// has completed.
template <int A, int B>
__device__ __forceinline__ void pin(uint32_t (&r)[A][B]) {
#pragma unroll
  for (int i = 0; i < A; ++i)
#pragma unroll
    for (int j = 0; j < B; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// O += P V over one V tile: one m64n{SLAB}k16 per head-dim slab and step of
// 16 keys, V read MN-major from the tile at `dv`.
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[Tile<HD>::NSLAB][Tile<HD>::SLAB / 2],
                                         const uint32_t (&p)[Tile<HD>::BK / 16][4], uint64_t dv) {
  using T = Tile<HD>;
  wg_fence();
#pragma unroll
  for (int j = 0; j < T::NSLAB; ++j)
#pragma unroll
    for (int kk = 0; kk < T::BK / 16; ++kk)
      Mma<T::SLAB>::rs(o[j], p[kk], desc_at(dv, j * T::BK * T::ROW + kk * 16 * T::ROW));
  wg_commit();
}

template <int HD>
__global__ void __launch_bounds__(kTCThreads, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, TcArgs a) {
  using T = Tile<HD>;
  constexpr int BK = T::BK, SLAB = T::SLAB, ROW = T::ROW, NSLAB = T::NSLAB;
  constexpr int kStages = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t sQ = (base + 1023u) & ~1023u;       // NSLAB slabs of kTQ rows
  const uint32_t sK = sQ + T::Q_BYTES;               // kStages tiles of NSLAB slabs of BK rows
  const uint32_t sV = sK + kStages * T::KV_BYTES;
  // mbarriers: the Q tile, then per stage K full, V full, K empty, V empty
  const uint32_t q_full = sV + kStages * T::KV_BYTES;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages, v_empty = k_empty + 8 * kStages;

  // causal q tiles in reverse, so the longest start first and the short ones
  // fill the tail
  const int q_tile = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = q_tile * kTQ, hq = blockIdx.y, bi = blockIdx.z;
  const int hk = hq / (a.h / a.kvh);
  // the key tiles this q tile can see: [t_lo, t_hi)
  const int q_last = min(q0 + kTQ, a.sq) - 1;
  const int hi = a.causal ? min(a.skv, q_last + 1) : a.skv;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int t_lo = lo / BK, t_hi = hi > lo ? (hi + BK - 1) / BK : t_lo;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(k_full + 8 * st, 1);
      mbar_init(v_full + 8 * st, 1);
      mbar_init(k_empty + 8 * st, 2 * 128);  // every consumer thread releases the tile
      mbar_init(v_empty + 8 * st, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index through a shuffle, so the compiler sees it is uniform
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 2) {  // producer warp: one thread issues every copy
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, T::Q_BYTES);
      for (int j = 0; j < NSLAB; ++j)
        tma_load(sQ + j * kTQ * ROW, &tq, q_full, j * SLAB, hq, q0, bi);
      for (int t = t_lo; t < t_hi; ++t) {
        const int i = t - t_lo, st = i % kStages, avail = ((i / kStages) & 1) ^ 1;
        mbar_wait(k_empty + 8 * st, avail);
        mbar_expect_tx(k_full + 8 * st, T::KV_BYTES);
        for (int j = 0; j < NSLAB; ++j)
          tma_load(sK + st * T::KV_BYTES + j * BK * ROW, &tk, k_full + 8 * st, j * SLAB, hk,
                   t * BK, bi);
        mbar_wait(v_empty + 8 * st, avail);
        mbar_expect_tx(v_full + 8 * st, T::KV_BYTES);
        for (int j = 0; j < NSLAB; ++j)
          tma_load(sV + st * T::KV_BYTES + j * BK * ROW, &tv, v_full + 8 * st, j * SLAB, hk,
                   t * BK, bi);
      }
    }
  } else {  // consumer warpgroups 0 and 1: 64 query rows each
    const int tid = threadIdx.x % 128;
    const int lane = tid % 32, cq = 2 * (lane % 4);
    const int row0 = q0 + 64 * wg + 16 * (tid / 32) + lane / 4;  // and row0 + 8
    const int w_first = q0 + 64 * wg, w_last = min(w_first + 63, a.sq - 1);
    // base-2 logits t = mul * s (softcap: s is first replaced by c tanh(s / c) log2 e)
    const float mul = a.softcap ? 1.f : a.pre;

    float o[NSLAB][SLAB / 2];
#pragma unroll
    for (int j = 0; j < NSLAB; ++j)
#pragma unroll
      for (int e = 0; e < SLAB / 2; ++e) o[j][e] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    // K-major Q and K (the leading offset is unused under a swizzle); V
    // MN-major: 8 keys of ROW bytes form one swizzle atom and the next 8 keys
    // sit 8 ROW further (a slab is one atom wide, so the other offset is never
    // stepped)
    const uint64_t dq = smem_desc(sQ + wg * 64 * ROW, 16, 8 * ROW, T::SWIZZLE);
    const uint64_t dk = smem_desc(sK, 16, 8 * ROW, T::SWIZZLE);
    const uint64_t dv = smem_desc(sV, 8 * ROW, 8 * ROW, T::SWIZZLE);

    // Each tile: S = Q K^T (K released as soon as S is done), the softmax on
    // the fragment, then O += P V (V released once that product is done).
    mbar_wait(q_full, 0);
    for (int t = t_lo; t < t_hi; ++t) {
      const int i = t - t_lo, st = i % kStages, phase = (i / kStages) & 1, k0 = t * BK;
      mbar_wait(k_full + 8 * st, phase);
      // a tile none of this warpgroup's rows can see is skipped
      const bool seen = !(w_first >= a.sq || (a.causal && k0 > w_last) ||
                          (a.window > 0 && k0 + BK - 1 <= w_first - a.window));
      if (!seen) {  // K and V are never read: release them once they have landed
        mbar_arrive(k_empty + 8 * st);
        mbar_wait(v_full + 8 * st, phase);
        mbar_arrive(v_empty + 8 * st);
        continue;
      }
      float s[BK / 2];
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int slab = kk * 16 / SLAB, off = (kk * 16 % SLAB) * 2;
        Mma<BK>::ss(s, desc_at(dq, slab * kTQ * ROW + off),
                    desc_at(dk, st * T::KV_BYTES + slab * BK * ROW + off), kk > 0);
      }
      wg_commit();
      wg_wait();
      pin(s);
      mbar_arrive(k_empty + 8 * st);

      // softcap, mask, then the online softmax in base 2
      if (a.softcap) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) s[e] = a.post * tanh_softcap(a.pre * s[e]);
      }
      const bool clear = k0 + BK <= a.skv && (!a.causal || k0 + BK - 1 <= w_first) &&
                         (a.window == 0 || k0 > w_last - a.window);
      if (!clear) {
#pragma unroll
        for (int e = 0; e < BK / 2; ++e) {
          const int kj = k0 + 8 * (e >> 2) + cq + (e & 1), qi = row0 + 8 * ((e >> 1) & 1);
          const bool ok = kj < a.skv && (!a.causal || kj <= qi) &&
                          (a.window == 0 || kj > qi - a.window);
          if (!ok) s[e] = -INFINITY;
        }
      }
      float mx[2] = {-INFINITY, -INFINITY}, alpha[2];
#pragma unroll
      for (int e = 0; e < BK / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r] * mul);  // finite: m starts at -1e30
        alpha[r] = exp2_approx(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      // P in the A-fragment layout: step kk's registers are s[8 kk .. 8 kk + 7]
      uint32_t p[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int h4 = 0; h4 < 4; ++h4) {
          const int r = h4 & 1;
          const float p0 = exp2_approx(fmaf(s[8 * kk + 2 * h4], mul, -m[r]));
          const float p1 = exp2_approx(fmaf(s[8 * kk + 2 * h4 + 1], mul, -m[r]));
          l[r] += p0 + p1;
          p[kk][h4] = pack_bf16(p0, p1);
        }
#pragma unroll
      for (int j = 0; j < NSLAB; ++j)
#pragma unroll
        for (int e = 0; e < SLAB / 2; ++e) o[j][e] *= alpha[(e >> 1) & 1];
      mbar_wait(v_full + 8 * st, phase);
      issue_pv<HD>(o, p, desc_at(dv, st * T::KV_BYTES));
      wg_wait();
#pragma unroll
      for (int j = 0; j < NSLAB; ++j) pin(o[j]);
      pin(p);
      mbar_arrive(v_empty + 8 * st);
    }

    // O / max(l, 1e-20), rounded to bf16, (b, sq, H, hd) contiguous
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const int qi = row0 + 8 * r;
      if (qi >= a.sq) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-20f);
      // m is in base-2 units: LSE = ln 2 (m + log2 l)
      if (a.lse != nullptr && cq == 0)
        a.lse[((long long)bi * a.h + hq) * a.sq + qi] =
            0.6931471805599453f * (m[r] + log2f(fmaxf(l[r], 1e-20f)));
      __nv_bfloat16* out = a.o + (((long long)bi * a.sq + qi) * a.h + hq) * HD + cq;
#pragma unroll
      for (int j = 0; j < NSLAB; ++j)
#pragma unroll
        for (int c = 0; c < SLAB / 8; ++c)
          *reinterpret_cast<uint32_t*>(out + j * SLAB + 8 * c) =
              pack_bf16(o[j][4 * c + 2 * r] * inv, o[j][4 * c + 2 * r + 1] * inv);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime, so the
// library links without -lcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (hd, heads, s, b) tensor map over a bf16 tensor with element strides
// (sh, ss, sb); boxes of (slab, 1, rows, 1). A dimension of extent 1 gets
// the packed stride (its own stride is never stepped).
bool make_map(CUtensorMap* map, const void* ptr, int hd, int heads, int s, int b, long long sh,
              long long ss, long long sb, int slab, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)heads, (cuuint64_t)s, (cuuint64_t)b};
  cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2, (cuuint64_t)sb * 2};
  cuuint64_t packed = (cuuint64_t)hd * 2;
  for (int i = 0; i < 3; ++i) {
    if (dims[i + 1] == 1) strides[i] = packed;
    packed = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {(cuuint32_t)slab, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      slab * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct Strides {
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh;
};

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const TcArgs& a, int b,
                const Strides& st, cudaStream_t stream) {
  using T = Tile<HD>;
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, HD, a.h, a.sq, b, st.q_sh, st.q_ss, st.q_sb, T::SLAB, kTQ) ||
      !make_map(&tk, k, HD, a.kvh, a.skv, b, st.k_sh, st.k_ss, st.k_sb, T::SLAB, T::BK) ||
      !make_map(&tv, v, HD, a.kvh, a.skv, b, st.v_sh, st.v_ss, st.v_sb, T::SLAB, T::BK))
    return (int)cudaErrorInvalidValue;
  static std::atomic<uint32_t> smem_set{0};
  const cudaError_t err = opt_in_smem(flash_tc_kernel<HD>, T::SMEM, smem_set);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.sq + kTQ - 1) / kTQ, a.h, b);
  flash_tc_kernel<HD><<<grid, kTCThreads, T::SMEM, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

bool bad_sizes(int b, int h, int kvh, int window) {
  return h <= 0 || kvh <= 0 || h % kvh || h > 65535 || b > 65535 || window < 0;
}

}  // namespace

// hd in {32, 64, 128, 256}; kvh divides h; b and h at most 65535 (grid.z,
// grid.y). Strides in elements. `lse` (b, h, sq) f32 or null.
extern "C" int rt_flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int b, int sq, int skv, int h, int kvh, int hd,
                                      long long q_sb, long long q_ss, long long q_sh,
                                      long long k_sb, long long k_ss, long long k_sh,
                                      long long v_sb, long long v_ss, long long v_sh,
                                      int causal, int window, float softcap, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0) return 0;
  if (bad_sizes(b, h, kvh, window)) return (int)cudaErrorInvalidValue;
  Args a{static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
         static_cast<float*>(o), static_cast<float*>(lse), sq, skv, h, kvh, q_sb, q_ss, q_sh,
         k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, window, softcap, 1.0f / sqrtf((float)hd)};
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 32: return launch_f32<32>(a, b, s);
    case 64: return launch_f32<64>(a, b, s);
    case 128: return launch_f32<128>(a, b, s);
    case 256: return launch_f32<256>(a, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The same for bf16 q, k, v and o; besides, q, k and v 16-byte aligned with
// strides that are multiples of 8 elements (TMA's rule).
extern "C" int rt_flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int b, int sq, int skv, int h, int kvh, int hd,
                                       long long q_sb, long long q_ss, long long q_sh,
                                       long long k_sb, long long k_ss, long long k_sh,
                                       long long v_sb, long long v_ss, long long v_sh,
                                       int causal, int window, float softcap, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0) return 0;
  if (bad_sizes(b, h, kvh, window)) return (int)cudaErrorInvalidValue;
  const float log2e = 1.4426950408889634f, scale = 1.0f / sqrtf((float)hd);
  TcArgs a{static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), sq, skv, h, kvh, causal,
           window, softcap > 0.f, softcap > 0.f ? scale / softcap : scale * log2e,
           softcap * log2e};
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 32: return launch_bf16<32>(q, k, v, a, b, st, s);
    case 64: return launch_bf16<64>(q, k, v, a, b, st, s);
    case 128: return launch_bf16<128>(q, k, v, a, b, st, s);
    case 256: return launch_bf16<256>(q, k, v, a, b, st, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

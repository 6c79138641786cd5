"""Edited copies of the kernels beside the shipped ones, on the card:
planted faults (does the check catch them?) and design variants (what does
a choice cost?).

    PYTHONPATH=src python -m repro_torch.kernels.variants [--only FILE ...] [--source NAME=FILE ...]
        [--sources-only]

Each variant is a shipped ``csrc`` file with textual edits (each edit must
match exactly once, or the run fails). All variants build at once, one nvcc
each with the shipped flags, into their own libraries under
``build/repro_torch/variants/``, and are called through the same C entry
point as the shipped kernel. ``--source NAME=FILE`` adds a whole file as one
more variant of the shipped file of the same name (an earlier revision, say);
``--only FILE`` keeps the variants and cases of that source file alone, and
``--sources-only`` runs the ``--source`` files without the edited variants.

Prints ptxas's registers and spills for each variant's kernels, then for
each case the shipped kernel first and last (so drift shows) and every
variant between: the median time (CUDA events, L2 flushed before each
launch) and the error against the plain version. Flash attention reads its
largest absolute error against ``attention_ref`` (bf16) and its rounding
units against the f32 attention (``ref.rounding_units``, held to
``BF16_UNITS_TOL``); the flash backward each of dQ, dK and dV's largest
error over its max |g| (against ``attention_bwd_ref`` at the plain LSE,
held to ``BWD_BF16_TOL`` / ``BWD_F32_TOL``); the scan its largest error over
max|y|. Top-k,
quantize and dequantize must be bit-identical to the plain versions in
``codec/ref.py``: on random data at the payload shapes of the gossip path,
and on data built to hit the tie rules (equal magnitudes at the k-th place;
x / scale on exact .5 ties, see :func:`half_ties`). A whole ``--source``
codec file also runs whole gossip rounds (``topk_sweep`` for top-k,
``quantized_table3`` for the quantizer, 12 rounds each) with its kernels in
place of the shipped ones, shipped / it / it / shipped. Needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np

from . import _build

VARIANT_ROOT = _build.BUILD_ROOT / "variants"


@dataclass(frozen=True)
class Variant:
    name: str
    source: str                           # the csrc file it edits
    edits: Tuple[Tuple[str, str], ...] = ()
    text: str = ""                        # a whole file instead of edits

# top-k's other design, inserted ahead of the threshold select (which then
# never runs): k rounds of an argmax in two warp reductions, the largest
# remaining key (ties to the lowest index) taken each round; an unselected
# key is |x|'s bits + 1, a taken one 0
ARGMAX_SELECT = """  if (k > 0) {
#pragma unroll
    for (int j = 0; j < V; ++j) key[j] += 1u;
    for (int t = 0; t < k; ++t) {
      unsigned best = key[0];
      int bj = 0;
#pragma unroll
      for (int j = 1; j < V; ++j) {
        if (key[j] > best) {  // strict: the lowest j among equal keys
          best = key[j];
          bj = j;
        }
      }
      const unsigned m = __reduce_max_sync(kFull, best);
      const unsigned cand = best == m ? (unsigned)(bj * 32 + lane) : kFull;
      const unsigned w = __reduce_min_sync(kFull, cand);
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (cand == w && j == bj) key[j] = 0u;
    }
    pack<V>(v, [&](int j) { return key[j] == 0u; }, out_v, out_i, lane);
    return;
  }
"""

# the backward's tensor-core products, where a planted fault zeroes one
# step's A operand (the step's tile then adds nothing; the pipeline runs on)
BWD_DV = "    wg_fence();\n    issue_rs<HD, BM>(dv, p, "
BWD_DK = "    wg_fence();\n    issue_rs<HD, BM>(dk, x, "
BWD_DQ = "    wg_fence();\n    issue_rs<HD, BN>(dq, x, "


def bwd_skip(cond: str, operand: str, k: str, indent: str = "    ") -> str:
    return (f"{indent}if ({cond})\n{indent}  for (int kk = 0; kk < {k} / 16; ++kk)\n"
            f"{indent}    for (int h4 = 0; h4 < 4; ++h4) {operand}[kk][h4] = 0u;\n")


# GQA's other design for the dK / dV pass: a block per (key tile, query
# head), each writing its head's share of dK and dV to an f32 scratch
# (b, skv, H, hd) x 2, and a third launch summing each kv head's shares in
# head order (deterministic), as the earlier mma.sync kernel did
BWD_GROUP_SUM = """// the group's shares in the scratch, summed in head order
__global__ void __launch_bounds__(256) group_sum_kernel(TcArgs a, int hd, long long n_out) {
  const int group = a.h / a.kvh;
  const long long half = n_out * group;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n_out;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / hd;  // (b, s, kv head)
    const int d = (int)(i % hd), hk = (int)(row % a.kvh);
    const float* w = a.ws + ((row / a.kvh) * a.h + (long long)hk * group) * hd + d;
    float sk = 0.f, sv = 0.f;
    for (int gi = 0; gi < group; ++gi) {
      sk += w[gi * hd];
      sv += w[half + gi * hd];
    }
    a.dk[i] = __float2bfloat16(sk);
    a.dv[i] = __float2bfloat16(sv);
  }
}

"""
BWD_SPLIT_HEADS = (
    ("  float scale;       // hd^-0.5\n};", "  float scale;       // hd^-0.5\n  float* ws;\n};"),
    ("softcap * kLog2e, scale};", "softcap * kLog2e, scale, static_cast<float*>(ws)};"),
    ("  const int per = T::SPLIT * a.kvh * a.b;", "  const int per = T::SPLIT * a.h * a.b;"),
    ("  const int hk = rest % a.kvh, bi = rest / a.kvh, group = a.h / a.kvh;",
     "  const int hq0 = rest % a.h, bi = rest / a.h, hk = hq0 / (a.h / a.kvh), group = 1;"),
    ("      const int hq = hk * group + g;\n      const long long row_off",
     "      const int hq = hq0 + g;\n      const long long row_off"),
    ("  store_rows<HD>(a.dk + off, rs, r0, a.skv - k0, dk, a.scale, cq, HD - split * T::COLS);\n"
     "  store_rows<HD>(a.dv + off, rs, r0, a.skv - k0, dv, 1.f, cq, HD - split * T::COLS);\n",
     "  (void)off;\n"
     "  const long long half = (long long)a.b * a.skv * a.h * HD;\n"
     "  for (int hh = 0; hh < 2; ++hh) {\n"
     "    const int kj = k0 + r0 + 8 * hh;\n"
     "    if (kj >= a.skv) continue;\n"
     "    float* w = a.ws + (((long long)bi * a.skv + kj) * a.h + hq0) * HD + split * T::COLS\n"
     "               + cq;\n"
     "    for (int j = 0; j < T::CSLAB; ++j)\n"
     "      for (int c = 0; c < SLAB / 8; ++c) {\n"
     "        const int col = j * SLAB + 8 * c;\n"
     "        w[col] = dk[j][4 * c + 2 * hh] * a.scale;\n"
     "        w[col + 1] = dk[j][4 * c + 2 * hh + 1] * a.scale;\n"
     "        w[half + col] = dv[j][4 * c + 2 * hh];\n"
     "        w[half + col + 1] = dv[j][4 * c + 2 * hh + 1];\n"
     "      }\n"
     "  }\n"),
    ("// Both passes in one grid: the dK / dV",
     BWD_GROUP_SUM + "// Both passes in one grid: the dK / dV"),
    ("  const int n_dkdv = (a.skv + 63) / 64 * T::SPLIT * a.kvh * a.b;",
     "  const int n_dkdv = (a.skv + 63) / 64 * T::SPLIT * a.h * a.b;"),
    ("                                                                 a, n_dkdv);\n"
     "  return (int)cudaGetLastError();",
     "                                                                 a, n_dkdv);\n"
     "  const long long n_out = (long long)a.b * a.skv * a.kvh * HD;\n"
     "  const int blocks = (int)((n_out + 255) / 256 < 4096 ? (n_out + 255) / 256 : 4096);\n"
     "  group_sum_kernel<<<blocks, 256, 0, stream>>>(a, HD, n_out);\n"
     "  return (int)cudaGetLastError();"),
)

VARIANTS = (
    # planted faults: each must fail the check where it applies
    Variant("fault: the middle key tile of a range of 8 or more skipped", "flash_attention.cu",
            (("const bool seen = !(",
              "const bool seen = (t_hi - t_lo < 8 || t != (t_lo + t_hi) / 2) && !("),)),
    Variant("fault: the window's first key tile dropped", "flash_attention.cu",
            (("const int t_lo = lo / BK,", "const int t_lo = lo / BK + (lo > 0),"),)),
    Variant("fault: the window's mask one key too wide", "flash_attention.cu",
            (("(a.window == 0 || kj > qi - a.window);",
              "(a.window == 0 || kj >= qi - a.window);"),)),
    # precision and design choices
    Variant("softcap through an accurate tanh (ex2 and rcp)", "flash_attention.cu",
            ((r'''asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));''',
              r'''asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(2.8853900817779268f * x));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(y + 1.f));
  y = 1.f - 2.f * y;'''),)),
    Variant("128-key tiles at hd 64", "flash_attention.cu",
            (("static constexpr int BK = HD == 64 || HP > 128 ? 64 : 128;",
              "static constexpr int BK = HP > 128 ? 64 : 128;"),)),
    Variant("scan: two states a group", "selective_scan.cu",
            (("constexpr int kGroup = 4;", "constexpr int kGroup = 2;"),)),
    Variant("scan: 4 channels x 8 segments a warp", "selective_scan.cu",
            (("constexpr int kCh = 8;", "constexpr int kCh = 4;"),
             ("constexpr int kSegs = 4;", "constexpr int kSegs = 8;"))),
    # the flash backward: planted faults, from the row a tile's largest P
    # sits in to one near zero, to set the bf16 tolerance between them (the
    # SIMT ones apply to the f32 cases)
    Variant("fault: backward, SIMT, the diagonal query tile skipped in dK, dV (8+ tiles)",
            "flash_attention_bwd.cu",
            (("    for (int q0 = (q_lo / kBQ) * kBQ; q0 < q_hi; q0 += kBQ) {",
              "    for (int q0 = (q_lo / kBQ) * kBQ + (q_hi - q_lo >= 8 * kBQ ? kBQ : 0); "
              "q0 < q_hi;\n         q0 += kBQ) {"),)),
    Variant("fault: backward, SIMT, the last query tile skipped in dK, dV (8+ tiles)",
            "flash_attention_bwd.cu",
            (("    for (int q0 = (q_lo / kBQ) * kBQ; q0 < q_hi; q0 += kBQ) {",
              "    for (int q0 = (q_lo / kBQ) * kBQ;\n"
              "         q0 < q_hi && (q_hi - q_lo < 8 * kBQ || q0 + kBQ < q_hi); q0 += kBQ) {"),)),
    Variant("fault: backward, SIMT, dQ's middle key tile skipped (8+ tiles)",
            "flash_attention_bwd.cu",
            (("    __syncthreads();  // the previous tile's sK, sV and sdX are no longer read",
              "    if (hi - lo >= 8 * BK && k0 == (lo / BK + (hi - 1) / BK) / 2 * BK) continue;\n"
              "    __syncthreads();  // the previous tile's sK, sV and sdX are no longer read"),)),
    Variant("fault: backward, the diagonal query tile skipped in dK, dV (8+ tiles)",
            "flash_attention_bwd.cu",
            ((BWD_DV, bwd_skip("i % n_t == 0 && n_t >= 8", "p", "BM") + BWD_DV),
             (BWD_DK, bwd_skip("i % n_t == 0 && n_t >= 8", "x", "BM") + BWD_DK))),
    Variant("fault: backward, the last query tile skipped in dK, dV (8+ tiles)",
            "flash_attention_bwd.cu",
            ((BWD_DV, bwd_skip("i % n_t == n_t - 1 && n_t >= 8", "p", "BM") + BWD_DV),
             (BWD_DK, bwd_skip("i % n_t == n_t - 1 && n_t >= 8", "x", "BM") + BWD_DK))),
    Variant("fault: backward, dQ's middle key tile skipped (8+ tiles)", "flash_attention_bwd.cu",
            ((BWD_DQ, bwd_skip("n_iter >= 8 && i == (n_iter - 1) / 2", "x", "BN") + BWD_DQ),)),
    Variant("fault: backward, the diagonal tile taken as clear", "flash_attention_bwd.cu",
            (("(!a.causal || k0 + BN - 1 <= q0)", "(!a.causal || k0 <= q0)"),
             ("(!a.causal || k0 + 63 <= q0)", "(!a.causal || k0 <= q0)"))),
    Variant("fault: backward, the window's mask one key too wide", "flash_attention_bwd.cu",
            (("(a.window == 0 || kj > qi - a.window);", "(a.window == 0 || kj >= qi - a.window);"),)),
    Variant("fault: backward, the softcap's chain factor dropped", "flash_attention_bwd.cu",
            (("    chain = fmaf(-th, th, 1.f);", "    chain = fmaf(0.f * th, th, 1.f);"),
             ("    dx *= 1.f - th * th;", "    dx *= 1.f + 0.f * th;"))),
    # design choices
    Variant("backward: 64 queries a dK / dV step at hd 64 too", "flash_attention_bwd.cu",
            (("static constexpr int BM = HD <= 64 ? 32 : 64;", "static constexpr int BM = 64;"),)),
    Variant("backward: 32 queries a dK / dV step at every head dim", "flash_attention_bwd.cu",
            (("static constexpr int BM = HD <= 64 ? 32 : 64;", "static constexpr int BM = 32;"),)),
    Variant("backward: a ring of 2 stages at every head dim", "flash_attention_bwd.cu",
            (("static constexpr int STAGES = HD <= 128 ? 3 : 2;", "static constexpr int STAGES = 2;"),)),
    Variant("backward: a ring of 2 stages at hd 128", "flash_attention_bwd.cu",
            (("static constexpr int STAGES = HD <= 128 ? 3 : 2;",
              "static constexpr int STAGES = HD <= 64 ? 3 : 2;"),)),
    Variant("backward: both passes held to 200 registers (2 blocks an SM at every head dim)",
            "flash_attention_bwd.cu",
            (("__launch_bounds__(kTcThreads, 1)\nbwd_tc_kernel",
              "__launch_bounds__(kTcThreads, 2)\nbwd_tc_kernel"),)),
    Variant("backward: the two passes as two launches (dQ, then dK / dV)", "flash_attention_bwd.cu",
            (("  bwd_tc_kernel<HD><<<n_dkdv + n_dq, kTcThreads, smem, stream>>>(q64, do64, k64, v64, "
              "qbm, dobm,\n                                                                 a, n_dkdv);",
              "  bwd_tc_kernel<HD><<<n_dq, kTcThreads, smem, stream>>>(q64, do64, k64, v64, qbm, "
              "dobm, a, 0);\n  bwd_tc_kernel<HD><<<n_dkdv, kTcThreads, smem, stream>>>(q64, do64, "
              "k64, v64, qbm, dobm, a,\n                                                          "
              "n_dkdv);"),)),
    Variant("backward: GQA split over query heads, f32 scratch summed by a third launch",
            "flash_attention_bwd.cu", BWD_SPLIT_HEADS),
    Variant("backward: P by an accurate expf", "flash_attention_bwd.cu",
            (("    p = exp2_approx(fmaf(a.post, th, -lse2));",
              "    p = expf(fmaf(a.post, th, -lse2) * 0.6931471805599453f);"),
             ("    p = exp2_approx(fmaf(s, a.pre, -lse2));",
              "    p = expf(fmaf(s, a.pre, -lse2) * 0.6931471805599453f);"))),
    Variant("backward: every tile masked (no clear-tile path)", "flash_attention_bwd.cu",
            (("const bool clear = q0 + 64 <= a.sq &&", "const bool clear = a.sq < 0 &&"),
             ("const bool clear = q0 + BM <= a.sq &&", "const bool clear = a.sq < 0 &&"))),
    # ablations: a part of the work skipped where the compiler cannot see it
    # never runs, so its time shows what that part costs (they fail the check)
    Variant("ablation: backward, D alone", "flash_attention_bwd.cu",
            (("  bwd_tc_kernel<HD><<<n_dkdv + n_dq,",
              "  if (a.sq < 0) bwd_tc_kernel<HD><<<n_dkdv + n_dq,"),)),
    Variant("ablation: backward, D and the dQ pass only", "flash_attention_bwd.cu",
            (("    dkdv_block<HD>(tk, tv, tq_bm, tdo_bm, a, blockIdx.x);",
              "    {\n      if (a.sq < 0) dkdv_block<HD>(tk, tv, tq_bm, tdo_bm, a, blockIdx.x);\n    }"),)),
    Variant("ablation: backward, D and the dK / dV pass only", "flash_attention_bwd.cu",
            (("    dq_block<HD>(tq, tdo, tk, tv, a, blockIdx.x - n_dkdv);",
              "    {\n      if (a.sq < 0) dq_block<HD>(tq, tdo, tk, tv, a, blockIdx.x - n_dkdv);\n    }"),)),
    Variant("ablation: backward, no mask (every pair visible)", "flash_attention_bwd.cu",
            (("  return qi < a.sq && kj < a.skv && (!a.causal || kj <= qi) &&\n"
              "         (a.window == 0 || kj > qi - a.window);",
              "  return a.sq > 0;"),)),
    Variant("ablation: backward, no elementwise work (P = S, dX = dP)", "flash_attention_bwd.cu",
            (("                                          float& p) {\n",
              "                                          float& p) {\n  if (a.sq > 0) {\n"
              "    p = s;\n    return dp;\n  }\n"),)),
    # the gossip wire's codecs
    Variant("fault: top-k ties at T taken from the higher index", "topk_pack.cu",
            (("const int need = k - (int)count_ge<V>(key, lo + 1u);",
              "const int need = k - (int)count_ge<V>(key, lo + 1u);\n"
              "    const int n_eq = (int)count_ge<V>(key, lo) - (k - need);"),
             ("const int rank = ties + __popc(be & below);",
              "const int rank = n_eq - 1 - ties - __popc(be & below);"))),
    Variant("top-k: k rounds of a two-redux argmax", "topk_pack.cu",
            (("  unsigned lane_max = key[0];", ARGMAX_SELECT + "  unsigned lane_max = key[0];"),)),
    Variant("top-k: threshold search from bit 30 (no lane-max bracket)", "topk_pack.cu",
            (("const unsigned lb = k <= 32 ? __reduce_min_sync(kFull, lane_max) : 0u;",
              "const unsigned lb = 0u;"),)),
    Variant("top-k: at most 32 registers (64 warps an SM)", "topk_pack.cu",
            (("__launch_bounds__(kWarps * 32)\ntopk_kernel",
              "__launch_bounds__(kWarps * 32, 8)\ntopk_kernel"),)),
    Variant("top-k: 4 warps a CTA", "topk_pack.cu",
            (("constexpr int kWarps = 8;", "constexpr int kWarps = 4;"),)),
    # ablations: a part of the work skipped where the compiler cannot see it
    # never runs, so its time shows what that part costs (they fail the check)
    Variant("ablation: top-k loads only (no search, no pack)", "topk_pack.cu",
            (("  unsigned lane_max = key[0];",
              "  unsigned acc = 0;\n"
              "  for (int j = 0; j < V; ++j) acc |= key[j];\n"
              "  if (k <= 1024) {\n"
              "    if (acc == 0x7fffffffu) out_v[0] = 0.f;\n"
              "    return;\n"
              "  }\n"
              "  unsigned lane_max = key[0];"),)),
    Variant("ablation: top-k search, no pack", "topk_pack.cu",
            (("  if (exact) {",
              "  if (k <= 1024) {\n"
              "    if (lo == 0xffffffffu) out_v[0] = 0.f;\n"
              "    return;\n"
              "  }\n"
              "  if (exact) {"),)),
    Variant("ablation: quantize absmax only (no codes)", "quant_pack.cu",
            (("  if (lane == 0) *scale_out = scale;",
              "  if (lane == 0) *scale_out = scale;\n  if (chunk > 0) return;"),)),
    Variant("fault: quantize by x * (1 / scale)", "quant_pack.cu",
            (("const float r = rintf(x / scale);", "const float r = rintf(x * (1.f / scale));"),)),
    Variant("quantize: 16 warps a CTA", "quant_pack.cu",
            (("constexpr int kQuantWarps = 8;", "constexpr int kQuantWarps = 16;"),)),
    Variant("quantize: 4 float4 a lane (a 1024-element chunk read twice)", "quant_pack.cu",
            (("constexpr int kVecs = 8;", "constexpr int kVecs = 4;"),)),
    Variant("quantize: at most 51 registers (5 CTAs, 40 warps an SM)", "quant_pack.cu",
            (("__launch_bounds__(kQuantWarps * 32)", "__launch_bounds__(kQuantWarps * 32, 5)"),)),
)

KERNELS = {"flash_attention.cu": ("flash_tc_kernel",), "selective_scan.cu": ("scan_kernel",),
           "topk_pack.cu": ("topk_kernel",), "quant_pack.cu": ("quantize_kernel",),
           "flash_attention_bwd.cu": ("bwd_tc_kernel",)}
# ptxas lines to print where a kernel has many instantiations: top-k at block
# 256, the flash backward's tensor-core passes (one kernel) at hd 64
PTXAS_ARGS = {"topk_pack.cu": "ILi8E", "flash_attention_bwd.cu": "ILi64E"}


def half_ties(rows: int, n_chunks: int, chunk: int, bits: int, seed: int = 0) -> np.ndarray:
    """(rows, n_chunks * chunk) f32 for the quantizer's tie rule: each
    chunk's absmax is one element, and the others are fl((n + 0.5) * scale)
    for integers n, so x / scale lands on an exact .5 tie under the true
    divide for ~9 in 10 of them; a reciprocal multiply moves ~1 in 8 of
    those off the tie, and the code rounds the other way."""
    qmax = 2 ** (bits - 1) - 1
    g = np.random.default_rng(seed)
    absmax = g.uniform(0.5, 8.0, size=(rows * n_chunks, 1)).astype(np.float32)
    scale = absmax / np.float32(qmax)
    n = g.integers(-qmax, qmax, size=(rows * n_chunks, chunk)).astype(np.float32) + 0.5
    x = (n.astype(np.float32) * scale).astype(np.float32)
    x[:, 0] = absmax[:, 0]
    return x.reshape(rows, n_chunks * chunk)


def variant_text(v: Variant) -> str:
    if v.text:
        return v.text
    text = (_build.CSRC / v.source).read_text()
    for old, new in v.edits:
        if text.count(old) != 1:
            raise ValueError(f"{v.name}: the edit {old!r} matches {text.count(old)} times")
        text = text.replace(old, new)
    return text


def build_all(variants: Sequence[Variant]) -> Dict[str, Path]:
    """Build each variant into its own library, all at once; prints ptxas's
    registers and spills for each variant's kernels."""
    nvcc = _build._nvcc()
    procs = []
    for i, v in enumerate(variants):
        out = VARIANT_ROOT / f"v{i}"
        out.mkdir(parents=True, exist_ok=True)
        src = out / v.source
        src.write_text(variant_text(v))
        lib = out / f"lib_v{i}.so"
        # the copy includes the shipped headers (csrc/*.cuh)
        cmd = [nvcc, *_build.ARCH_FLAGS, *_build.COMPILE_FLAGS, "-I", str(_build.CSRC),
               "-shared", "-o", str(lib), str(src)]
        procs.append((v, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for v, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {v.name}:\n{log[-4000:]}")
        lines = log.splitlines()
        serialized = sum("C7515" in line or "C7512" in line for line in lines)
        if serialized:
            print(f"[ptxas] {v.name}: wgmma serialized in {serialized} kernel(s) (C7512 / C7515)")
        for i, line in enumerate(lines):
            kernel = next((k for k in KERNELS[v.source] if k in line), None)
            if "Compiling entry function" in line and kernel is not None:
                name = line.split("'")[1].split(kernel, 1)[1].split("EEv")[0]
                if not name.startswith(PTXAS_ARGS.get(v.source, "")):
                    continue
                info = " | ".join(x.split(":", 1)[-1].strip() for x in lines[i + 2:i + 4])
                print(f"[ptxas] {v.name}: {kernel} {name}: {info}")
        libs[v.name] = lib
    return libs


def entry(lib_path: Path, name: str):
    fn = getattr(ctypes.CDLL(str(lib_path)), name)
    fn.argtypes = _build.SIGNATURES[name]
    fn.restype = ctypes.c_int
    return fn


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[], metavar="NAME=FILE",
                    help="a whole source file as one more variant")
    ap.add_argument("--only", action="append", default=[], metavar="FILE",
                    choices=sorted(KERNELS), help="run this source file's variants only")
    ap.add_argument("--sources-only", action="store_true",
                    help="run the --source files beside the shipped kernels, no edited variants")
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from .attention.ref import (BF16_UNITS_TOL, BWD_BF16_TOL, BWD_F32_TOL, attention_bwd_ref,
                                attention_lse_ref, attention_ref, rounding_units)
    from .codec import ref as codec_ref
    from .scan.ref import selective_scan_ref

    if not torch.cuda.is_available():
        print("variants: needs a CUDA device", file=sys.stderr)
        return 1
    variants = [] if args.sources_only else list(VARIANTS)
    for spec in args.source:
        name, _, path = spec.partition("=")
        file = Path(path)
        if file.name not in KERNELS:
            raise SystemExit(f"--source {spec}: the file must be one of {list(KERNELS)}")
        variants.append(Variant(name, file.name, text=file.read_text()))
    only = set(args.only or KERNELS)
    variants = [v for v in variants if v.source in only]
    libs = build_all(variants)
    _build.lib()
    shipped = _build.build_dir() / _build.LIB_NAME
    dev = torch.device("cuda")
    flush = torch.empty(128 * 2 ** 20, device=dev)  # 512 MB, above the 50 MB L2

    def median_ms(fn: Callable[[], int], iters: int = 10, clean: bool = False) -> float:
        """clean: flush the L2 by reading, not writing, so the kernel finds no
        dirty lines there to write back."""
        fn()
        torch.cuda.synchronize()
        spans = []
        for _ in range(iters):
            if clean:
                flush.sum()
            else:
                flush.zero_()
            torch.cuda._sleep(2_000_000)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            spans.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in spans)

    def runs(source: str):
        ours = [v for v in variants if v.source == source]
        return [("shipped", shipped), *[(v.name, libs[v.name]) for v in ours],
                ("shipped again", shipped)]

    print(f"[card] {torch.cuda.get_device_name(0)}")
    gen = torch.Generator(device=dev).manual_seed(0)
    flash_cases = [  # b, s, h, kv, hd, window, softcap, q scale
        (4, 2048, 15, 5, 64, 0, 0.0, 1.0),
        (1, 8192, 8, 4, 256, 4096, 50.0, 1.0),
        (1, 8192, 8, 4, 256, 4096, 50.0, 25.0),  # scores reach the cap
    ]
    for b, s, h, kv, hd, window, cap, q_scale in (
            flash_cases if "flash_attention.cu" in only else []):
        q = (q_scale * torch.randn((b, s, h, hd), generator=gen, device=dev)).bfloat16()
        k = torch.randn((b, s, kv, hd), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, s, kv, hd), generator=gen, device=dev).bfloat16()
        kw = dict(causal=True, sliding_window=window, softcap=cap)
        plain = attention_ref(q, k, v, **kw).float()
        case = f"({b}, {s}, {h}/{kv}, {hd}) causal window {window} softcap {cap} q x{q_scale}"
        if window == 0 and cap == 0.0:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            sdpa = median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True))
            print(f"[flash] {case}: SDPA {sdpa:.4f} ms")
        first = None  # the shipped kernel's output, which a whole --source file matches or not
        for name, path in runs("flash_attention.cu"):
            fn = entry(path, "rt_flash_attention_bf16")
            out = torch.empty_like(q)

            def call(fn=fn, out=out):
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None,
                          b, s, s, h, kv, hd, *q.stride()[:3], *k.stride()[:3],
                          *v.stride()[:3], 1, window, cap, torch.cuda.current_stream().cuda_stream)

            status = call()
            torch.cuda.synchronize()
            if status != 0:
                raise RuntimeError(f"{name}: launch returned CUDA error {status}")
            err = float((out.float() - plain).abs().max())
            units = rounding_units(out, q, k, v, **kw)
            verdict = "passes" if err <= 2e-2 and units <= BF16_UNITS_TOL else "FAILS"
            if first is None:
                first = out
            same = "bit-identical to the shipped output" if torch.equal(out, first) else "differs"
            print(f"[flash] {case}: {name}: {median_ms(call):.4f} ms, max abs err {err:.5f} "
                  f"(tol 2e-2), {units:.2f} rounding units (tol {BF16_UNITS_TOL}): {verdict}; "
                  f"{same}")
        del q, k, v, plain

    bwd_cases = [  # b, s, h, kv, hd, window, softcap, dtype, q scale
        (2, 2048, 15, 5, 64, 0, 0.0, torch.bfloat16, 1.0),
        (2, 2048, 16, 8, 128, 0, 0.0, torch.bfloat16, 1.0),
        (1, 8192, 8, 4, 256, 4096, 50.0, torch.bfloat16, 1.0),
        (1, 8192, 8, 4, 256, 4096, 50.0, torch.bfloat16, 25.0),  # scores near the cap
        (2, 2048, 15, 5, 64, 0, 0.0, torch.float32, 1.0),
    ]
    for b, s, h, kv, hd, window, cap, dtype, q_scale in (
            bwd_cases if "flash_attention_bwd.cu" in only else []):
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev) for shape in (
            (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd), (b, s, h, hd)))
        q, k, v, do = (q * q_scale).to(dtype), k.to(dtype), v.to(dtype), do.to(dtype)
        kw = dict(causal=True, sliding_window=window, softcap=cap)
        out, lse = attention_lse_ref(q, k, v, **kw)
        out = out.contiguous()  # the C entry point reads o contiguous
        want = attention_bwd_ref(q, k, v, out, lse, do, **kw)
        scales = [float(w.float().abs().max()) for w in want]
        tol = BWD_F32_TOL if dtype == torch.float32 else BWD_BF16_TOL
        case = (f"({b}, {s}, {h}/{kv}, {hd}) {str(dtype)[6:]} causal window {window} "
                f"softcap {cap} q x{q_scale}")
        for name, path in runs("flash_attention_bwd.cu"):
            fn = entry(path, "rt_flash_attention_bwd")
            # filled, so a variant that leaves a gradient unwritten cannot pass
            grads = [torch.full_like(t, float("nan")) for t in (q, k, v)]
            dd = torch.empty((b, h, s), device=dev)
            ws = torch.empty((2, b, s, h, hd), device=dev)

            def call(fn=fn, grads=grads, dd=dd, ws=ws):
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          lse.data_ptr(), do.data_ptr(), dd.data_ptr(),
                          *[g.data_ptr() for g in grads], ws.data_ptr(), b, s, s, h, kv, hd, 1,
                          window, cap,
                          0 if dtype == torch.float32 else 1,
                          torch.cuda.current_stream().cuda_stream)

            status = call()
            torch.cuda.synchronize()
            if status != 0:
                raise RuntimeError(f"{name}: launch returned CUDA error {status}")
            rel = [float((g.float() - w.float()).abs().nan_to_num(float("inf")).max()) / sc
                   for g, w, sc in zip(grads, want, scales)]
            verdict = "passes" if max(rel) <= tol else "FAILS"
            print(f"[flash bwd] {case}: {name}: {median_ms(call, 5):.4f} ms, max err / max|g| "
                  f"dq {rel[0]:.2e}, dk {rel[1]:.2e}, dv {rel[2]:.2e} (tol {tol}): {verdict}")
        del q, k, v, do, out, lse, want

    for b in ((1, 2) if "selective_scan.cu" in only else ()):
        s, di, n = 2048, 8192, 16
        dt = F.softplus(torch.randn((b, s, di), generator=gen, device=dev))
        Bm = torch.randn((b, s, n), generator=gen, device=dev)
        Cm = torch.randn((b, s, n), generator=gen, device=dev)
        xs = torch.randn((b, s, di), generator=gen, device=dev).bfloat16()
        A_log = torch.log(torch.randn((di, n), generator=gen, device=dev).abs() + 0.5)
        Dp = torch.randn((di,), generator=gen, device=dev)
        py, ph = selective_scan_ref(dt, Bm, Cm, xs, A_log, Dp, out_dtype=torch.float32)
        for name, path in runs("selective_scan.cu"):
            fn = entry(path, "rt_selective_scan")
            y = torch.empty((b, s, di), device=dev)
            hl = torch.empty((b, di, n), device=dev)

            def call(fn=fn, y=y, hl=hl):
                return fn(dt.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), xs.data_ptr(),
                          A_log.data_ptr(), Dp.data_ptr(), y.data_ptr(), hl.data_ptr(), None,
                          b, s, di, n, 1, 0, torch.cuda.current_stream().cuda_stream)

            status = call()
            torch.cuda.synchronize()
            if status != 0:
                raise RuntimeError(f"{name}: launch returned CUDA error {status}")
            err = max(float((y - py).abs().max()), float((hl - ph).abs().max()))
            rel = err / max(1.0, float(py.abs().max()))
            print(f"[scan] ({b}, {s}, {di}, {n}) x bf16, y f32: {name}: "
                  f"{median_ms(call):.4f} ms, max err / max|y| {rel:.2e} (tol 1e-4)")
        del dt, Bm, Cm, xs, A_log, Dp, py, ph

    stream = torch.cuda.current_stream().cuda_stream

    def verdict(same: bool, n_diff: int, what: str) -> str:
        return "bit-identical: passes" if same else f"FAILS ({n_diff} {what} differ)"

    ties = torch.from_numpy(np.round(np.random.default_rng(1).normal(size=(4, 70_001)) * 12)
                            .astype(np.float32) / 4)
    ties[:, :23_000] = 0  # values on a 0.25 grid, a third of each row 0
    topk_cases = [("MobileNetV2 (1, 3.5 M)", torch.randn((1, 3_500_000), generator=gen,
                                                        device=dev) * 3),
                  ("the path's 3-row step (3, 3.5 M)", torch.randn((3, 3_500_000),
                                                                  generator=gen, device=dev)),
                  ("ties at the k-th place (4, 70 001)", ties.to(dev)),
                  ("one block (1, 256): the launch's fixed cost", torch.randn((1, 256),
                                                                           device=dev))]
    for label, x in (topk_cases if "topk_pack.cu" in only else []):
        k, block = 13, 256
        rows, size = x.shape
        nb = -(-size // block)
        want_v, want_i = codec_ref.topk_select_rows(x, k, block)
        lib_ms = median_ms(lambda: torch.topk(codec_ref.chunked(x, block).abs(), k, dim=1))
        print(f"[topk] {label}, k {k}, block {block}: torch.topk on |x| blocks (values "
              f"only, no index order; a diagnostic) {lib_ms:.4f} ms")
        for name, path in runs("topk_pack.cu"):
            fn = entry(path, "rt_topk_select")
            # filled, so a variant that leaves an output unwritten cannot pass
            vals = torch.full((rows, nb, k), float("nan"), device=dev)
            idx = torch.full((rows, nb, k), -1, dtype=torch.int32, device=dev)

            def call(fn=fn, vals=vals, idx=idx):
                return fn(x.data_ptr(), vals.data_ptr(), idx.data_ptr(), rows, size, nb,
                          block, k, stream)

            status = call()
            torch.cuda.synchronize()
            if status != 0:
                raise RuntimeError(f"{name}: launch returned CUDA error {status}")
            same = torch.equal(vals, want_v) and torch.equal(idx, want_i)
            clean = f" ({median_ms(call, 20, clean=True):.4f} ms from a clean L2)" \
                if name == "shipped" else ""
            print(f"[topk] {label}: {name}: {median_ms(call, 20):.4f} ms{clean}, "
                  f"{verdict(same, int((idx != want_i).sum()), 'indices')}")

    b0 = 5_300_000
    for bits in ((8, 4) if "quant_pack.cu" in only else ()):
        chunk = 1024
        quant_cases = [("EfficientNet-B0 (1, 5.3 M)", torch.randn((1, b0), generator=gen,
                                                                 device=dev) * 3),
                       ("the path's 2-row step (2, 5.3 M)", torch.randn(
                           (2, b0), generator=gen, device=dev) * 3),
                       ("x / scale on exact .5 ties (8, 64 chunks)",
                        torch.from_numpy(half_ties(8, 64, chunk, bits)).to(dev)),
                       ("one chunk (1, 1024): the launch's fixed cost",
                        torch.randn((1, chunk), device=dev))]
        for label, x in quant_cases:
            rows, size = x.shape
            nc = -(-size // chunk)
            want_c, want_s = codec_ref.quantize_rows(x, bits, chunk)
            want_out = codec_ref.dequantize_rows(want_c, want_s, size, bits, chunk)
            for name, path in runs("quant_pack.cu"):
                quant, dequant = entry(path, "rt_quantize"), entry(path, "rt_dequantize")
                codes, scales = torch.full_like(want_c, 99), torch.full_like(want_s, -1.0)
                out = torch.full_like(x, float("nan"))

                def q_call(fn=quant, codes=codes, scales=scales):
                    return fn(x.data_ptr(), codes.data_ptr(), scales.data_ptr(), rows, size,
                              nc, chunk, bits, stream)

                def d_call(fn=dequant, out=out):
                    return fn(want_c.data_ptr(), want_s.data_ptr(), out.data_ptr(), rows, size,
                              nc, chunk, bits, stream)

                status = q_call() or d_call()
                torch.cuda.synchronize()
                if status != 0:
                    raise RuntimeError(f"{name}: launch returned CUDA error {status}")
                same = torch.equal(codes, want_c) and torch.equal(scales, want_s)
                deq_same = torch.equal(out, want_out)
                clean = (f" ({median_ms(q_call, 20, clean=True):.4f} / "
                         f"{median_ms(d_call, 20, clean=True):.4f} ms from a clean L2)"
                         if name == "shipped" else "")
                print(f"[quant] int{bits} {label}: {name}: quantize {median_ms(q_call, 20):.4f} "
                      f"ms, {verdict(same, int((codes != want_c).sum()), 'codes')}; dequantize "
                      f"{median_ms(d_call, 20):.4f} ms, "
                      f"{verdict(deq_same, int((out != want_out).sum()), 'values')}{clean}")

    # whole gossip rounds with a --source file's codec kernels in place of the
    # shipped ones (the rest of the path as shipped), alternated
    round_cases = {"topk_pack.cu": ("topk_sweep", ("rt_topk_select",)),
                   "quant_pack.cu": ("quantized_table3", ("rt_quantize", "rt_dequantize"))}
    whole = [v for v in variants if v.text and v.source in round_cases]
    if whole:
        from ..scenario import SCENARIOS, run_scenario

        shipped_lib = _build.lib()

        def steady_rounds_ms(scenario: str, swap: Dict[str, Callable]) -> float:
            """Median device time of rounds 1-11 of 12 (round 0 warms up)."""
            proxy = SimpleNamespace(**{n: getattr(shipped_lib, n)
                                       for n in (*_build.SIGNATURES, "rt_error_string")})
            proxy.__dict__.update(swap)
            _build._lib = proxy
            try:
                run = run_scenario(SCENARIOS[scenario].replace(rounds=12), device="cuda",
                                   seed=1)
            finally:
                _build._lib = shipped_lib
            return statistics.median(r.device_ms for r in run.rounds[1:])

        for v in whole:
            scenario, names = round_cases[v.source]
            swap = {n: entry(libs[v.name], n) for n in names}
            times = [steady_rounds_ms(scenario, s) for s in ({}, swap, swap, {})]
            print(f"[rounds] {scenario}, median of 11 steady rounds: shipped {times[0]:.3f}, "
                  f"{v.name} {times[1]:.3f}, {times[2]:.3f}, shipped {times[3]:.3f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

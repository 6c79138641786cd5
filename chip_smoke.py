#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100: the MOSGU gossip round,
the model serving path (prefill forward + cached decode) and the DFL
training step (4 stacked nodes, forward, the flash-attention backward, the
optimizer and a gossip round).

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. build   — nvcc compiles ``src/repro_torch/csrc/*.cu`` for sm_90a; prints
             the build time, ptxas's registers and spills for the
             tensor-core flash kernel, the two passes of the flash backward
             at the shapes phase 2 runs (hd 64: tensor cores in bf16, SIMT
             in f32; SIMT bf16 at hd 256) and the scan, the count of HGMMA
             (wgmma) instructions in the flash object's SASS (cuobjdump),
             and the card's name and power limit.
2. kernels — each Hopper kernel at the main path's shapes against its plain
             PyTorch version on the same inputs. Quantize / dequantize (int8,
             int4) and top-k (k = 13) at every (rows, size) that phase 3
             launches them with, found by a dry run of its scenarios at the
             proxy size on the card (rows = a step's senders; size = the
             scenario's payload: EfficientNet-B0's 5.3 M f32, MobileNetV2's
             3.5 M, smollm-360m's 180.9 M for mesh_smoke int8); the FedAvg mix
             at (10, 10, 5.3 M). Quantize, dequantize and top-k must be
             bit-identical; the mix within rtol 1e-6 of max|x|. Prints each
             kernel's median time (CUDA events, L2 flushed before every
             launch by a write; for the codec kernels also from an L2 flushed
             by a read, with no dirty lines), its bound and the plain
             version's time; torch.topk on the |x| blocks beside top-k as a
             diagnostic. Flash attention
             at smollm-360m's prefill (4, 2048, 15 / 5 heads, 64) causal and
             gemma2-2b's (1, 8192, 8 / 4, 256) with window 4096 and softcap 50,
             in bf16 (the tensor-core kernel) within 2e-2 of the plain
             version and within BF16_UNITS_TOL rounding units of the f32
             attention (``attention.ref.rounding_units``: each element held
             to the scale its bf16 roundings can reach), a bf16 case on views
             into a fused qkv projection, gemma2's case with scores near the
             cap (q scaled by 25, rounding units only), and an f32 case (the
             SIMT kernel) within 2e-5 (the tolerances of tests/test_kernels.py;
             the sum order differs); SDPA's time beside the causal case. The selective scan at falcon-mamba-7b's
             (1, 2048, 8192, 16) and at its prefill batch (2, 2048, 8192, 16),
             x bf16, y f32, within 1e-4 of max|y| of the plain version.
             The flash forward with and without its LSE output at smollm's
             prefill shape and at its training batch of 2 (bit-identical
             outputs, both timed), and the flash
             backward against ``attention_bwd_ref`` at smollm-360m's
             training shape (2, 2048, 15 / 5, 64) causal in bf16 and f32 and
             gemma2-2b's (1, 8192, 8 / 4, 256) with window 4096 and softcap
             50 in bf16: each of dQ, dK and dV within BWD_F32_TOL (f32) or
             BWD_BF16_TOL (bf16) of its max |g|, two runs bit-identical;
             its time, its bound and the backward of SDPA (autograd,
             causal, GQA) beside it.
3. path    — the scenarios at full width through ``run_scenario``, with the
             launch counts set to 0 just before and read just after:
             paper_table3 (fp32), quantized_table3 (int8) and an int4
             variant, topk_sweep (3 rounds), mesh_smoke (tree all-reduce with
             churn, 180.9 M f32 a node) and an int8 variant. Every round must
             report numerics_ok (None for top-k, which has no deterministic
             bound), finite outputs and the exact bytes on the wire; every
             gossip kernel must have launched, and every shape a codec
             kernel launched with must have been timed in phase 2. Prints
             each gossip kernel's launches by shape and each codec kernel's
             loss, the sum over shapes of launches x (time - bound).
4. serve   — smollm-360m (32 layers, d 960) and falcon-mamba-7b (64 layers,
             d 4096) at full width and depth in bf16, params from Model.init
             on the card (seed 0), with the launch counts set to 0 just before
             and read just after: three prefill forwards over (4, 2048) and
             (2, 2048) tokens (the first a warm-up) and the serve loop at the
             reference CLI's defaults (batch 4, prompt 32, gen 16, cache 128).
             Every logit finite; flash_attention launched 32 and
             selective_scan 64 times per forward. Prints prefill ms and tok/s,
             decode ms/step and tok/s and peak memory, and the device time of
             one decode step replayed as a CUDA graph. Then, in f32 at full
             width and 4 layers, forward logits against teacher-forced decode
             logits over a 256-token prompt, within 5e-2 (the bound of
             tests/test_models.py).
5. train   — smollm-360m at full width and depth (32 layers, d 960, 15 / 5
             heads, vocab 49152, bf16 params, AdamW with fp32 masters), N = 4
             nodes stacked on the card, DataConfig(seq_len=2048,
             batch_per_node=2, n_nodes=4, seed=0), lr 1e-3, warmup 0, no
             remat; the launch counts set to 0 just before each run and read
             just after: tree_allreduce for 3 steps on one fixed batch (the
             first a warm-up; the third loss below the first; after every
             step each node's masters within the runner's mean tolerance of
             the nodes' FedAvg), dissemination with the int8 codec for 2
             steps, dissemination with top-k and error feedback for 2 steps
             (codec_ef must change). Every loss and grad norm finite; every
             step launches flash_attention and flash_attention_bwd 32 x N
             times; every gossip kernel launches in the codec runs. Prints
             each step's time by host clock, synchronized, split into the
             nodes' forward + backward, the optimizer and the gossip, with
             tokens/s, the losses and the peak memory. Then, in f32 at 4
             layers and full width, every leaf's training gradient through
             the kernels within 1e-3 of its max |g| of the gradient through
             the plain versions on the card.

Then the card's name and power limit, one JSON line with every kernel's
numbers (the codec kernels' also by shape, with their loss), and the result
line. Exits non-zero without a CUDA device, and when
run from a directory that holds nothing of the repository but this file.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM3 rate, the f32 rate outside the tensor cores and
# the dense bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
GOSSIP_KERNELS = ("quantize", "dequantize", "topk_select", "gossip_mix")
CODEC_KERNELS = ("quantize", "dequantize", "topk_select")
MODEL_KERNELS = ("flash_attention", "selective_scan")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    raise SystemExit(1)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def print_kernel_resources(build_dir: Path) -> None:
    """ptxas's registers and spills for the redesigned kernels (from the
    build log), and the HGMMA instructions in the flash object's SASS."""
    log = (build_dir / "nvcc.log").read_text().splitlines()
    kernels = ("flash_tc_kernel", "scan_kernel", "bwd_dq_mma_kernel", "bwd_dkdv_mma_kernel",
               "bwd_dq_kernel", "bwd_dkdv_kernel")
    for i, line in enumerate(log):
        if "Compiling entry function" in line and any(k in line for k in kernels):
            name = line.split("'")[1]
            kernel = next(k for k in kernels if k in name)
            args = name.split(kernel, 1)[1].split("EEv")[0]
            if kernel.startswith("bwd_") and not args.startswith(("ILi64E", "ILi256E13")):
                continue  # the backward as phase 2 runs it (hd 64; SIMT bf16 at hd 256)
            info = " | ".join(x.split(":", 1)[-1].strip() for x in log[i + 2:i + 4])
            print(f"[build] ptxas {kernel} {args}: {info}")
    objdump = Path("/usr/local/cuda/bin/cuobjdump")
    if not objdump.is_file():
        print("[build] SASS check: cuobjdump not in the toolkit, not run")
        return
    sass = subprocess.run([str(objdump), "--dump-sass", str(build_dir / "flash_attention.o")],
                          capture_output=True, text=True, timeout=120).stdout
    n_hgmma = sum("HGMMA" in line for line in sass.splitlines())
    print(f"[build] SASS check: {n_hgmma} HGMMA instructions in flash_attention.o (cuobjdump)")
    if n_hgmma == 0:
        fail("the bf16 flash kernel issues no HGMMA")


def count_elements(tree) -> int:
    if isinstance(tree, dict):
        return sum(count_elements(v) for v in tree.values())
    return tree.numel()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 1

    import torch.nn.functional as F

    from repro_torch.compress import per_send_wire_mb
    from repro_torch.configs import get_arch
    from repro_torch.kernels import (KERNEL_NAMES, _build, launch_counts, launch_shapes,
                                     reset_launches)
    from repro_torch.kernels.attention.flash import flash_attention, flash_attention_bwd
    from repro_torch.kernels.attention.ops import flash_attention_op
    from repro_torch.kernels.attention.ref import (BF16_UNITS_TOL, BWD_BF16_TOL, BWD_F32_TOL,
                                                   attention_bwd_ref, attention_lse_ref,
                                                   attention_ref, rounding_units)
    from repro_torch.kernels.codec import ref as codec_ref
    from repro_torch.kernels.codec.ops import dequantize_op, quantize_op, topk_select_op
    from repro_torch.kernels.mixing.ops import gossip_mix_op
    from repro_torch.kernels.mixing.ref import gossip_mix_ref
    from repro_torch.kernels.scan.ops import selective_scan_op
    from repro_torch.kernels.scan.ref import selective_scan_ref
    from repro_torch.data import DataConfig, FederatedData
    from repro_torch.dfl.trainer import DFLConfig, DFLTrainer
    from repro_torch.launch.serve import serve
    from repro_torch.models import Batch, build_model
    from repro_torch.models import attention as attn_model
    from repro_torch.optim.optimizers import tree_leaves
    from repro_torch.scenario import SCENARIOS, run_scenario

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = torch.cuda.get_device_name(0)
    smi = smi_line()

    # -- 1. build ---------------------------------------------------------------
    build_s = _build.build()
    _build.lib()
    print(f"[build] nvcc {build_s:.1f} s for {len(_build.sources())} sources "
          f"(sm_90a) -> {_build.build_dir().relative_to(ROOT)}")
    print_kernel_resources(_build.build_dir())
    print(f"[card] {smi}")

    # -- 2. kernels against their plain versions ------------------------------------
    flush = torch.empty(512 * 2 ** 20 // 4, dtype=torch.float32, device=dev)  # > 50 MB L2

    def median_ms(fn, iters, cold=True, clean=False):
        """cold: the L2 flushed before each launch, by writing (dirty lines
        stay, as a gossip step leaves them) or, with clean, by reading."""
        fn()
        torch.cuda.synchronize()
        spans = []
        for _ in range(iters):
            if clean:
                flush.sum()
            elif cold:
                flush.zero_()
            torch.cuda._sleep(2_000_000)  # the card stays busy while the host enqueues
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            spans.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in spans)

    gen = torch.Generator(device=dev).manual_seed(0)
    b0 = int(round(21.2e6 / 4))   # EfficientNet-B0 payload, f32 elements
    results = {}

    def record(name, route_src, replaces, err, tol, ms, plain_ms, n_bytes, n_ops,
               library_ms=None, shape="", ops_per_s=F32_OPS_PER_S, key=None, clean_ms=None):
        b_ms, b_by = bound_ms(n_bytes, n_ops, ops_per_s)
        if tol is not None and not err <= tol:  # None: the caller held it
            fail(f"{name}: max |kernel - plain| = {err} > {tol}")
        entry = results.setdefault(name, dict(
            name=name, route="cuda", source=route_src, replaces=replaces,
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms))
        if key is not None:  # one of the main path's launch shapes
            entry.setdefault("shapes", []).append(dict(
                shape=list(key), launches=0, ms=ms, bound_ms=b_ms, plain_ms=plain_ms,
                clean_l2_ms=clean_ms))
        lib = "" if library_ms is None else f" library {library_ms:.4f} ms"
        clean = "" if clean_ms is None else f" ({clean_ms:.4f} ms from a clean L2)"
        tol_s = "" if tol is None else f" (tol {tol})"
        print(f"[kernel] {name}{shape}: {ms:.4f} ms{clean} (bound {b_ms:.4f} ms by {b_by}), "
              f"plain {plain_ms:.4f} ms{lib}; max_abs_err {err}{tol_s} on {card}")

    # the codec kernels at every shape the main path (phase 3) gives them: a
    # dry run of its scenarios at the proxy size on the card yields each
    # launch's rows (the plan's senders in a step, whatever the payload), and
    # the scenario's payload its size
    base = SCENARIOS
    runs = [base["paper_table3"], base["quantized_table3"],
            base["quantized_table3"].replace(name="quantized_table3_int4", codec="int4"),
            base["topk_sweep"], base["mesh_smoke"],
            base["mesh_smoke"].replace(name="mesh_smoke_int8", codec="int8")]
    path_shapes = {name: Counter() for name in CODEC_KERNELS}
    for spec in runs:
        reset_launches()
        run_scenario(spec, device="cuda", seed=1, proxy_elems=4)
        elems = int(round(spec.payload_mb * 1e6 / 4))
        for name in CODEC_KERNELS:
            for key, n in launch_shapes()[name].items():
                path_shapes[name][(key[0], elems, *key[2:])] += n
    for name in CODEC_KERNELS:
        print(f"[kernel] {name}: the main path's launch shapes "
              f"{sorted(path_shapes[name].items())} (dry run at the proxy size)")

    def by_size(key):  # the single-row shapes first, int8 before int4
        return key[0], key[1], -key[2]

    for rows, size, bits in sorted(path_shapes["quantize"], key=by_size):
        x = torch.randn((rows, size), generator=gen, device=dev) * 3
        iters = 50 if x.numel() < 5e7 else 10
        codes, scales = quantize_op(x, bits=bits)
        pc, ps = codec_ref.quantize_rows(x, bits, 1024)
        if not (torch.equal(codes, pc) and torch.equal(scales, ps)):
            fail(f"quantize int{bits} ({rows}, {size}): codes/scales differ from the plain "
                 "version")
        c = scales.shape[1]
        q_bytes = 4 * x.numel() + codes.numel() + 4 * scales.numel()
        shape = f" int{bits} ({rows}, {c}x1024)"
        record("quantize", "src/repro_torch/csrc/quant_pack.cu",
               "src/repro/kernels/codec/quant_pack.py:19", 0.0, 0.0,
               median_ms(lambda: quantize_op(x, bits=bits), iters),
               median_ms(lambda: codec_ref.quantize_rows(x, bits, 1024), iters // 5),
               q_bytes, 5 * x.numel(), shape=shape, key=(rows, size, bits),
               clean_ms=median_ms(lambda: quantize_op(x, bits=bits), iters, clean=True))
        del pc, ps
        out = dequantize_op(codes, scales, size=size, bits=bits)
        plain = codec_ref.dequantize_rows(codes, scales, size, bits, 1024)
        if not torch.equal(out, plain):
            fail(f"dequantize int{bits} ({rows}, {size}): output differs from the plain version")
        del out, plain
        record("dequantize", "src/repro_torch/csrc/quant_pack.cu",
               "src/repro/kernels/codec/quant_pack.py:28", 0.0, 0.0,
               median_ms(lambda: dequantize_op(codes, scales, size=size, bits=bits), iters),
               median_ms(lambda: codec_ref.dequantize_rows(codes, scales, size, bits, 1024),
                         iters // 5),
               q_bytes, x.numel(), shape=shape, key=(rows, size, bits),
               clean_ms=median_ms(lambda: dequantize_op(codes, scales, size=size, bits=bits),
                                  iters, clean=True))
        del x, codes, scales

    for rows, size, block, k in sorted(path_shapes["topk_select"]):
        xt = torch.randn((rows, size), generator=gen, device=dev)
        vals, idx = topk_select_op(xt, k=k, block=block)
        pv, pi = codec_ref.topk_select_rows(xt, k, block)
        if not (torch.equal(vals, pv) and torch.equal(idx, pi)):
            fail(f"topk_select ({rows}, {size}): values/indices differ from the plain version")
        c = vals.shape[1]
        shape = f" ({rows}, {c}x{block}, k={k})"
        # torch.topk on the |x| blocks computes part of the function (no
        # signed values, no index order): printed, never the library column
        blocks = codec_ref.chunked(xt, block)
        part_ms = median_ms(lambda: torch.topk(blocks.abs(), k, dim=1), 20)
        print(f"[kernel] topk_select{shape}: torch.topk on the |x| blocks {part_ms:.4f} ms "
              f"(values only, unordered; a diagnostic) on {card}")
        record("topk_select", "src/repro_torch/csrc/topk_pack.cu",
               "src/repro/kernels/codec/topk_pack.py:28", 0.0, 0.0,
               median_ms(lambda: topk_select_op(xt, k=k, block=block), 50),
               median_ms(lambda: codec_ref.topk_select_rows(xt, k, block), 10),
               4 * xt.numel() + 8 * vals.numel(), k * c * rows * block,
               shape=shape, key=(rows, size, block, k),
               clean_ms=median_ms(lambda: topk_select_op(xt, k=k, block=block), 50, clean=True))
        del xt, vals, idx, pv, pi, blocks

    buf = torch.randn((10, 10, b0), generator=gen, device=dev)
    w = torch.full((10,), 0.1, device=dev)
    mixed = gossip_mix_op(buf, w)
    plain = gossip_mix_ref(buf, w)
    err = float((mixed - plain).abs().max())
    record("gossip_mix", "src/repro_torch/csrc/gossip_mix.cu",
           "src/repro/kernels/mixing/gossip_mix.py:22", err,
           1e-6 * float(buf.abs().max()),
           median_ms(lambda: gossip_mix_op(buf, w), 10, cold=False),
           median_ms(lambda: gossip_mix_ref(buf, w), 5, cold=False),
           4 * buf.numel() + 4 * mixed.numel(), 2 * buf.numel(),
           library_ms=median_ms(lambda: torch.mean(buf, dim=1), 10, cold=False),
           shape=" (10, 10, 5.3 M)")
    del buf, mixed, plain

    # flash attention: smollm-360m's causal prefill, gemma2-2b's local layer,
    # and an f32 case
    def visible_pairs(s, window):
        return sum(min(q + 1, window) if window else q + 1 for q in range(s))

    flash_cases = [  # b, s, h, kv, hd, window, softcap, dtype, tol, how
        (4, 2048, 15, 5, 64, 0, 0.0, torch.bfloat16, 2e-2, "timed"),
        (1, 8192, 8, 4, 256, 4096, 50.0, torch.bfloat16, 2e-2, "timed"),
        (2, 1024, 6, 2, 64, 0, 0.0, torch.float32, 2e-5, "checked"),
        (2, 2048, 15, 5, 64, 0, 0.0, torch.bfloat16, 2e-2, "fused views"),
        (1, 8192, 8, 4, 256, 4096, 50.0, torch.bfloat16, None, "near the cap"),
    ]
    for b, s, h, kv, hd, window, cap, dtype, tol, how in flash_cases:
        if how == "fused views":  # into one (b, s, H + 2 KV, hd) projection
            qkv = torch.randn((b, s, h + 2 * kv, hd), generator=gen, device=dev).to(dtype)
            q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv], qkv[:, :, h + kv:]
        else:
            # near the cap, q x 25 makes the scores' std half the cap of 50
            q_scale = 25.0 if how == "near the cap" else 1.0
            q = (q_scale * torch.randn((b, s, h, hd), generator=gen, device=dev)).to(dtype)
            k = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dtype)
            v = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dtype)
        kw = dict(causal=True, sliding_window=window, softcap=cap)
        out = flash_attention_op(q, k, v, **kw)
        plain = attention_ref(q, k, v, **kw)
        err = float((out.float() - plain.float()).abs().max())
        shape = f" ({b}, {s}, {h}/{kv}, {hd}) {str(dtype)[6:]} window {window} softcap {cap}"
        if how != "timed":
            shape += f" {how}" if how != "checked" else ""
        units = ""
        if dtype == torch.bfloat16:
            n_units = rounding_units(out, q, k, v, **kw)
            if not n_units <= BF16_UNITS_TOL:
                fail(f"flash_attention{shape}: {n_units} rounding units of the f32 attention "
                     f"> {BF16_UNITS_TOL}")
            units = f", {n_units:.3f} rounding units (tol {BF16_UNITS_TOL})"
        if how != "timed":
            if tol is not None and not err <= tol:
                fail(f"flash_attention{shape}: max |kernel - plain| = {err} > {tol}")
            abs_tol = "" if tol is None else f" (tol {tol})"
            print(f"[kernel] flash_attention{shape}: max_abs_err {err}{abs_tol}{units} on {card}")
            continue
        lib_ms = None
        if window == 0 and cap == 0.0:
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            lib_ms = median_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 10)
        n_bytes = (q.numel() + k.numel() + v.numel() + out.numel()) * q.element_size()
        record("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
               "src/repro/kernels/attention/flash.py:25", err, tol,
               median_ms(lambda: flash_attention_op(q, k, v, **kw), 5),
               median_ms(lambda: attention_ref(q, k, v, **kw), 3),
               n_bytes, 4 * hd * b * h * visible_pairs(s, window), library_ms=lib_ms,
               shape=shape + units, ops_per_s=BF16_OPS_PER_S)
    del q, k, v, out, plain

    # the forward's LSE output: bit-identical outputs with and without it, at
    # smollm-360m's prefill batch and at its training batch of 2
    for b in (4, 2):
        q = torch.randn((b, 2048, 15, 64), generator=gen, device=dev).bfloat16()
        k = torch.randn((b, 2048, 5, 64), generator=gen, device=dev).bfloat16()
        v = torch.randn((b, 2048, 5, 64), generator=gen, device=dev).bfloat16()
        out = flash_attention(q, k, v, causal=True)
        out_lse, lse = flash_attention(q, k, v, causal=True, return_lse=True)
        if not torch.equal(out, out_lse):
            fail("flash_attention: the output with an LSE differs from the output without one")
        _, want_lse = attention_lse_ref(q, k, v, causal=True)
        lse_err = float((lse - want_lse).abs().max())
        if not lse_err <= 1e-4 * float(want_lse.abs().max()):
            fail(f"flash_attention: LSE off the plain version's by {lse_err}")
        no_lse_ms = median_ms(lambda: flash_attention(q, k, v, causal=True), 10)
        lse_ms = median_ms(lambda: flash_attention(q, k, v, causal=True, return_lse=True), 10)
        b_ms, _ = bound_ms(0, 4 * 64 * b * 15 * visible_pairs(2048, 0), BF16_OPS_PER_S)
        print(f"[kernel] flash_attention ({b}, 2048, 15/5, 64) bf16 causal: {no_lse_ms:.4f} ms "
              f"without the LSE, {lse_ms:.4f} ms with it (bound {b_ms:.4f} ms; outputs "
              f"bit-identical; LSE max abs err {lse_err:.3e}) on {card}")
        del q, k, v, out, out_lse, lse, want_lse

    # the flash backward at smollm-360m's training shape (bf16, f32) and at
    # gemma2-2b's local layer, against attention_bwd_ref
    bwd_cases = [  # b, s, h, kv, hd, window, softcap, dtype
        (2, 2048, 15, 5, 64, 0, 0.0, torch.bfloat16),
        (2, 2048, 15, 5, 64, 0, 0.0, torch.float32),
        (1, 8192, 8, 4, 256, 4096, 50.0, torch.bfloat16),
    ]
    for b, s, h, kv, hd, window, cap, dtype in bwd_cases:
        q = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
        k = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dtype)
        v = torch.randn((b, s, kv, hd), generator=gen, device=dev).to(dtype)
        do = torch.randn((b, s, h, hd), generator=gen, device=dev).to(dtype)
        kw = dict(causal=True, sliding_window=window, softcap=cap)
        out, lse = flash_attention(q, k, v, return_lse=True, **kw)
        got = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        again = flash_attention_bwd(q, k, v, out, lse, do, **kw)
        want = attention_bwd_ref(q, k, v, out, lse, do, **kw)
        tol = BWD_F32_TOL if dtype == torch.float32 else BWD_BF16_TOL
        shape = f" ({b}, {s}, {h}/{kv}, {hd}) {str(dtype)[6:]} window {window} softcap {cap}"
        errs = []
        for name, g1, g2, w in zip(("dq", "dk", "dv"), got, again, want):
            if not torch.equal(g1, g2):
                fail(f"flash_attention_bwd{shape}: two runs give different {name}")
            err, scale = float((g1.float() - w.float()).abs().max()), float(w.float().abs().max())
            if not err <= tol * scale:
                fail(f"flash_attention_bwd{shape}: {name} max |kernel - plain| = {err} > "
                     f"{tol} x max|{name}| = {tol * scale}")
            errs.append(f"{name} {err:.3e} ({err / scale:.2e} of max|g|)")
        print(f"[kernel] flash_attention_bwd{shape}: {', '.join(errs)} (tol {tol} of max|g|), "
              f"two runs bit-identical on {card}")
        lib_ms = None
        if window == 0 and cap == 0.0:
            qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
            sd = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
            dot = do.transpose(1, 2)
            lib_ms = median_ms(lambda: torch.autograd.grad(sd, (qt, kt, vt), dot,
                                                           retain_graph=True), 5)
            del qt, kt, vt, sd, dot
        n_bytes = sum(t.numel() * t.element_size() for t in (q, k, v, out, lse, do, *got))
        record("flash_attention_bwd", "src/repro_torch/csrc/flash_attention_bwd.cu",
               # no TPU kernel: XLA differentiates the JAX package's einsum attention
               "src/repro/models/attention.py:48",
               max(float((g1.float() - w.float()).abs().max()) for g1, w in zip(got, want)),
               None,
               median_ms(lambda: flash_attention_bwd(q, k, v, out, lse, do, **kw), 5),
               median_ms(lambda: attention_bwd_ref(q, k, v, out, lse, do, **kw), 3),
               n_bytes, 10 * hd * b * h * visible_pairs(s, window), library_ms=lib_ms,
               shape=shape, ops_per_s=BF16_OPS_PER_S if dtype == torch.bfloat16
               else F32_OPS_PER_S)
        del q, k, v, do, out, lse, got, again, want
    torch.cuda.empty_cache()

    # the selective scan at falcon-mamba-7b's width, as the Mamba1 block calls
    # it: one sequence and the prefill's batch of two
    for b in (1, 2):
        s, di, n = 2048, 8192, 16
        dt = F.softplus(torch.randn((b, s, di), generator=gen, device=dev))
        Bm = torch.randn((b, s, n), generator=gen, device=dev)
        Cm = torch.randn((b, s, n), generator=gen, device=dev)
        xs = torch.randn((b, s, di), generator=gen, device=dev).to(torch.bfloat16)
        A_log = torch.log(torch.randn((di, n), generator=gen, device=dev).abs() + 0.5)
        Dp = torch.randn((di,), generator=gen, device=dev)
        scan_args = (dt, Bm, Cm, xs, A_log, Dp)
        y, h = selective_scan_op(*scan_args, out_dtype=torch.float32)
        py, ph = selective_scan_ref(*scan_args, out_dtype=torch.float32)
        err = max(float((y - py).abs().max()), float((h - ph).abs().max()))
        n_bytes = (4 + 2 + 4) * b * s * di + 2 * 4 * b * s * n + 4 * (di * n + di + b * di * n)
        record("selective_scan", "src/repro_torch/csrc/selective_scan.cu",
               "src/repro/kernels/scan/mamba_scan.py:24", err,
               1e-4 * max(1.0, float(py.abs().max())),
               median_ms(lambda: selective_scan_op(*scan_args, out_dtype=torch.float32), 10),
               median_ms(lambda: selective_scan_ref(*scan_args, out_dtype=torch.float32), 2),
               n_bytes, 8 * b * s * di * n + 2 * b * s * di,
               shape=f" ({b}, {s}, {di}, {n}) x bf16, y f32")
        del dt, Bm, Cm, xs, A_log, Dp, y, h, py, ph, scan_args
    del flush

    # -- 3. the main path: scenario rounds at full width ------------------------
    reset_launches()
    for spec in runs:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        run = run_scenario(spec, device="cuda", seed=1)
        wall = time.perf_counter() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        c = spec.codec_obj()
        for r in run.rounds:
            want_wire = r.transmissions * per_send_wire_mb(c, spec.payload_mb)
            if r.bytes_on_wire_mb != want_wire:
                fail(f"{spec.name} round {r.round}: bytes_on_wire_mb "
                     f"{r.bytes_on_wire_mb} != {want_wire}")
            want_ok = None if spec.codec == "topk" else True
            if r.numerics_ok is not want_ok or not r.finite:
                fail(f"{spec.name} round {r.round}: numerics_ok={r.numerics_ok} "
                     f"finite={r.finite}")
            print(f"[path] {spec.name} round {r.round}: {run.elems_per_node} f32/node x "
                  f"{len(r.members)} live of {spec.n}, {r.n_slots} slots, "
                  f"{r.transmissions} tx, bytes_on_wire_mb {r.bytes_on_wire_mb}, "
                  f"numerics_ok {r.numerics_ok}, round {r.device_ms:.3f} ms on {card}")
        print(f"[path] {spec.name}: {wall:.2f} s wall for {len(run.rounds)} round(s), "
              f"peak {peak_gb:.2f} GB")
        if spec.name == "quantized_table3" and run.rounds[0].bytes_on_wire_mb != 478.86336:
            fail("quantized_table3 bytes_on_wire_mb != 478.86336")
    counts, shapes = launch_counts(), launch_shapes()
    print(f"[path] launches: {json.dumps(counts)}")
    missing = [k for k in GOSSIP_KERNELS if counts[k] <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    for name in GOSSIP_KERNELS:
        results[name]["launches"] = counts[name]
        hist = ", ".join(f"{key} x {n}" for key, n in
                         sorted(shapes[name].items(), key=lambda kv: -kv[1]))
        print(f"[path] {name} launches by shape: {hist}")
    # each codec kernel's loss: launches x (time - bound), summed over shapes
    for name in CODEC_KERNELS:
        timed = {tuple(row["shape"]): row for row in results[name]["shapes"]}
        untimed = sorted(set(shapes[name]) - set(timed))
        if untimed:
            fail(f"{name}: shapes launched on the main path but not timed: {untimed}")
        for key, row in timed.items():
            row["launches"] = shapes[name].get(key, 0)
            row["loss_ms"] = row["launches"] * (row["ms"] - row["bound_ms"])
            print(f"[path] {name} {key}: {row['launches']} launches x ({row['ms']:.4f} - "
                  f"{row['bound_ms']:.4f} ms) = {row['loss_ms']:.4f} ms")
        loss = sum(r["loss_ms"] for r in timed.values())
        results[name]["loss_ms"] = loss
        print(f"[path] {name}: loss sum over shapes of launches x (ms - bound_ms) = "
              f"{loss:.4f} ms on {card}")
    torch.cuda.empty_cache()

    # -- 4. the serving path at full width and depth ------------------------------
    serve_runs = [("smollm-360m", 4, "flash_attention"), ("falcon-mamba-7b", 2, "selective_scan")]
    seq, n_prefill = 2048, 3
    reset_launches()
    forwards = {}
    for arch, batch, _ in serve_runs:
        cfg = get_arch(arch)
        model = build_model(cfg, device="cuda")
        g = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        params = model.init(g)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_params = count_elements(params)
        tokens = torch.randint(0, cfg.vocab, (batch, seq), generator=g, device=dev)
        torch.cuda.reset_peak_memory_stats()
        spans = []
        with torch.inference_mode():
            for _ in range(n_prefill):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, _ = model.forward(params, Batch(tokens=tokens))
                torch.cuda.synchronize()
                spans.append(time.perf_counter() - t0)
                if not bool(torch.isfinite(logits[..., :cfg.vocab]).all()):
                    fail(f"{arch}: non-finite prefill logits")
                del logits
        forwards[arch] = n_prefill
        prefill_peak = torch.cuda.max_memory_allocated() / 1e9
        prefill_ms = statistics.median(spans[1:]) * 1e3
        print(f"[serve] {arch}: {cfg.n_layers} layers, d {cfg.d_model}, {n_params / 1e9:.3f} B "
              f"params bf16 (init {init_s:.1f} s); prefill ({batch}, {seq}): "
              f"{prefill_ms:.3f} ms median of {n_prefill - 1} after a warm-up "
              f"[{', '.join(f'{1e3 * t:.3f}' for t in spans)}], "
              f"{batch * seq / prefill_ms * 1e3:.0f} tok/s, peak {prefill_peak:.2f} GB on {card}")
        torch.cuda.reset_peak_memory_stats()
        prompts = torch.randint(0, cfg.vocab, (4, 32), generator=g, device=dev)
        res = serve(model, params, prompts, gen=16, cache_len=128)
        if not bool(torch.isfinite(res.logits[..., :cfg.vocab]).all()):
            fail(f"{arch}: non-finite decode logits")
        if not bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all()):
            fail(f"{arch}: generated ids outside the vocab")
        step_ms = 1e3 * res.seconds / res.steps
        print(f"[serve] {arch}: serve loop batch 4, prompt 32, gen 16, cache 128: "
              f"{res.steps} decode steps in {res.seconds:.3f} s, {step_ms:.3f} ms/step, "
              f"{4 * res.steps / res.seconds:.1f} tok/s, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on {card}")
        # the device's own time for a decode step: the same step captured in a
        # CUDA graph replays without the host's launch gaps
        cache = model.init_cache(4, 128)
        tok, pos = prompts[:, :1].clone(), torch.zeros(4, dtype=torch.long, device=dev)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.inference_mode(), torch.cuda.stream(side):
            for _ in range(2):
                model.decode_step(params, tok, pos, cache)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.inference_mode(), torch.cuda.graph(graph):
            model.decode_step(params, tok, pos, cache)
        graph_ms = median_ms(graph.replay, 20, cold=False)
        print(f"[serve] {arch}: one decode step replayed as a CUDA graph: {graph_ms:.3f} ms "
              f"on the device against {step_ms:.3f} ms eager (device idle ~"
              f"{100 * (1 - graph_ms / step_ms):.1f}% of an eager step) on {card}")
        del params, res, model, graph, cache
        torch.cuda.empty_cache()
    counts = launch_counts()
    print(f"[serve] launches: {json.dumps(counts)}")
    for arch, _, kernel in serve_runs:
        want = get_arch(arch).n_layers * forwards[arch]
        if counts[kernel] != want:
            fail(f"{kernel}: {counts[kernel]} launches on the serving path, expected {want}")
        results[kernel]["launches"] = counts[kernel]

    # forward (kernels) against teacher-forced decode (cache path) in f32
    for arch, _, _ in serve_runs:
        cfg = get_arch(arch).replace(n_layers=4, dtype="float32")
        model = build_model(cfg, device="cuda")
        g = torch.Generator(device=dev).manual_seed(1)
        params = model.init(g)
        tokens = torch.randint(0, cfg.vocab, (2, 256), generator=g, device=dev)
        with torch.inference_mode():
            full, _ = model.forward(params, Batch(tokens=tokens))
            cache = model.init_cache(2, 256)
            err = 0.0
            for t in range(256):
                pos = torch.full((2,), t, dtype=torch.long, device=dev)
                step, cache = model.decode_step(params, tokens[:, t:t + 1], pos, cache)
                err = max(err, float((step[:, 0, :cfg.vocab] - full[:, t, :cfg.vocab])
                                     .abs().max()))
        if not err < 5e-2:
            fail(f"{arch}: f32 forward vs teacher-forced decode max |err| {err} >= 5e-2")
        print(f"[serve] {arch} f32, 4 layers, full width: forward vs teacher-forced decode "
              f"over 256 tokens, max abs logit err {err:.3e} (bound 5e-2) on {card}")
        del params, full, cache, model
        torch.cuda.empty_cache()

    # -- 5. the training path: smollm-360m, 4 stacked nodes -------------------------
    cfg = get_arch("smollm-360m").replace(remat=False)
    n_nodes, bpn, seq = 4, 2, 2048
    model = build_model(cfg, device="cuda")
    data = FederatedData(DataConfig(vocab=cfg.vocab, seq_len=seq, batch_per_node=bpn,
                                    n_nodes=n_nodes, seed=0))
    tok, lab = data.global_batch()
    batch = Batch(tokens=torch.from_numpy(tok).long().to(dev),
                  labels=torch.from_numpy(lab).long().to(dev))
    params0 = model.init(torch.Generator(device=dev).manual_seed(0))
    per_step = cfg.n_layers * n_nodes
    train_runs = [("tree_allreduce", "", 3), ("dissemination", "int8", 2),
                  ("dissemination", "topk", 2)]
    train_launches = Counter()
    for mode, codec, steps in train_runs:
        trainer = DFLTrainer(model, n_nodes, DFLConfig(gossip_mode=mode, codec=codec, lr=1e-3,
                                                       warmup=0), device="cuda", timed=True)
        state = trainer.state_from_params(params0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = f"{mode}{'+' + codec if codec else ''}"
        losses = []
        reset_launches()
        for i in range(steps):
            before = launch_counts()
            t0 = time.perf_counter()
            state, m = trainer.train_step(state, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            after = launch_counts()
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            losses.append(loss)
            if not (math.isfinite(loss) and math.isfinite(gnorm)):
                fail(f"train {run} step {i}: loss {loss}, grad_norm {gnorm}")
            for kernel in ("flash_attention", "flash_attention_bwd"):
                n = after[kernel] - before[kernel]
                if n != per_step:
                    fail(f"train {run} step {i}: {kernel} launched {n} times, expected "
                         f"{per_step} (32 layers x {n_nodes} nodes)")
            if mode == "tree_allreduce":  # every node holds the FedAvg of the masters
                worst = 0.0
                for leaf in tree_leaves(state.opt_state["master"]):
                    mean = leaf.double().mean(dim=0)
                    ok = all(torch.allclose(leaf[j].double(), mean, rtol=1e-5, atol=1e-5)
                             for j in range(n_nodes))
                    worst = max(worst, float((leaf.double() - mean).abs().max()))
                    if not ok:
                        fail(f"train {run} step {i}: a node's masters are off the FedAvg")
                fedavg = f", masters within {worst:.2e} of the FedAvg"
            else:
                fedavg = ""
            t = m["times"]
            print(f"[train] {run} step {i}: loss {loss:.4f}, grad_norm {gnorm:.4f}, "
                  f"{wall * 1e3:.1f} ms (nodes' fwd+bwd {t['fwd_bwd'] * 1e3:.1f}, optimizer "
                  f"{t['optimizer'] * 1e3:.1f}, gossip {t['gossip'] * 1e3:.1f}), "
                  f"{n_nodes * bpn * seq / wall:.0f} tok/s{fedavg} on {card}")
        counts = launch_counts()
        train_launches.update(counts)
        print(f"[train] {run}: losses {[round(x, 4) for x in losses]}, peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches {json.dumps(counts)}")
        want = {"": (), "int8": ("quantize", "dequantize", "gossip_mix"),
                "topk": ("topk_select", "gossip_mix")}[codec]
        missing = [k for k in want if counts[k] <= 0]
        if missing:
            fail(f"train {run}: gossip kernels never launched: {missing}")
        if mode == "tree_allreduce" and not losses[2] < losses[0]:
            fail(f"train {run}: the third loss {losses[2]} is not below the first {losses[0]}")
        if codec == "topk" and not any(float(x.abs().max()) > 0
                                       for x in tree_leaves(state.opt_state["codec_ef"])):
            fail(f"train {run}: codec_ef never changed")
        del trainer, state, m
        torch.cuda.empty_cache()
    for kernel in ("flash_attention", "flash_attention_bwd"):
        results[kernel]["launches"] += train_launches[kernel]
    del params0, model, batch

    # gradients through the kernels against the plain versions on the card
    cfg = get_arch("smollm-360m").replace(n_layers=4, dtype="float32", remat=False)
    model = build_model(cfg, device="cuda")
    params = model.init(torch.Generator(device=dev).manual_seed(2))
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_(True)
    tok, lab = data.global_batch()
    b2 = Batch(tokens=torch.from_numpy(tok[:bpn]).long().to(dev),
               labels=torch.from_numpy(lab[:bpn]).long().to(dev))
    got = torch.autograd.grad(model.train_loss(params, b2), leaves)
    attn_model.flash_attention_op = attention_ref  # the plain route, autograd's own backward
    try:
        want = torch.autograd.grad(model.train_loss(params, b2), leaves)
    finally:
        attn_model.flash_attention_op = flash_attention_op
    worst = 0.0
    for g1, g2 in zip(got, want):
        rel = float((g1 - g2).abs().max()) / max(float(g2.abs().max()), 1e-30)
        worst = max(worst, rel)
        if not rel <= 1e-3:
            fail(f"train gradients: a leaf through the kernels is {rel:.2e} of its max|g| off "
                 "the plain versions' (bound 1e-3)")
    print(f"[train] f32, 4 layers, full width, (2, 2048) tokens: every leaf's gradient "
          f"through the kernels within {worst:.3e} of its max|g| of the plain versions' "
          f"(bound 1e-3) on {card}")
    del params, leaves, got, want, model
    torch.cuda.empty_cache()

    print(smi)
    print(json.dumps({"kernels": [results[k] for k in KERNEL_NAMES]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

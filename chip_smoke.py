#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's MOSGU gossip round on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each fatal on failure (exit code 1, no result line):

1. build   — nvcc compiles ``src/repro_torch/csrc/*.cu`` for sm_90a; prints
             the build time and the card's name and power limit.
2. kernels — each Hopper kernel at the main path's shapes against its plain
             PyTorch version on the same inputs: quantize / dequantize
             (int8, int4) on one EfficientNet-B0 payload (5.3 M f32), top-k
             on one MobileNetV2 payload (3.5 M f32, k = 13), the FedAvg mix
             at (10, 10, 5.3 M). Quantize, dequantize and top-k must be
             bit-identical; the mix within rtol 1e-6 of max|x|. Prints each
             kernel's median time (CUDA events, L2 flushed before every
             launch), its bound and the plain version's time.
3. path    — the scenarios at full width through ``run_scenario``, with the
             launch counts set to 0 just before and read just after:
             paper_table3 (fp32), quantized_table3 (int8) and an int4
             variant, topk_sweep (3 rounds), mesh_smoke (tree all-reduce with
             churn, 180.9 M f32 a node) and an int8 variant. Every round must
             report numerics_ok (None for top-k, which has no deterministic
             bound), finite outputs and the exact bytes on the wire; every
             kernel must have launched.

Then one JSON line with every kernel's numbers, the card's name and power
limit, and the result line. Exits non-zero without a CUDA device, and when
run from a directory that holds nothing of the repository but this file.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM data sheet: HBM3 rate and the f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one card",
              file=sys.stderr)
        return 1

    from repro_torch.compress import make_codec, per_send_wire_mb
    from repro_torch.kernels import KERNEL_NAMES, _build, launch_counts, reset_launches
    from repro_torch.kernels.codec import ref as codec_ref
    from repro_torch.kernels.codec.ops import dequantize_op, quantize_op, topk_select_op
    from repro_torch.kernels.mixing.ops import gossip_mix_op
    from repro_torch.kernels.mixing.ref import gossip_mix_ref
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
    print(f"[card] {smi}")

    # -- 2. kernels against their plain versions ------------------------------------
    flush = torch.empty(512 * 2 ** 20 // 4, dtype=torch.float32, device=dev)  # > 50 MB L2

    def median_ms(fn, iters, cold=True):
        fn()
        torch.cuda.synchronize()
        spans = []
        for _ in range(iters):
            if cold:
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
    v2 = int(round(14.0e6 / 4))   # MobileNetV2 payload
    results = {}

    def record(name, route_src, replaces, err, tol, ms, plain_ms, n_bytes, n_ops,
               library_ms=None, shape=""):
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        if not err <= tol:
            fail(f"{name}: max |kernel - plain| = {err} > {tol}")
        results.setdefault(name, dict(
            name=name, route="cuda", source=route_src, replaces=replaces,
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=library_ms))
        lib = "" if library_ms is None else f" library {library_ms:.4f} ms"
        print(f"[kernel] {name}{shape}: {ms:.4f} ms (bound {b_ms:.4f} ms by {b_by}), "
              f"plain {plain_ms:.4f} ms{lib}; max_abs_err {err} (tol {tol}) on {card}")

    x = torch.randn((1, b0), generator=gen, device=dev) * 3
    for bits in (8, 4):
        codes, scales = quantize_op(x, bits=bits)
        pc, ps = codec_ref.quantize_rows(x, bits, 1024)
        if not (torch.equal(codes, pc) and torch.equal(scales, ps)):
            fail(f"quantize int{bits}: codes/scales differ from the plain version")
        c = scales.shape[1]
        q_bytes = 4 * b0 + codes.numel() + 4 * c
        record("quantize", "src/repro_torch/csrc/quant_pack.cu",
               "src/repro/kernels/codec/quant_pack.py:19", 0.0, 0.0,
               median_ms(lambda: quantize_op(x, bits=bits), 50),
               median_ms(lambda: codec_ref.quantize_rows(x, bits, 1024), 20),
               q_bytes, 5 * b0, shape=f" int{bits} (1, {c}x1024)")
        out = dequantize_op(codes, scales, size=b0, bits=bits)
        plain = codec_ref.dequantize_rows(codes, scales, b0, bits, 1024)
        if not torch.equal(out, plain):
            fail(f"dequantize int{bits}: output differs from the plain version")
        record("dequantize", "src/repro_torch/csrc/quant_pack.cu",
               "src/repro/kernels/codec/quant_pack.py:28", 0.0, 0.0,
               median_ms(lambda: dequantize_op(codes, scales, size=b0, bits=bits), 50),
               median_ms(lambda: codec_ref.dequantize_rows(codes, scales, b0, bits, 1024), 20),
               q_bytes, b0, shape=f" int{bits} (1, {c}x1024)")

    xt = torch.randn((1, v2), generator=gen, device=dev)
    codec = make_codec("topk")
    vals, idx = topk_select_op(xt, k=codec.k, block=codec.block)
    pv, pi = codec_ref.topk_select_rows(xt, codec.k, codec.block)
    if not (torch.equal(vals, pv) and torch.equal(idx, pi)):
        fail("topk_select: values/indices differ from the plain version")
    c = vals.shape[1]
    record("topk_select", "src/repro_torch/csrc/topk_pack.cu",
           "src/repro/kernels/codec/topk_pack.py:28", 0.0, 0.0,
           median_ms(lambda: topk_select_op(xt, k=codec.k, block=codec.block), 50),
           median_ms(lambda: codec_ref.topk_select_rows(xt, codec.k, codec.block), 10),
           4 * v2 + 8 * codec.k * c, codec.k * c * codec.block,
           shape=f" ({c}x{codec.block}, k={codec.k})")
    del x, xt, codes, scales, out, plain, vals, idx, pv, pi

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
    del buf, mixed, plain, flush  # freed to PyTorch's cache, which phase 3 reuses

    # -- 3. the main path: scenario rounds at full width ------------------------
    base = SCENARIOS
    runs = [base["paper_table3"], base["quantized_table3"],
            base["quantized_table3"].replace(name="quantized_table3_int4", codec="int4"),
            base["topk_sweep"], base["mesh_smoke"],
            base["mesh_smoke"].replace(name="mesh_smoke_int8", codec="int8")]
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
    counts = launch_counts()
    print(f"[path] launches: {json.dumps(counts)}")
    missing = [k for k in KERNEL_NAMES if counts[k] <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    for name in KERNEL_NAMES:
        results[name]["launches"] = counts[name]

    print(smi)
    print(json.dumps({"kernels": [results[k] for k in KERNEL_NAMES]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Edited copies of the model kernels beside the shipped ones, on the card:
planted faults (does the check catch them?) and design variants (what does
a choice cost?).

    PYTHONPATH=src python -m repro_torch.kernels.variants [--source NAME=FILE ...]

Each variant is a shipped ``csrc`` file with textual edits (each edit must
match exactly once, or the run fails). All variants build at once, one nvcc
each with the shipped flags, into their own libraries under
``build/repro_torch/variants/``, and are called through the same C entry
point as the shipped kernel. ``--source NAME=FILE`` adds a whole file as one
more variant of the shipped file of the same name (an earlier revision, say).

Prints ptxas's registers and spills for each variant's kernels, then for
each case the shipped kernel first and last (so drift shows) and every
variant between: the median time (CUDA events, L2 flushed before each
launch) and the error against the plain version. Flash attention reads its
largest absolute error against ``attention_ref`` (bf16) and its rounding
units against the f32 attention (``ref.rounding_units``, held to
``BF16_UNITS_TOL``); the scan its largest error over max|y|. Needs one card.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Sequence, Tuple

from . import _build

VARIANT_ROOT = _build.BUILD_ROOT / "variants"


@dataclass(frozen=True)
class Variant:
    name: str
    source: str                           # the csrc file it edits
    edits: Tuple[Tuple[str, str], ...] = ()
    text: str = ""                        # a whole file instead of edits


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
            (("static constexpr int BK = HD == 64 || HD == 256 ? 64 : 128;",
              "static constexpr int BK = HD == 256 ? 64 : 128;"),)),
    Variant("scan: two states a group", "selective_scan.cu",
            (("constexpr int kGroup = 4;", "constexpr int kGroup = 2;"),)),
    Variant("scan: 4 channels x 8 segments a warp", "selective_scan.cu",
            (("constexpr int kCh = 8;", "constexpr int kCh = 4;"),
             ("constexpr int kSegs = 4;", "constexpr int kSegs = 8;"))),
)

KERNELS = {"flash_attention.cu": "flash_tc_kernel", "selective_scan.cu": "scan_kernel"}


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
        cmd = [nvcc, *_build.ARCH_FLAGS, *_build.COMPILE_FLAGS, "-shared", "-o", str(lib),
               str(src)]
        procs.append((v, lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                               stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for v, lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {v.name}:\n{log[-4000:]}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and KERNELS[v.source] in line:
                name = line.split("'")[1].split(KERNELS[v.source], 1)[1].split("EEv")[0]
                info = " | ".join(x.split(":", 1)[-1].strip() for x in lines[i + 2:i + 4])
                print(f"[ptxas] {v.name}: {KERNELS[v.source]} {name}: {info}")
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
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    from .attention.ref import BF16_UNITS_TOL, attention_ref, rounding_units
    from .scan.ref import selective_scan_ref

    if not torch.cuda.is_available():
        print("variants: needs a CUDA device", file=sys.stderr)
        return 1
    variants = list(VARIANTS)
    for spec in args.source:
        name, _, path = spec.partition("=")
        file = Path(path)
        if file.name not in KERNELS:
            raise SystemExit(f"--source {spec}: the file must be one of {list(KERNELS)}")
        variants.append(Variant(name, file.name, text=file.read_text()))
    libs = build_all(variants)
    _build.lib()
    shipped = _build.build_dir() / _build.LIB_NAME
    dev = torch.device("cuda")
    flush = torch.empty(128 * 2 ** 20, device=dev)  # 512 MB, above the 50 MB L2

    def median_ms(fn: Callable[[], int], iters: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        spans = []
        for _ in range(iters):
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
    for b, s, h, kv, hd, window, cap, q_scale in flash_cases:
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
        for name, path in runs("flash_attention.cu"):
            fn = entry(path, "rt_flash_attention_bf16")
            out = torch.empty_like(q)

            def call(fn=fn, out=out):
                return fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                          b, s, s, h, kv, hd, *q.stride()[:3], *k.stride()[:3],
                          *v.stride()[:3], 1, window, cap, torch.cuda.current_stream().cuda_stream)

            status = call()
            torch.cuda.synchronize()
            if status != 0:
                raise RuntimeError(f"{name}: launch returned CUDA error {status}")
            err = float((out.float() - plain).abs().max())
            units = rounding_units(out, q, k, v, **kw)
            verdict = "passes" if err <= 2e-2 and units <= BF16_UNITS_TOL else "FAILS"
            print(f"[flash] {case}: {name}: {median_ms(call):.4f} ms, max abs err {err:.5f} "
                  f"(tol 2e-2), {units:.2f} rounding units (tol {BF16_UNITS_TOL}): {verdict}")
        del q, k, v, plain

    for b in (1, 2):
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
                          A_log.data_ptr(), Dp.data_ptr(), y.data_ptr(), hl.data_ptr(),
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

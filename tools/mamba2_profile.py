#!/usr/bin/env python3
"""Where one zamba2-7b Mamba2 block's time goes in the port, on one CUDA card.

    python3 tools/mamba2_profile.py

One block at full width (d 3584, 112 heads of 64, state 64, bf16 params
from a seeded ``Model.init``) over a (2, 2048) prefill and, with autograd,
over a (1, 2048) training row: the block's median time by CUDA events, then
one run under ``torch.profiler`` with its device time by kernel (the top 15)
and by kind (GEMMs, the f32 batched products of the SSD form, elementwise /
other). The card's name and power limit come first.
"""
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.layers import rms_norm  # noqa: E402
from repro_torch.models.mamba import mamba2_forward  # noqa: E402


def median_ms(fn, iters=10):
    fn()
    torch.cuda.synchronize()
    spans = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        spans.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in spans)


def kind(name: str) -> str:
    n = name.lower()
    if any(k in n for k in ("gemm", "xmma", "nvjet", "cutlass", "cublas")):
        return "GEMMs (bf16 projections; f32 batched SSD products)"
    return "elementwise / other"


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("mamba2_profile: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    cfg = get_arch("zamba2-7b").replace(n_layers=6)  # one super-block: its first block
    model = build_model(cfg)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    block = {k: v[0, 0].clone() for k, v in params["mamba_blocks"].items()
             if not isinstance(v, dict)}
    block["body"] = {k: v[0, 0].clone() for k, v in params["mamba_blocks"]["body"].items()}
    del params
    g = torch.Generator(device=model.device).manual_seed(1)
    for rows, train in ((2, False), (1, True)):
        x = torch.randn((rows, 2048, cfg.d_model), generator=g, device=model.device).bfloat16()
        if train:
            leaves = [t.requires_grad_() for t in block["body"].values()]

            def run():
                y = x + mamba2_forward(block["body"], rms_norm(x, block["ln"]), cfg.ssm_state)
                torch.autograd.grad(y.float().square().mean(), leaves)
        else:
            def run():
                with torch.inference_mode():
                    x + mamba2_forward(block["body"], rms_norm(x, block["ln"]), cfg.ssm_state)
        what = f"({rows}, 2048) {'forward + backward' if train else 'prefill forward'}"
        print(f"one Mamba2 block, {what}: {median_ms(run):.3f} ms median of 10")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        rows_ = [(e.device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                 if e.device_time_total > 0]
        total = sum(r[0] for r in rows_)
        by_kind = {}
        for ms, _, name in rows_:
            by_kind[kind(name)] = by_kind.get(kind(name), 0.0) + ms
        print(f"  device time {total:.3f} ms: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in sorted(by_kind.items(), key=lambda kv: -kv[1])))
        for ms, n, name in sorted(rows_, reverse=True)[:15]:
            print(f"  {ms:8.3f} ms x{n:3d}  {name[:110]}")


if __name__ == "__main__":
    main()

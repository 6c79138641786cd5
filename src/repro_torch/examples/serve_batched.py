"""Batched serving example (``examples/serve_batched.py``, ported): a batch
of prompts fed through the decode path, then greedy decode, with a reduced
gemma2 (alternating local and global attention, ring-buffer local caches).

  PYTHONPATH=src python -m repro_torch.examples.serve_batched [--device cpu]

The prompt fills the cache by teacher-forced decode steps, as in the JAX
example (``launch.serve.serve``). Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..configs import get_arch
    from ..launch.serve import serve
    from ..models import build_model

    cfg = get_arch("gemma2-2b").smoke_variant()
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator(device=model.device).manual_seed(0))
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=torch.Generator(device=model.device).manual_seed(1),
                            device=model.device)
    where = (torch.cuda.get_device_name(model.device) if model.device.type == "cuda"
             else "cpu")
    print(f"serving gemma2 (reduced): batch={args.batch}, local window="
          f"{cfg.sliding_window}, cache={args.cache_len}, on {where}")
    res = serve(model, params, prompts, args.gen, args.cache_len)
    if not bool(torch.isfinite(res.logits[..., :cfg.vocab]).all()):
        raise SystemExit("serve_batched: non-finite logits")
    print(f"{res.steps} decode steps in {res.seconds:.2f}s -> "
          f"{args.batch * res.steps / res.seconds:.0f} tok/s "
          f"({1e3 * res.seconds / res.steps:.1f} ms/step)")
    print("sample generations (token ids):")
    for i in range(min(3, args.batch)):
        print(f"  seq{i}: {res.tokens[i][:12].tolist()}")


if __name__ == "__main__":
    main()

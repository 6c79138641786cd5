"""Serving entry point of the port: prefill a batch of requests, then batched
greedy decode (``repro.launch.serve``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m --smoke \\
      --batch 4 --prompt-len 32 --gen 16 [--device cpu]

Runs on the card unless ``--device cpu``. The prefill fills the cache by
teacher-forced decode steps over the prompt (one decode path to maintain,
as in the JAX package), then decodes greedily.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import torch
from torch.distributed.tensor import DTensor

from ..models.model import Model, Params


@dataclass
class ServeResult:
    tokens: torch.Tensor  # (b, gen) generated token ids
    steps: int  # decode steps run (prompt_len + gen - 1)
    seconds: float  # host clock over the loop, ending in a device sync
    logits: torch.Tensor  # (b, 1, padded vocab) f32 of the last step


def serve(model: Model, params: Params, prompts: torch.Tensor, gen: int,
          cache_len: int) -> ServeResult:
    """Feed ``prompts`` (b, prompt_len) through decode steps (teacher
    forcing), then take ``gen`` greedy tokens; the first generated token
    comes from the step on the last prompt token. A meshed model
    (``Model.set_mesh_context``) takes DTensor params and prompts and returns
    DTensor tokens and logits; its loop runs under ``no_grad`` (a DTensor's
    views cannot cross into inference mode)."""
    b, prompt_len = prompts.shape
    if gen < 1 or prompt_len < 1:
        raise ValueError("serve: needs a prompt token and at least one generated token")
    vocab = model.cfg.vocab
    dev = prompts.device
    cache = model.init_cache(b, cache_len)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    tok = prompts[:, :1]
    out = []
    steps = prompt_len + gen - 1
    with torch.no_grad() if isinstance(prompts, DTensor) else torch.inference_mode():
        for t in range(steps):
            pos = torch.full((b,), t, dtype=torch.int64, device=dev)
            logits, cache = model.decode_step(params, tok, pos, cache)
            if t + 1 < prompt_len:
                tok = prompts[:, t + 1:t + 2]
            else:
                tok = torch.argmax(logits[:, -1:, :vocab], dim=-1)
                out.append(tok)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return ServeResult(torch.cat(out, dim=1), steps, time.perf_counter() - t0, logits)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..configs import get_arch
    from ..models import build_model

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke_variant()
    model = build_model(cfg, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(0)
    params = model.init(gen)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len), generator=gen,
                            device=model.device)
    res = serve(model, params, prompts, args.gen, args.cache_len)
    where = torch.cuda.get_device_name(model.device) if model.device.type == "cuda" else "cpu"
    print(f"arch={cfg.name} batch={args.batch} {res.steps} decode steps in {res.seconds:.2f}s "
          f"({1e3 * res.seconds / res.steps:.1f} ms/step, "
          f"{args.batch * res.steps / res.seconds:.1f} tok/s) on {where}")
    print("generated token ids (seq 0):", res.tokens[0].tolist())


if __name__ == "__main__":
    main()

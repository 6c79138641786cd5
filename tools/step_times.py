#!/usr/bin/env python3
"""Steady DFL step times of the port on one CUDA card, at two of
``chip_smoke.py`` phase 5's tree runs, from any checkout's ``src``.

    python3 tools/step_times.py [--src DIR] [--steps N]

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that two trees are timed in one call: run
it for A, B, B, A. Each run is phase 5's: 4 stacked nodes, tree
all-reduce, AdamW (the config's moments, fp32 masters), warm-up 0, params
from seed 0; smollm-360m at full depth, (2, 2048) a node, lr 1e-3;
whisper-tiny at full depth, (8, 448) tokens and (8, 1500, 384) seeded f32
frames a node, lr 3e-4. Each takes ``--steps`` steps with the trainer
timed (synchronized between its three phases, as phase 5 runs it), then
as many untimed (synchronized only at the step's end, as the launcher
runs it). Prints each step's ms (host clock), then one JSON line.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUNS = {"smollm-360m": (2, 2048, 1e-3), "whisper-tiny": (8, 448, 3e-4)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(HERE, "src"))
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    src = os.path.abspath(args.src)
    sys.path.insert(0, src)
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.data import DataConfig, FederatedData
    from repro_torch.dfl.trainer import DFLConfig, DFLTrainer
    from repro_torch.models import Batch, build_model

    if not torch.cuda.is_available():
        print("tools/step_times.py needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    out = {"src": src}
    for arch, (bpn, seq, lr) in RUNS.items():
        cfg = get_arch(arch).replace(remat=False)
        model = build_model(cfg, device="cuda")
        tok, lab = FederatedData(DataConfig(vocab=cfg.vocab, seq_len=seq, batch_per_node=bpn,
                                            n_nodes=4, seed=0)).global_batch()
        frontend = {}
        if cfg.family == "audio":
            gen = torch.Generator(device=dev).manual_seed(3)
            frontend["encoder_frames"] = torch.randn((4 * bpn, cfg.n_frames, cfg.d_model),
                                                     generator=gen, device=dev)
        batch = Batch(tokens=torch.from_numpy(tok).long().to(dev),
                      labels=torch.from_numpy(lab).long().to(dev), **frontend)
        trainer = DFLTrainer(model, 4, DFLConfig(gossip_mode="tree_allreduce", lr=lr,
                                                 warmup=0), device="cuda", timed=True)
        state = trainer.state_from_params(model.init(torch.Generator(device=dev).manual_seed(0)))
        for timed in (True, False):
            trainer.timed = timed
            ms = []
            for _ in range(args.steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = trainer.train_step(state, batch)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                float(m["loss"])
            key = f"{arch} {'timed' if timed else 'untimed'}"
            out[key] = ms
            print(f"[steps] {key}: {', '.join(f'{t:.1f}' for t in ms)} ms on "
                  f"{torch.cuda.get_device_name(0)}")
        del trainer, state, m, model, batch
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

#!/usr/bin/env python3
"""The first DFL steps of qwen3-moe-30b-a3b at 1 layer in the port, by width,
dtype and learning rate, on one CUDA card.

    python3 tools/moe_lr_probe.py

4 stacked nodes x (1, 2048) tokens (``DataConfig(seed=0)``), tree
all-reduce, AdamW (the config's bf16 moments and fp32 masters), warm-up 0:
prints each run's (loss, grad norm) over 4 steps. At d 2048 and lr 1e-3 the
first step overshoots (the loss rises, then falls); this shows whether that
follows the step size and the width rather than the dtype.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "src"))

import torch  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import DataConfig, FederatedData  # noqa: E402
from repro_torch.dfl.trainer import DFLConfig, DFLTrainer  # noqa: E402
from repro_torch.models import Batch, build_model  # noqa: E402

RUNS = [(2048, "bfloat16", 1e-3), (2048, "bfloat16", 3e-4), (2048, "bfloat16", 1e-4),
        (2048, "float32", 1e-3), (1024, "bfloat16", 1e-3), (512, "bfloat16", 1e-3)]


def main() -> None:
    for d, dtype, lr in RUNS:
        cfg = get_arch("qwen3-moe-30b-a3b").replace(n_layers=1, remat=False, d_model=d,
                                                    dtype=dtype)
        model = build_model(cfg)
        tok, lab = FederatedData(DataConfig(vocab=cfg.vocab, seq_len=2048, batch_per_node=1,
                                            n_nodes=4, seed=0)).global_batch()
        batch = Batch(tokens=torch.from_numpy(tok).long().to(model.device),
                      labels=torch.from_numpy(lab).long().to(model.device))
        trainer = DFLTrainer(model, 4, DFLConfig(gossip_mode="tree_allreduce", lr=lr, warmup=0),
                             device=model.device)
        state = trainer.init_state(torch.Generator(device=model.device).manual_seed(0))
        out = []
        for _ in range(4):
            state, m = trainer.train_step(state, batch)
            out.append((round(float(m["loss"]), 4), round(float(m["grad_norm"]), 3)))
        print(f"d {d} {dtype} lr {lr}: (loss, grad norm) x 4 steps {out}", flush=True)
        del state, trainer, model
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

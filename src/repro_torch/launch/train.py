"""End-to-end DFL training driver of the port (``repro.launch.train``).

N DFL nodes stacked on one device take real steps with a MOSGU gossip
round every ``--gossip-interval`` steps, per-node checkpoints and, with
``--scenario``, a registry scenario's protocol, codec, round count and churn
schedule (moderator rotation every round, replan on churn):

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --smoke \\
      --steps 3 --nodes 4 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --nodes 4 \\
      --scenario mesh_smoke --device cpu

``--nodes`` takes the place of the JAX launcher's ``--mesh``: one device
holds every node. Without ``--device cpu`` it runs on the card. The
launcher's ``--sweep``, ``--cell`` and ``--trace`` are not ported yet
(ROADMAP A9). ``--warmup`` defaults to 0: the cosine schedule gives lr 0
at step 0 with a warm-up, so a short run would not move.
"""
from __future__ import annotations

import argparse
import time
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--smoke", action="store_true", help="use the reduced variant")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch-per-node", type=int, default=2)
    ap.add_argument("--nodes", type=int, default=1, help="DFL nodes stacked on the device")
    ap.add_argument("--gossip", default="tree_allreduce")
    ap.add_argument("--codec", default="", help="gossip wire codec: bf16, int8, int4, topk")
    ap.add_argument("--scenario", default="",
                    help="registry scenario driving protocol / codec / rounds / churn")
    ap.add_argument("--gossip-interval", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--warmup", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .. import resolve_device
    from ..checkpoint import node_checkpoint_path, save_pytree
    from ..configs import get_arch
    from ..data import DataConfig, FederatedData
    from ..dfl.collectives import tree_map
    from ..dfl.trainer import DFLConfig, DFLTrainer
    from ..models import Batch, build_model
    from ..optim.optimizers import tree_leaves
    from ..scenario.spec import get as get_scenario
    from ..scenario.spec import resolve_gossip_mode

    dev = resolve_device(args.device)
    scenario, codec = None, args.codec
    if args.scenario:
        scenario = get_scenario(args.scenario)
        args.gossip = resolve_gossip_mode(scenario.protocol)
        args.steps = scenario.rounds
        codec = scenario.codec if scenario.codec != "fp32" else ""
        print(f"scenario {scenario.name!r}: protocol={scenario.protocol} codec={scenario.codec} "
              f"rounds={scenario.rounds} churn={len(scenario.churn)} events")

    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke_variant()
    model = build_model(cfg, device=dev)
    dfl = DFLConfig(gossip_mode=args.gossip, gossip_interval=args.gossip_interval, lr=args.lr,
                    warmup=args.warmup, total_steps=args.steps, codec=codec)
    trainer = DFLTrainer(model, args.nodes, dfl, device=dev)
    state = trainer.init_state(torch.Generator(device=dev).manual_seed(0))
    n_params = sum(t[0].numel() for t in tree_leaves(state.params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M nodes={args.nodes} "
          f"mst_slots={trainer.plan.dissemination.n_slots} gossip={args.gossip} "
          f"codec={codec or 'fp32'} device={dev}")

    data = FederatedData(DataConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                                    batch_per_node=args.batch_per_node, n_nodes=args.nodes))

    def make_batch() -> Batch:
        """The next global batch; whisper's frames and paligemma's patches
        are zeros in f32, as the JAX launcher makes them (the frontends are
        stubs)."""
        tok, lab = data.global_batch()
        kw = {}
        if cfg.family == "audio":
            kw["encoder_frames"] = torch.zeros((tok.shape[0], cfg.n_frames, cfg.d_model),
                                               device=dev)
        if cfg.family == "vlm":
            kw["patch_embeddings"] = torch.zeros((tok.shape[0], cfg.n_patches, cfg.d_model),
                                                 device=dev)
        return Batch(tokens=torch.from_numpy(tok).long().to(dev),
                     labels=torch.from_numpy(lab).long().to(dev), **kw)

    batch = make_batch()
    if scenario is not None:
        from ..dfl.session import DFLSession, run_scenario_rounds

        session = DFLSession(trainer, scenario=scenario)
        t0 = time.time()
        run_scenario_rounds(session, state, batch, make_batch)
        print(f"done: {scenario.rounds} scenario rounds in {time.time() - t0:.1f}s")
        return

    t0, losses = time.time(), []
    for i in range(args.steps):
        state, metrics = trainer.train_step(state, batch)
        losses.append(float(metrics["loss"]))
        batch = make_batch()
        if (i + 1) % args.log_every == 0 or i == 0:
            print(f"step {i + 1:5d} loss={losses[-1]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"({(time.time() - t0) / (i + 1):.2f}s/step)")
        if args.checkpoint_dir and args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            for node in range(args.nodes):
                save_pytree(node_checkpoint_path(args.checkpoint_dir, node, i + 1),
                            tree_map(lambda t: t[node], state.params),
                            {"step": i + 1, "arch": cfg.name, "node": node})
    print(f"done: {args.steps} steps in {time.time() - t0:.1f}s, loss "
          + " ".join(f"{x:.4f}" for x in losses))


if __name__ == "__main__":
    main()

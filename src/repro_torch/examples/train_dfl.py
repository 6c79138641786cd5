"""End-to-end DFL training example (``examples/train_dfl.py``, ported): 4
silos with non-IID data, local steps and a MOSGU gossip round every step,
the nodes stacked on one device.

  PYTHONPATH=src python -m repro_torch.examples.train_dfl [--steps 200] \\
      [--d-model 512] [--nodes 4] [--device cpu]

Trains a reduced smollm-360m with ``--gossip`` (tree all-reduce by default),
then naive flooding from the same init on identical data, and checks that
both end at the same global model (the nodes' mean of every parameter,
within ``MODEL_TOL`` of its largest magnitude: the two rounds average alike
and differ only in the f32 order of their sums). As in the JAX example, the
nodes start equal and apply one mean gradient, so the check shows that both
modes run, not that they average right: a wrong average would pass it too.
The JAX example's
``--mesh`` (its forced host-device count) becomes ``--nodes``. With
``--scenario NAME`` (e.g. ``mesh_smoke``) the run goes through
:class:`repro_torch.dfl.session.DFLSession` driven by the registry
scenario: its protocol picks the gossip mode and its churn fires at the
pinned rounds; no comparison is made. Runs on the card unless ``--device
cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

MODEL_TOL = 1e-4


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--nodes", type=int, default=4, help="DFL nodes stacked on the device")
    ap.add_argument("--gossip", default="tree_allreduce")
    ap.add_argument("--codec", default="",
                    help="gossip payload codec (bf16/int8/int4/topk); topk "
                         "carries error-feedback residuals across rounds")
    ap.add_argument("--scenario", default="",
                    help="registry scenario driving protocol + churn")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from .. import resolve_device
    from ..configs import get_arch
    from ..data import DataConfig, FederatedData
    from ..dfl.trainer import DFLConfig, DFLTrainer
    from ..models import Batch, build_model
    from ..optim.optimizers import tree_leaves
    from ..scenario.registry import get as get_scenario
    from ..scenario.spec import resolve_gossip_mode

    dev = resolve_device(args.device)
    scenario = None
    if args.scenario:
        scenario = get_scenario(args.scenario)
        args.gossip = resolve_gossip_mode(scenario.protocol)
        args.steps = scenario.rounds
        if not args.codec:
            args.codec = scenario.codec if scenario.codec != "fp32" else ""
        print(f"scenario {scenario.name!r}: protocol={scenario.protocol} "
              f"rounds={args.steps} codec={args.codec or 'fp32'} "
              f"churn={[dataclasses.asdict(e) for e in scenario.churn]}")

    cfg = get_arch("smollm-360m").replace(
        n_layers=args.layers, d_model=args.d_model, n_heads=8, n_kv_heads=4,
        head_dim=64, d_ff=2 * args.d_model, vocab=args.vocab,
        dtype="float32", optimizer_dtype="float32", remat=False,
    )
    model = build_model(cfg, device=dev)

    def run(gossip: str):
        """``args.steps`` steps with ``gossip`` from the seeded init, on the
        seeded data; returns the last state."""
        trainer = DFLTrainer(model, args.nodes, DFLConfig(
            gossip_mode=gossip, codec=args.codec, lr=3e-3, warmup=20,
            total_steps=args.steps), device=dev)
        data = FederatedData(DataConfig(
            vocab=cfg.vocab, seq_len=args.seq_len, batch_per_node=4,
            n_nodes=args.nodes, dirichlet_alpha=0.3, seed=1))

        def next_batch() -> Batch:
            tok, lab = data.global_batch()
            return Batch(tokens=torch.from_numpy(tok).long().to(dev),
                         labels=torch.from_numpy(lab).long().to(dev))

        state = trainer.init_state(torch.Generator(device=dev).manual_seed(0))
        plan = trainer.plan
        print(f"[{gossip}] DFL nodes: {plan.n_nodes} | MST slots/round: "
              f"{plan.dissemination.n_slots} | tree slots: {plan.tree.n_slots}")
        t0 = time.time()
        if scenario is not None:
            from ..dfl.session import DFLSession, run_scenario_rounds

            session = DFLSession(trainer, scenario=scenario)
            state, _ = run_scenario_rounds(session, state, next_batch(), next_batch)
        else:
            batch = next_batch()
            for i in range(args.steps):
                state, metrics = trainer.train_step(state, batch)
                batch = next_batch()
                if i == 0 or (i + 1) % 25 == 0:
                    print(f"[{gossip}] step {i + 1:4d}  loss {float(metrics['loss']):.4f}  "
                          f"gnorm {float(metrics['grad_norm']):.3f}  "
                          f"({(time.time() - t0) / (i + 1):.2f}s/step)")
        print(f"[{gossip}] done in {time.time() - t0:.0f}s")
        return state

    n_params = sum(t.numel() for t in tree_leaves(model.init(
        torch.Generator(device=dev).manual_seed(0))))
    print(f"model: {n_params / 1e6:.1f}M params | {args.nodes} nodes on {dev}")
    state = run(args.gossip)
    if scenario is not None:
        return
    # the same run with flooding: the same global model
    other = run("flooding")
    worst = 0.0
    for a, b in zip(tree_leaves(state.params), tree_leaves(other.params)):
        ga, gb = a.float().mean(dim=0), b.float().mean(dim=0)
        worst = max(worst, float((ga - gb).abs().max()) / max(float(gb.abs().max()), 1e-30))
    same = worst <= MODEL_TOL
    print(f"{args.gossip} vs flooding on identical data: global models within "
          f"{worst:.3e} of max|param| (tol {MODEL_TOL}) -> {'same' if same else 'DIFFER'}")
    if not same:
        raise SystemExit(1)


if __name__ == "__main__":
    main()

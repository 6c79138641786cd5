"""The port's examples run on the CPU at their smallest flags.

* ``python -m repro_torch.examples.train_dfl``: tree all-reduce, then
  flooding on identical data from the same init; both end at the same
  global model (the example's own check, within its ``MODEL_TOL``), and
  ``--scenario mesh_smoke`` drives the session through its churn. The
  example's nodes start equal and apply one mean gradient (ROADMAP R9), so
  its check shows that both modes run end to end, not that they average
  right: a mode that averaged wrongly would still end "same". The test
  with unequal nodes below gives the same trainer a start where a wrong
  average shows.
* ``python -m repro_torch.examples.serve_batched``: a reduced gemma2's
  prompts through the decode path, then greedy tokens inside the vocab.
* ``python -m repro_torch.examples.quickstart`` and
  ``python -m repro_torch.examples.topology_playground``: the JAX
  package's scripts' lines, the playground's wall-clock figures aside.
"""
import os
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ("--d-model", "64", "--layers", "1", "--seq-len", "16", "--vocab", "256")


def _run(module, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", module, *args], capture_output=True, text=True,
                         env=env, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_train_dfl_tree_and_flooding_end_at_the_same_global_model():
    """Both modes run through the example and its check passes (it cannot
    fail from the example's equal start; see the module docstring)."""
    out = _run("repro_torch.examples.train_dfl", "--steps", "3", *TINY, "--device", "cpu")
    assert "[tree_allreduce] DFL nodes: 4" in out and "[flooding] done" in out
    m = re.search(r"global models within ([\d.e+-]+) of max\|param\| \(tol ([\d.e+-]+)\) -> same",
                  out)
    assert m and float(m.group(1)) <= float(m.group(2)), out


def test_train_dfl_gossip_modes_agree_from_unequal_nodes():
    """The example's model and trainer, each node's parameters moved by its
    own seeded noise, one step of tree all-reduce and one of flooding on the
    same batch: every node ends at its mode's global model, and the two
    global models agree within the example's MODEL_TOL of max|param|."""
    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.dfl.trainer import DFLConfig, DFLTrainer
    from repro_torch.examples.train_dfl import MODEL_TOL
    from repro_torch.models import Batch, build_model
    from repro_torch.optim.optimizers import tree_leaves

    cfg = get_arch("smollm-360m").replace(
        n_layers=1, d_model=64, n_heads=8, n_kv_heads=4, head_dim=64, d_ff=128, vocab=256,
        dtype="float32", optimizer_dtype="float32", remat=False)
    model = build_model(cfg, device="cpu")
    g = np.random.default_rng(4)
    tok = torch.from_numpy(g.integers(0, cfg.vocab, (16, 16))).long()
    batch = Batch(tokens=tok, labels=torch.roll(tok, -1, dims=1))
    ends = {}
    for mode in ("tree_allreduce", "flooding"):
        trainer = DFLTrainer(model, 4, DFLConfig(gossip_mode=mode, lr=3e-3, warmup=0),
                             device="cpu")
        state = trainer.init_state(torch.Generator().manual_seed(0))
        noise = np.random.default_rng(5)
        for p in tree_leaves(state.params):
            p.add_(torch.from_numpy(noise.standard_normal(tuple(p.shape)).astype(np.float32))
                   .to(p.dtype) * 0.1)
        if "master" in state.opt_state:
            for m, p in zip(tree_leaves(state.opt_state["master"]), tree_leaves(state.params)):
                m.copy_(p)
        state, _ = trainer.train_step(state, batch)
        leaves = [t.float() for t in tree_leaves(state.params)]
        for t in leaves:  # one model on every node
            mean = t.mean(dim=0, keepdim=True)
            assert float((t - mean).abs().max()) <= MODEL_TOL * float(mean.abs().max()), mode
        ends[mode] = [t.mean(dim=0) for t in leaves]
    for a, b in zip(ends["tree_allreduce"], ends["flooding"]):
        assert float((a - b).abs().max()) <= MODEL_TOL * float(b.abs().max())


def test_train_dfl_scenario_drives_the_session():
    out = _run("repro_torch.examples.train_dfl", "--scenario", "mesh_smoke", *TINY,
               "--device", "cpu")
    rounds = re.findall(r"round +\d+ loss=[\d.]+ members=(\[[\d, ]+\])", out)
    assert rounds == ["[0, 1, 2, 3]", "[0, 1, 2]"], out
    assert "flooding" not in out


def test_serve_batched_decodes_greedy_tokens():
    out = _run("repro_torch.examples.serve_batched", "--batch", "2", "--prompt-len", "4",
               "--gen", "4", "--device", "cpu")
    assert "serving gemma2 (reduced): batch=2" in out and "on cpu" in out
    assert re.search(r"7 decode steps in [\d.]+s", out), out
    seqs = re.findall(r"seq\d: \[([\d, ]+)\]", out)
    assert len(seqs) == 2 and all(len(s.split(",")) == 4 for s in seqs)
    assert all(0 <= int(t) < 256000 for s in seqs for t in s.split(","))


def test_quickstart_matches_the_reference():
    """``python -m repro_torch.examples.quickstart --device cpu`` prints the
    JAX package's ``examples/quickstart.py`` line for line: the MST edges,
    the colors and slot length, the queue engine's 90 transmissions and the
    FedAvg of 4.50 (through ``fedavg``), the netsim ratios against
    flooding, and the churn round's 72 transmissions."""
    ours = _run("repro_torch.examples.quickstart", "--device", "cpu")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "quickstart.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    assert ours.splitlines() == ref.stdout.splitlines()
    assert "  transmissions:    90 (optimal N(N-1) = 90; flooding would need 400)" in ours
    assert "  FedAvg at node 0: 4.50 (expected 4.50)" in ours
    assert re.search(r"EfficientNet-B0 .* round 32\.8s -> 11\.6s \(2\.8x\)", ours), ours
    assert "  new round over 9 nodes: 72 transmissions (= 9*8 = 72)" in ours


def _strip_walls(text):
    """The two wall-clock figures aside: the N=1000 engine's and
    ``table3_full``'s seconds."""
    text = re.sub(r"(slots simulated in )[\d.]+s", r"\1<wall>", text)
    return re.sub(r"(cells in )[\d.]+s", r"\1<wall>", text).splitlines()


def test_topology_playground_matches_the_reference():
    """``python -m repro_torch.examples.topology_playground --device cpu``
    prints the JAX package's ``examples/topology_playground.py`` line for
    line once its two wall-clock figures are stripped: the per-topology
    slot / transfer table, the protocol matrix, the N=1000 engine's counts,
    the MST agreement, the netsim and queue-engine scenario rows (churn
    included), table3_full's marginals and the underlay curves."""
    ours = _run("repro_torch.examples.topology_playground", "--device", "cpu")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, os.path.join(ROOT, "examples", "topology_playground.py")],
                         capture_output=True, text=True, env=env, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    assert _strip_walls(ours) == _strip_walls(ref.stdout)
    assert ("vectorized engine, N=1000 watts_strogatz: 999000 transmissions over 2064 slots "
            "simulated in <wall>") in _strip_walls(ours)
    assert "table3_full: 32 cells in <wall> (8 unique plans, 24 cache hits)" in _strip_walls(ours)

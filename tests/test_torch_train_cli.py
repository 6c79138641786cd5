"""The port's training CLI (``python -m repro_torch.launch.train``) on the
CPU, and its checkpoints crossing to the JAX package and back.

* ``--smoke --steps 3 --nodes 4 --device cpu`` trains: three finite losses,
  falling, and one checkpoint per node at the step asked for.
* A node checkpoint written by the port restores with
  ``repro.checkpoint.restore_pytree`` into the JAX model's param tree, leaf
  for leaf equal; the JAX package's ``save_pytree`` of that tree restores in
  the port equal again; the metadata reads the same in both.
* bf16 leaves keep their bits through the port's save and restore (stored
  as raw 16-bit patterns, as ``np.savez`` stores the JAX package's).
* ``--scenario mesh_smoke`` drives the session: the churn fires at round 1.
* ``--arch qwen3-moe-30b-a3b``, ``arctic-480b``, ``stablelm-12b`` and
  ``zamba2-7b`` (hybrid) train (smoke).
"""
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import load_metadata as jax_load_metadata  # noqa: E402
from repro.checkpoint import restore_pytree as jax_restore  # noqa: E402
from repro.checkpoint import save_pytree as jax_save  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.checkpoint import (  # noqa: E402
    load_metadata,
    node_checkpoint_path,
    restore_pytree,
    save_pytree,
)
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.optim.optimizers import tree_leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cli(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *args],
                         capture_output=True, text=True, env=env, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    ckpt = tmp_path_factory.mktemp("ckpt")
    out = _cli("--smoke", "--steps", "3", "--nodes", "4", "--device", "cpu",
               "--checkpoint-dir", str(ckpt), "--checkpoint-every", "3")
    return out, ckpt


def test_cli_trains_with_falling_loss(trained):
    out, ckpt = trained
    assert "nodes=4" in out and "device=cpu" in out
    losses = [float(x) for x in re.search(r"done: 3 steps .* loss (.*)", out).group(1).split()]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert losses[2] < losses[1] < losses[0], losses
    for node in range(4):
        assert os.path.isfile(node_checkpoint_path(str(ckpt), node, 3))


def test_port_checkpoint_restores_in_the_jax_package_and_back(trained, tmp_path):
    _, ckpt = trained
    path = node_checkpoint_path(str(ckpt), 2, 3)
    like_t = build_model(get_arch("smollm-360m").smoke_variant(), device="cpu").init(
        torch.Generator().manual_seed(0))
    ours = restore_pytree(path, like_t)
    like_j = jax_build_model(jax_get_arch("smollm-360m").smoke_variant()).init(
        jax.random.PRNGKey(0))
    theirs = jax_restore(path, like_j)
    flat_j = jax.tree_util.tree_flatten_with_path(theirs)[0]
    flat_t = tree_leaves(ours)
    assert len(flat_j) == len(flat_t)
    for (name, j), t in zip(flat_j, flat_t):
        assert np.array_equal(np.asarray(j), t.numpy()), name
    assert load_metadata(path) == jax_load_metadata(path) == \
        {"step": 3, "arch": "smollm-360m", "node": 2}
    back = str(tmp_path / "from_jax")
    jax_save(back, theirs, {"round": 7})
    again = restore_pytree(back, like_t)
    for a, b in zip(tree_leaves(again), flat_t):
        assert torch.equal(a, b)
    assert load_metadata(back) == {"round": 7}


def test_bf16_leaves_keep_their_bits(tmp_path):
    g = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(4, 6, generator=g).bfloat16(),
            "blocks": [{"b": torch.randn(3, generator=g)}, {"b": torch.randn(3, generator=g)}]}
    save_pytree(str(tmp_path / "t"), tree)
    assert np.load(str(tmp_path / "t.npz"))["w"].dtype == np.dtype("V2")
    back = restore_pytree(str(tmp_path / "t.npz"), tree)
    assert back["w"].dtype == torch.bfloat16 and torch.equal(back["w"], tree["w"])
    assert torch.equal(back["blocks"][1]["b"], tree["blocks"][1]["b"])
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_pytree(str(tmp_path / "t.npz"), {**tree, "w": torch.zeros(4, 5)})


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "arctic-480b"])
def test_cli_trains_a_moe_arch(arch):
    """The moe smoke variants train from the CLI: qwen3-moe (AdamW, one
    microbatch) and arctic (Adafactor, 8 microbatches over the 4 nodes'
    rows); the loss of a fixed-seed run falls."""
    out = _cli("--arch", arch, "--smoke", "--steps", "3", "--nodes", "4", "--seq-len", "32",
               "--batch-per-node", "2", "--device", "cpu")
    assert f"arch={arch}" in out and "nodes=4" in out
    losses = [float(x) for x in re.search(r"done: 3 steps .* loss (.*)", out).group(1).split()]
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[2] < losses[0], losses


@pytest.mark.parametrize("arch", ["stablelm-12b", "zamba2-7b"])
def test_cli_trains_stablelm_and_the_hybrid(arch):
    """The dense stablelm-12b and the hybrid zamba2-7b (Mamba2 blocks and the
    shared attention block) smoke variants train from the CLI; the loss
    falls."""
    out = _cli("--arch", arch, "--smoke", "--steps", "3", "--nodes", "4", "--seq-len", "32",
               "--batch-per-node", "2", "--device", "cpu")
    assert f"arch={arch}" in out and "nodes=4" in out
    losses = [float(x) for x in re.search(r"done: 3 steps .* loss (.*)", out).group(1).split()]
    assert len(losses) == 3 and all(np.isfinite(losses)) and losses[2] < losses[0], losses


def test_cli_scenario_drives_the_session():
    out = _cli("--smoke", "--nodes", "4", "--scenario", "mesh_smoke", "--seq-len", "32",
               "--device", "cpu")
    rounds = re.findall(r"round +(\d+) loss=([\d.]+) members=(\[[\d, ]+\])", out)
    assert [r[2] for r in rounds] == ["[0, 1, 2, 3]", "[0, 1, 2]"]
    assert "done: 2 scenario rounds" in out

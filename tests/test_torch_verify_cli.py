"""``python -m repro_torch.verify --all`` prints the reference CLI's lines
(``python -m repro.verify --all``) once the ``(…s)`` timings are stripped:
every registry scenario and every cell of the gated sweeps, verified
through one shared plan cache, and the same exit status.

Its own file, so that no file takes much over 30 s under ``--dist
loadfile``: each CLI verifies every plan, the scale ones included.
"""
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

from repro_torch.scenario import scenarios  # noqa: E402
from repro_torch.verify.__main__ import GATED_SWEEPS  # noqa: E402
from test_torch_verify import ROOT, _strip  # noqa: E402


def test_cli_all_prints_the_references_lines():
    """Both CLIs run at once, each in its own process."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, "-m", module, "--all"], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env, cwd=ROOT)
             for module in ("repro_torch.verify", "repro.verify")]
    (ours, err), (theirs, jax_err) = (p.communicate(timeout=300) for p in procs)
    assert procs[0].returncode == 0, err[-3000:]
    assert procs[1].returncode == 0, jax_err[-3000:]
    assert _strip(ours) == _strip(theirs)
    n_lines = len(scenarios.names()) + sum(
        len(scenarios.get_sweep(name).cells()) for name in GATED_SWEEPS)
    assert ours.count("verified ✓") == n_lines
    assert "plans verified: 84 (re-use hits: 0)" in ours

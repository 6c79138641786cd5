"""The benchmark's tests: ``python -m pytest cardbench/tests -q`` from the
root of the repository. They import the harness's modules as the run does
(``cardbench/`` first on the path) and the program from ``src/``."""
import copy
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
for p in (str(ROOT / "src"), str(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)

# a cell's own widths cut to what a CPU test holds; every other setting kept
TINY = {
    "dense": dict(hidden_size=64, intermediate_size=128, num_attention_heads=4,
                  num_key_value_heads=2, num_hidden_layers=2, vocab_size=300),
    "mamba1": dict(hidden_size=64, intermediate_size=128, state_size=16, time_step_rank=4,
                   num_hidden_layers=2, vocab_size=300),
}
# the smallest Mamba1 size at which the control's loss reads as at full size
# (at d 64 it reads 1.5e-4 to 3e-4, under the cells' limit; at d 2048 1.3e-3
# to 3.1e-3, at full size 9.4e-4 to 1.1e-3)
MEDIUM = dict(hidden_size=2048, intermediate_size=4096, state_size=16, time_step_rank=128,
              num_hidden_layers=2, vocab_size=8192)


def tiny_cell(name: str, dtype: str = "float32", sizes=None, seq_len: int = 32):
    """(workload, configuration, traffic, cell) of ``name`` at a tiny size
    (or at ``sizes``)."""
    import spec

    w, cfg, traffic, cell = spec.cell_files(spec.benchmark(), name)
    cfg = copy.deepcopy(cfg)
    cfg.update(sizes or TINY[cfg["reference"]], dtype=dtype)
    traffic = dict(traffic, seq_len=seq_len, pool=6)
    return w, cfg, traffic, cell


@pytest.fixture
def card():
    """Skips without a CUDA device (decided here, not at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return "cuda"

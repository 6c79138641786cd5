"""On a card only (the ``gpu`` marker; each test skips without one): a
short run of every cell through the command's own entry, from this
checkout, prints one result line whose check passed.

    python -m pytest cardbench/tests -m gpu
"""
import json

import pytest

import run
import spec


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in spec.benchmark()["workloads"]])
def test_cell_runs_on_the_card(cell, card, capsys):
    assert run.main(["--workload", cell, "--seed", "2147483659", "--seconds", "2",
                     "--trace", "0"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
    assert list(line)[-1] == "checked"

"""The check that decides ``correct``, driven through a whole run on the CPU
(the run's look for a card skipped), under the cells' own limits: a sound
run passes and each fault the training cells can have (``faults.py``)
fails, at a tiny size; the control (the reference in fp8, in the program's
place) fails at a size where its loss reads as at full size, and reads at
least three times the sound program's there. At that size a node's loss
averages 64 tokens and not 2048, so both read some five times their
full-size values (the sound program too lies above the limit there); the
limits follow the readings at the cells' own sizes on the card (PERF.md)."""
import time

import pytest

import faults
import spec
from conftest import MEDIUM, tiny_cell

CELLS = ["falcon-mamba.tree", "falcon-mamba.int8-dissemination"]
SEED = 3_000_000_019


def drive(cell, monkeypatch=None, fault=None, control=False, medium=False):
    driver = spec.load_module("drivers", "dfl_train")
    _, cfg, traffic, limits = tiny_cell(cell, "bfloat16", *((MEDIUM, 64) if medium else ()))
    if fault:
        build = driver.build
        monkeypatch.setattr(driver, "build", lambda *a: faults.plant(fault, build(*a)))
    if control:
        monkeypatch.setattr(driver, "host_record", lambda rec: driver.reference(
            cfg, traffic, SEED, "cpu", "fp8"))
    ctx = driver.run(limits, cfg, traffic, SEED, 0.1, False, time.perf_counter(), "cpu")
    return ctx["correct"], {r["name"]: r["value"] for r in ctx["checked"]}


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    ok, values = drive(cell)
    assert ok, values


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_refused(cell, monkeypatch):
    ok, control = drive(cell, monkeypatch, control=True, medium=True)
    assert not ok, control
    monkeypatch.undo()
    _, sound = drive(cell, medium=True)
    assert control["loss_gap"] >= 3 * sound["loss_gap"], (control, sound)


# every node starts from weights of its own, so both cells' rounds move
# every node and each fault applies to both
CASES = [(c, f) for c in CELLS for f in faults.FAULTS]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_refused(cell, fault, monkeypatch):
    ok, values = drive(cell, monkeypatch, fault=fault)
    assert not ok, values

"""The comparison that decides ``correct`` for a training cell.

The program's first ``checked_steps`` steps (driven through the window's own
``train_step`` on the window's own feed) against the reference's, from the
same weights and rows (each node's own, drifted apart: ``weights.node_params``),
so that the round moves every node. Three numbers, and one for each leaf the
cell holds alone:

* ``loss_gap``: the first step's loss of each node (its own rows' mean
  cross-entropy), the root mean square over nodes of ``(program -
  reference) / reference``. Only the first step: AdamW's first update is
  about ``lr * sign(g)``, so rounding flips the sign of a leaf's small
  gradient elements and the two trajectories part by up to 1.3% of the loss
  within two steps, in sound runs and under the control alike. By node and
  not the step's mean: the step's mean averages each node's error away and
  reads a single draw, which swings tenfold from seed to seed (PERF.md gives
  both readings);
* ``grad_norm_gap``: each leaf's norm of the first clipped gradient (the
  program's worked out from its AdamW state after one step, ``m / (1 -
  b1)``), ``|program - reference|`` over the larger of the reference's norm
  of that leaf and of the median leaf; the median over leaves. Not the
  worst leaf: bf16 rounding moves this model's first gradient by 12-44%
  elementwise at init (the program's f32 path agrees to the bf16 moments'
  0.17%), so the worst leaf swings from 0.005 to 0.28 over seeds in sound
  runs, past a doubled leaf's 0.40; the median leaf reads 0.0005 to 0.017
  and the doubled leaf 0.24 (PERF.md gives both);
* ``change_norm_gap``: each leaf's norm of the masters' change over the
  steps (every node), measured as above, the worst leaf, over the leaves
  whose first gradient in the reference is at least a thousandth of the
  median leaf's (a leaf below that moves by rounding alone under AdamW). The
  worst leaf: a round left out shows in one leaf (``A_log``'s int8 noise).
* a leaf held alone (the cell's ``leaves``: a number's name and a leaf's
  path): that leaf's first clipped gradient, ``|program - reference|``
  over the reference's norm of it. The median above sees a fault in one
  leaf only through the clip's rescaling of the others; the embedding's
  gradient, which its bf16 lookup accumulates, is held by itself.

A reading that is not finite fails. The limits are the cell's
(``cardbench/cells/<cell>.json``); PERF.md gives the readings each was set
from.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List, Tuple

NOUGHT = 1e-3  # of the median leaf's first gradient

NUMBERS = ("loss_gap", "grad_norm_gap", "change_norm_gap")


def _finite(x: float) -> float:
    return x if math.isfinite(x) else math.inf


def _by_leaf(gaps: Dict[str, float], ref: Dict[str, float], keep) -> List[float]:
    floor = statistics.median(ref.values())
    return [_finite(gaps[p] / max(ref[p], floor)) for p in keep]


def leaf_gaps(prog: Dict[str, object], ref: Dict[str, object]) -> Dict[str, Dict[str, float]]:
    """Each leaf's ``|program - reference|`` of its first gradient's norm
    and of its change's norm."""
    return {
        "grad_norm": {p: abs(prog["first_grad"][p] - g) for p, g in ref["first_grad"].items()},
        "change": {p: abs(prog["change"][p] - c) for p, c in ref["change"].items()},
    }


def readings(prog: Dict[str, object], ref: Dict[str, object],
             leaves: Dict[str, str] = None) -> Dict[str, float]:
    """The numbers from the program's and the reference's records
    (``node_losses``, ``first_grad`` and ``change`` as
    ``reference.dfl.run_steps`` returns them); ``leaves`` maps a number's
    name to the path of a leaf held alone."""
    grads: Dict[str, float] = ref["first_grad"]
    median = statistics.median(grads.values())
    moved = [p for p, g in grads.items() if g >= NOUGHT * median]
    gaps = leaf_gaps(prog, ref)
    nodes = [((p - r) / r) ** 2 for p, r in zip(prog["node_losses"][0], ref["node_losses"][0])]
    out = {
        "loss_gap": _finite(math.sqrt(sum(nodes) / len(nodes))),
        "grad_norm_gap": statistics.median(_by_leaf(gaps["grad_norm"], grads, grads)),
        "change_norm_gap": max(_by_leaf(gaps["change"], ref["change"], moved)),
    }
    for name, path in (leaves or {}).items():
        out[name] = _finite(gaps["grad_norm"][path] / grads[path])
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, List[dict]]:
    """(every number within its limit, [{name, value, limit}]), in the
    order of ``limits``."""
    rows = [{"name": k, "value": values[k], "limit": v} for k, v in limits.items()]
    ok = all(math.isfinite(r["value"]) and r["value"] <= r["limit"] for r in rows)
    return ok, rows

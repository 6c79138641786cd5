"""Faults planted in the program's trainer, which the check must refuse.

``plant(name, trainer)`` wraps the trainer instance:

* ``unchanged``: a step returns its input state (its metrics from a step
  run on a copy);
* ``half_batch``: the labels of the second half of every row are left out,
  the loss and gradient the mean over the rest;
* ``no_exchange``: the gossip round returns the masters as they are;
* ``altered``: the embedding's gradient doubled where the backward makes it.
"""
from __future__ import annotations

import copy

FAULTS = ("unchanged", "half_batch", "no_exchange", "altered")


def plant(name: str, trainer):
    if name == "unchanged":
        step = trainer.train_step

        def unchanged(state, batch):
            _, metrics = step(copy.deepcopy(state), batch)
            return state, metrics

        trainer.train_step = unchanged
    elif name == "half_batch":
        grads = trainer.grads

        def half(params, batch):
            labels = batch.labels.clone()
            labels[:, labels.shape[1] // 2:] = -1
            return grads(params, type(batch)(tokens=batch.tokens, labels=labels))

        trainer.grads = half
    elif name == "no_exchange":
        trainer.gossip = lambda params, opt_state: (params, opt_state)
    elif name == "altered":
        grads = trainer.grads

        def altered(params, batch):
            loss, g, losses, mismatch = grads(params, batch)
            g["embed"]["table"] = g["embed"]["table"] * 2
            return loss, g, losses, mismatch

        trainer.grads = altered
    else:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
    return trainer

"""Faults planted under the timed path, so that a test can see the
comparison come out false: a step that leaves its state unchanged, half
of the batch left out (the loss's mean taken over the rest), and the
exchange between ranks left out; and, so that a test can see the run
print no result, a JAX module loaded in the last rank's process."""
from __future__ import annotations

import dataclasses
import sys
import types

FAULTS = ("state_unchanged", "half_batch", "no_exchange", "loads_jax")


def process_fault(name, rank: int, ranks: int) -> None:
    """``loads_jax``: a module named ``jax`` enters the last rank's
    ``sys.modules``."""
    if name == "loads_jax" and rank == ranks - 1:
        sys.modules.setdefault("jax", types.ModuleType("jax"))


def graph_fault(name, g: dict) -> dict:
    """The program's input graph under ``half_batch``: every second
    training node's label taken out of the loss."""
    if name != "half_batch":
        return g
    import numpy as np
    tr = g["train_mask"].copy()
    idx = np.flatnonzero(tr)
    tr[idx[1::2]] = False
    return {**g, "train_mask": tr}


def trainer_fault(name, trainer) -> None:
    """``state_unchanged``: the optimizer's update does nothing;
    ``no_exchange``: the halo exchange hands back zeros."""
    if name == "state_unchanged":
        def update(grads, state, params):
            state["step"] += 1
            return params, state
        trainer.opt = dataclasses.replace(
            trainer.opt, update=update,
            apply=lambda grads, state, params, scal: None)
    elif name == "no_exchange":
        import torch
        trainer.engine.comm.all_to_all = lambda buf: torch.zeros_like(buf)
    elif name not in (None, "half_batch", "loads_jax"):
        raise ValueError(f"unknown fault {name!r}")

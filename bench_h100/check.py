"""What decides ``correct``: the plain reference follows the program's
first steps from the same inputs, and three numbers are held to their
limits (``limits/<workload>.json``):

- ``loss_rel``: the largest gap of a step's loss, over the reference's;
- ``grad1_rel``: the first gradients as Adam took them (the program's
  worked out from its first moment after one step), the worst leaf's
  gap of norms over the larger of that leaf's reference norm and the
  median leaf's;
- ``change_rel``: the same for each parameter's change over the steps,
  leaving out leaves whose reference gradient is under a thousandth of
  the median leaf's (their change is round-off under Adam)."""
from __future__ import annotations

import numpy as np

from bench_h100.reference import train as ref_train
from bench_h100.spec import piece

NAMES = ("loss_rel", "grad1_rel", "change_rel")
QUIET_LEAF = 1e-3


def step_graphs(mix: dict, g: dict, seed: int, steps: int):
    """The graphs of the program's first ``steps`` steps, worked out
    again from the input graph and the seed by the traffic's strategy
    (``strategies/<strategy>.py``)."""
    return piece("strategies", mix["strategy"]).step_graphs(g, mix, seed,
                                                           steps)


def reference_readings(cfg, mix, g, params0, seed, steps, device,
                       tf32=False, half_batch=False, graphs=None) -> dict:
    """The reference's losses and leaf norms over the first ``steps``
    steps (``graphs``: their step graphs, when already worked out)."""
    if graphs is None:
        graphs = step_graphs(mix, g, seed, steps)
    if half_batch:
        graphs = [{**s, "loss_mask": _half(s["loss_mask"])} for s in graphs]
    out = ref_train.train_steps(cfg, params0, graphs, device, tf32=tf32)
    return {"losses": out["losses"],
            "grad1": {k: float(np.linalg.norm(v.double().numpy()))
                      for k, v in out["grad1"].items()},
            "change": {k: float(np.linalg.norm(v.double().numpy()))
                       for k, v in out["change"].items()}}


def _half(mask):
    m = mask.copy()
    m[np.flatnonzero(m)[1::2]] = 0.0
    return m


def compare(prog: dict, ref: dict) -> dict:
    """The three numbers of the program's readings against the
    reference's (each a dict of ``losses``, ``grad1`` and ``change``
    leaf norms)."""
    loss = max(abs(a - b) / max(abs(b), 1e-30)
               for a, b in zip(prog["losses"], ref["losses"]))
    if len(prog["losses"]) != len(ref["losses"]) or not np.isfinite(loss):
        loss = float("inf")
    g_ref = ref["grad1"]
    g_med = float(np.median(list(g_ref.values())))
    grad = max(abs(prog["grad1"][k] - v) / max(v, g_med, 1e-30)
               for k, v in g_ref.items())
    live = [k for k, v in g_ref.items() if v >= QUIET_LEAF * g_med]
    c_ref = ref["change"]
    c_med = float(np.median([c_ref[k] for k in live]))
    change = max(abs(prog["change"][k] - c_ref[k])
                 / max(c_ref[k], c_med, 1e-30) for k in live)
    return {"loss_rel": float(loss), "grad1_rel": float(grad),
            "change_rel": float(change)}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in NAMES)

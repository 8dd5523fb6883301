"""One run of one cell: the program's side in this process or in one
process a card (``repro_torch.launch.ranks``), then, once the window has
closed and the program's state is freed, the plain reference over the
same inputs, the comparison, the metrics, and the result line."""
from __future__ import annotations

import gc
import json
import sys
import time
from types import SimpleNamespace

from bench_h100 import check, program, spec as specs


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = None, fault=None,
             overrides=None, bench=None) -> dict:
    """The result of one run: the result line's object, whose last key
    ``"checks"`` holds each compared number and its limit, plus
    ``"captures_in_window"`` and ``"forbidden"`` (the JAX modules that
    this process or any rank's held once the window had closed) before
    it."""
    import torch
    t0 = time.time() if t0 is None else t0
    c = specs.load_cell(bench or specs.load_benchmark(), workload, overrides)
    cfg, mix = c["cfg"], c["mix"]
    ranks = int(mix.get("ranks", 1))
    spec = {"cfg": cfg, "mix": mix, "seed": int(seed),
            "seconds": float(seconds), "trace": bool(trace),
            "device": device, "fault": fault, "t0": t0,
            "per_layer": [m["name"] for m in c["per_layer"]]}
    if ranks > 1:
        from repro_torch.launch.ranks import launch
        outs = launch(program.run, ranks, args=(spec,), device=device)
    else:
        outs = [program.run(0, spec)]
    lead = outs[0]
    g, params0 = lead.pop("inputs")

    # the reference, after the program's state is freed
    dev = torch.device(device if device != "cuda" else "cuda:0")
    ref = check.reference_readings(cfg, mix, g, params0, seed,
                                   program.CHECK_STEPS, dev)
    del g, params0
    gc.collect()
    numbers = check.compare(lead["check"], ref)
    limits = c["limits"]
    correct = check.verdict(numbers, limits)

    device_info = {"platform": "gpu" if device.startswith("cuda") else "cpu",
                   "kind": lead["device_kind"], "count": ranks,
                   "memory_peak_bytes": max(o["memory_peak_bytes"]
                                            for o in outs)}
    result = {"correct": bool(correct), "attempted": lead["steps"],
              "failed": max(o["failed"] for o in outs)}
    if trace:
        metrics = {m["name"]: {"value": lead["per_layer"][m["name"]],
                               "unit": m["unit"]}
                   for m in c["per_layer"] if m["name"] in lead["per_layer"]}
        device_info["busy_s"] = sum(o["busy_s"] for o in outs) / len(outs)
        device_info["window_s"] = lead["window_s"]
    else:
        ctx = SimpleNamespace(
            steps=lead["steps"], window_s=max(o["window_s"] for o in outs),
            setup_s=lead["start_wall"] - t0)
        metrics = {}
        for m in c["end_to_end"]:
            value = specs.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
    result["metrics"] = metrics
    result["device"] = device_info
    if trace:
        result["breakdown"] = lead["breakdown"]
    result["captures_in_window"] = lead["captures_in_window"]
    result["forbidden"] = sorted(set(program.loaded_forbidden()).union(
        *(o["forbidden"] for o in outs)))
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                        for k in check.NAMES}
    return result


def report(result: dict) -> int:
    """Prints the run's result line, and each compared number beside its
    limit as the last lines on standard error; prints no result and
    returns 3 where a process of the run loaded JAX or the JAX
    package."""
    bad = result.pop("forbidden")
    if bad:
        print(f"bench_h100: the run loaded {bad}", file=sys.stderr)
        return 3
    captured = result.pop("captures_in_window")
    if captured:
        print(f"bench_h100: {captured} step(s) captured inside the window",
              file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']:.6e} (limit {v['limit']:.3e})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


def main(workload: str, seed: int, seconds: float, trace: int,
         t0: float) -> int:
    import torch
    bench = specs.load_benchmark()
    chips = {c["name"]: c for c in bench["workloads"]}[workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench_h100: {workload} needs {chips} CUDA card(s); this "
              f"host has {have}", file=sys.stderr)
        return 2
    return report(run_cell(workload, seed, seconds, bool(trace), "cuda", t0,
                           bench=bench))

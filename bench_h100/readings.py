"""The readings that the correctness limits are set from, on the chip at
a cell's own size, many seeds in one process (one process a card):

    python3 bench_h100/readings.py --workload <cell> --seeds 1,2,3 \\
        --what program [--fault F]  # the program's first steps, then
                                    # the reference
    python3 bench_h100/readings.py --workload <cell> --seeds 1,2,3 \\
        --what control      # the reference in TF32, and with half the batch
    python3 bench_h100/readings.py --workload <cell> --seeds 1,2,3 \\
        --what noise        # the float32 reference run again

Each seed prints one JSON line: the compared numbers (``check.NAMES``) of
the program against the float32 reference, or of the controls (the
reference with TF32 on in the program's place; the reference with every
second labelled node left out of the loss), or of a second run of the
reference (its own run-to-run noise: its sums use atomics) against it;
``worst`` names the leaf behind each gap of norms, with its gap, its
reference norm and the median leaf's. A step that
leaves the state unchanged reads 1 on ``grad1_rel`` and ``change_rel``
by the measure itself and needs no run."""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def rank_sweep(rank: int, spec: dict, seeds: list) -> list:
    from bench_h100 import program
    return [program.run(rank, {**spec, "seed": s})["check"] for s in seeds]


def worst(prog: dict, ref: dict) -> dict:
    import numpy as np
    out = {}
    for key in ("grad1", "change"):
        r = ref[key]
        med = float(np.median(list(r.values())))
        gaps = {k: abs(prog[key][k] - v) / max(v, med, 1e-30)
                for k, v in r.items()}
        k = max(gaps, key=gaps.get)
        out[key] = [k, gaps[k], r[k], med]
    return out


def main() -> int:
    import argparse
    import json
    import time
    import torch
    from bench_h100 import check, program, spec as specs
    from bench_h100.data import make_graph
    from bench_h100.reference.train import make_params
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--what", choices=("program", "control", "noise"),
                    required=True)
    ap.add_argument("--fault", default=None,
                    help="a fault of bench_h100/faults.py planted in the "
                    "program (with --what program)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    c = specs.load_cell(specs.load_benchmark(), args.workload)
    cfg, mix = c["cfg"], c["mix"]
    dev = torch.device(args.device if args.device != "cuda" else "cuda:0")
    spec = {"cfg": cfg, "mix": mix, "seconds": 0.0, "trace": False,
            "device": args.device, "fault": args.fault, "per_layer": [],
            "check_only": True}
    progs = None
    if args.what == "program":
        ranks = int(mix.get("ranks", 1))
        if ranks > 1:
            from repro_torch.launch.ranks import launch
            progs = launch(rank_sweep, ranks, args=(spec, seeds),
                           device=args.device)[0]
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        if args.what == "program":
            prog = (progs[i] if progs is not None
                    else program.run(0, {**spec, "seed": seed})["check"])
        g = make_graph(cfg, mix, seed, dev)
        params0 = {k: v.cpu() for k, v in make_params(cfg, seed, dev).items()}
        graphs = check.step_graphs(mix, g, seed, program.CHECK_STEPS)
        ref = check.reference_readings(cfg, mix, g, params0, seed,
                                       program.CHECK_STEPS, dev,
                                       graphs=graphs)
        if args.what == "program":
            others = {args.fault or "program": prog}
        else:
            kinds = ({"tf32": {"tf32": True},
                      "half_batch": {"half_batch": True}}
                     if args.what == "control" else {"noise": {}})
            others = {name: check.reference_readings(
                cfg, mix, g, params0, seed, program.CHECK_STEPS, dev,
                graphs=graphs, **kw) for name, kw in kinds.items()}
        rows = {name: {**check.compare(o, ref), "worst": worst(o, ref)}
                for name, o in others.items()}
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": round(time.perf_counter() - t, 2),
                          **rows}), flush=True)
        del g, params0, graphs
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The GNN training entry point (the counterpart of the ``gnn`` subcommand
of ``repro/launch/train.py``), on the card unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.train gnn \\
        --dataset alipay_like --model gat_e --hidden 32 --lr 5e-3 \\
        --strategy cluster --compact --halo-hops 1 --steps 200

Flags whose machinery is not ported yet are refused with a message that
names the ROADMAP item: the distributed engine (A.9), the process
prefetch pool, the fault-tolerance group and checkpoints (A.8). The
``lm`` subcommand waits for the LM zoo (A.12).
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gnn")
    g.add_argument("--dataset", default="cora")
    g.add_argument("--model", default="gcn",
                   choices=["gcn", "sage", "gat", "gat_e"])
    g.add_argument("--strategy", default="global",
                   choices=["global", "mini", "cluster"])
    g.add_argument("--steps", type=int, default=100)
    g.add_argument("--hidden", type=int, default=64)
    g.add_argument("--layers", type=int, default=2)
    g.add_argument("--lr", type=float, default=1e-2)
    g.add_argument("--compact", action="store_true",
                   help="compact sampled-subgraph views for mini/cluster "
                        "(required until the dense views are ported, "
                        "ROADMAP A.7)")
    g.add_argument("--halo-hops", type=int, default=0,
                   help="cluster strategy: boundary halo hops")
    g.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    refused = g.add_argument_group(
        "not ported yet", "accepted for the reference's command lines and "
        "refused with the ROADMAP item that ports them")
    refused.add_argument("--engine-partitions", type=int, default=0,
                         help="the distributed engine (ROADMAP A.9)")
    refused.add_argument("--prefetch-workers", type=int, default=None,
                         help="more than one builder thread (ROADMAP A.8)")
    refused.add_argument("--prefetch-mode", default="thread",
                         choices=["thread", "process"],
                         help="sampler processes (ROADMAP A.8)")
    for flag in ("--fault-retries", "--fault-backoff", "--on-divergence",
                 "--step-timeout", "--checkpoint-dir", "--checkpoint-every",
                 "--keep-checkpoints"):
        refused.add_argument(flag, default=None,
                             help="the fault-tolerant runtime (ROADMAP A.8)")
    for flag in ("--check-finite", "--resume"):
        refused.add_argument(flag, action="store_true",
                             help="the fault-tolerant runtime (ROADMAP A.8)")
    sub.add_parser("lm", help="not ported yet (ROADMAP A.12)")
    args = ap.parse_args(argv)

    if args.cmd == "lm":
        ap.exit(2, "lm: the LM zoo is not ported yet (ROADMAP A.12)\n")
    if args.engine_partitions:
        ap.exit(2, "--engine-partitions: the distributed engine is not "
                   "ported yet (ROADMAP A.9)\n")
    runtime = [f"--{k.replace('_', '-')}" for k in (
        "fault_retries", "fault_backoff", "on_divergence", "step_timeout",
        "checkpoint_dir", "checkpoint_every", "keep_checkpoints")
        if getattr(args, k) is not None]
    runtime += [f for f, on in (("--check-finite", args.check_finite),
                                ("--resume", args.resume)) if on]
    if args.prefetch_mode != "thread":
        runtime.append("--prefetch-mode")
    if (args.prefetch_workers or 0) > 1:
        runtime.append("--prefetch-workers")
    if runtime:
        ap.exit(2, f"{' '.join(runtime)}: the fault-tolerant runtime, "
                   "prefetch pools and checkpoints are not ported yet "
                   "(ROADMAP A.8)\n")

    import repro_torch.api as api
    result = api.train(api.TrainJob(
        dataset=args.dataset, model=args.model, strategy=args.strategy,
        steps=args.steps, num_layers=args.layers, hidden=args.hidden,
        lr=args.lr, compact=args.compact, halo_hops=args.halo_hops,
        device=args.device))
    print(f"[{result.trainer.device}] final test acc: "
          f"{result.final_acc:.4f} ({result.wall_s:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

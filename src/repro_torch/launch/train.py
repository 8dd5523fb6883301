"""The GNN training entry point (the counterpart of the ``gnn`` subcommand
of ``repro/launch/train.py``), on the card unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.train gnn \\
        --dataset alipay_like --model gat_e --hidden 32 --lr 5e-3 \\
        --strategy cluster --compact --halo-hops 1 --steps 200 \\
        --prefetch-mode process --checkpoint-dir ck --checkpoint-every 50

SIGINT and SIGTERM during training stop it after the step in flight,
save a checkpoint (with ``--checkpoint-dir``), retire the prefetch pool
and exit with 128 + the signal's number; ``--resume`` picks the run back
up. ``--engine-partitions P`` trains with the distributed engine over P
partitions of the graph (``--partition-method``), all on the one device.
The ``lm`` subcommand waits for the LM zoo (ROADMAP A.12).
"""
from __future__ import annotations

import argparse
import contextlib
import signal
import sys


def fault_policy_from(args):
    """The :class:`~repro_torch.runtime.FaultPolicy` the fault-tolerance
    flags ask for, or None when none is given (no runtime), by the
    reference's rule. ``--keep-checkpoints`` makes no policy: the job
    carries the retention itself."""
    flags = (args.fault_retries, args.fault_backoff, args.on_divergence,
             args.step_timeout)
    if not args.check_finite and all(f is None for f in flags):
        return None
    from repro_torch.runtime import FaultPolicy
    kw = {"check_finite": args.check_finite,
          "keep_checkpoints": args.keep_checkpoints}
    if args.fault_retries is not None:
        kw["max_retries"] = args.fault_retries
    if args.fault_backoff is not None:
        kw["backoff_base"] = args.fault_backoff
    if args.on_divergence is not None:
        kw["on_divergence"] = args.on_divergence
    if args.step_timeout is not None:
        kw["timeouts"] = {"step": args.step_timeout}
    return FaultPolicy(**kw)


@contextlib.contextmanager
def stop_between_steps_on_signals():
    """SIGINT/SIGTERM inside the block ask ``fit`` to stop at its next
    step boundary (:func:`~repro_torch.runtime.faults.request_interrupt`):
    it raises ``TrainingInterrupted`` there, its ``finally`` retires the
    prefetch pool (no orphaned sampler processes) and ``api.train`` saves
    a checkpoint of a whole step. A second signal before the boundary
    raises ``KeyboardInterrupt`` at once and saves nothing."""
    from repro_torch.runtime.faults import request_interrupt, take_interrupt

    def _interrupt(signum, frame):
        if not request_interrupt(signum):
            raise KeyboardInterrupt

    previous = {s: signal.signal(s, _interrupt)
                for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        yield
    finally:
        for s, h in previous.items():
            signal.signal(s, h)
        take_interrupt()   # a request that came after the last step


def add_runtime_flags(ap) -> None:
    """The view pool's and the fault-tolerant runtime's flags, read by
    :func:`fault_policy_from` and passed to ``fit`` (this CLI's and the
    distributed example's)."""
    ap.add_argument("--prefetch-workers", type=int, default=None,
                    help="view builders (default: min(4, cores-1); the "
                         "trajectory is the same for any count)")
    ap.add_argument("--prefetch-mode", default="thread",
                    choices=["thread", "process"],
                    help="view construction pool: in-process threads "
                         "(default) or supervised sampler processes over "
                         "shared memory (the same trajectory; degrades to "
                         "threads with a warning where shared memory is "
                         "unavailable)")
    ft = ap.add_argument_group(
        "fault tolerance",
        "the supervised training runtime (repro_torch.runtime): retries "
        "with capped exponential backoff, divergence recovery, "
        "checksummed checkpoints. Off by default; any flag here but "
        "--checkpoint-dir, --checkpoint-every, --keep-checkpoints and "
        "--resume turns it on.")
    ft.add_argument("--fault-retries", type=int, default=None, metavar="N",
                    help="retry transient view-build / staging / step / "
                         "checkpoint failures up to N times (policy "
                         "default: 3)")
    ft.add_argument("--fault-backoff", type=float, default=None,
                    metavar="SECONDS",
                    help="backoff before the first retry; grows "
                         "exponentially with deterministic jitter "
                         "(default 0.05 s, capped at 2 s)")
    ft.add_argument("--on-divergence", default=None,
                    choices=["raise", "skip_view", "rollback"],
                    help="reaction to a non-finite loss: raise (default), "
                         "skip_view (undo the poison update and move on) "
                         "or rollback (restore the last valid checkpoint "
                         "and continue past the poison view)")
    ft.add_argument("--check-finite", action="store_true",
                    help="read and guard every step's loss (serialises "
                         "host and device; implied by a non-raise "
                         "--on-divergence)")
    ft.add_argument("--step-timeout", type=float, default=None,
                    metavar="SECONDS",
                    help="watchdog: fail if a step's loss is not available "
                         "within this many seconds")
    ft.add_argument("--checkpoint-dir", default=None,
                    help="directory for step_<N>.npz checkpoints (atomic, "
                         "checksummed, loadable by the JAX package; "
                         "needed by --on-divergence rollback)")
    ft.add_argument("--checkpoint-every", type=int, default=0,
                    metavar="STEPS",
                    help="save a checkpoint every N steps (0 = never)")
    ft.add_argument("--resume", action="store_true",
                    help="resume from the newest valid checkpoint in "
                         "--checkpoint-dir (corrupt files are skipped); a "
                         "fresh start if there is none")
    ft.add_argument("--keep-checkpoints", type=int, default=0, metavar="K",
                    help="keep only the newest K checkpoints (0 = all)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("gnn")
    g.add_argument("--dataset", default="cora")
    g.add_argument("--model", default="gcn",
                   choices=["gcn", "sage", "sage_max", "gat", "gat_e"])
    g.add_argument("--strategy", default="global",
                   choices=["global", "mini", "cluster"])
    g.add_argument("--steps", type=int, default=100)
    g.add_argument("--hidden", type=int, default=64)
    g.add_argument("--layers", type=int, default=2)
    g.add_argument("--lr", type=float, default=1e-2)
    g.add_argument("--compact", action="store_true",
                   help="compact sampled-subgraph views for mini/cluster "
                        "(default: dense mask views over the whole graph)")
    g.add_argument("--halo-hops", type=int, default=0,
                   help="cluster strategy: boundary halo hops")
    g.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    g.add_argument("--engine-partitions", type=int, default=0,
                   help="train with the hybrid-parallel engine over this "
                        "many partitions of the graph, all in this "
                        "process on the one device (0 = the bucketed "
                        "single-block trainer)")
    g.add_argument("--partition-method", default="1d_src",
                   choices=["1d_src", "1d_dst", "vertex_cut"],
                   help="how the engine assigns edges to partitions")
    add_runtime_flags(g)
    sub.add_parser("lm", help="not ported yet (ROADMAP A.12)")
    args = ap.parse_args(argv)

    if args.cmd == "lm":
        ap.exit(2, "lm: the LM zoo is not ported yet (ROADMAP A.12)\n")

    import repro_torch.api as api
    from repro_torch.runtime.faults import TrainingInterrupted
    job = api.TrainJob(
        dataset=args.dataset, model=args.model, strategy=args.strategy,
        steps=args.steps, num_layers=args.layers, hidden=args.hidden,
        lr=args.lr, compact=args.compact, halo_hops=args.halo_hops,
        engine_partitions=args.engine_partitions,
        partition_method=args.partition_method,
        device=args.device, prefetch_workers=args.prefetch_workers,
        prefetch_mode=args.prefetch_mode,
        fault_policy=fault_policy_from(args),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        keep_checkpoints=args.keep_checkpoints, resume=args.resume)

    try:
        with stop_between_steps_on_signals():
            result = api.train(job)
    except TrainingInterrupted as e:
        where = (f"checkpoint saved to {args.checkpoint_dir}"
                 if args.checkpoint_dir else
                 "no --checkpoint-dir, progress discarded")
        print(f"interrupted by signal {e.signum} — {where}", file=sys.stderr)
        return 128 + e.signum
    print(f"[{result.trainer.device}] final test acc: "
          f"{result.final_acc:.4f} at step {result.trainer.step_num} "
          f"({result.wall_s:.1f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

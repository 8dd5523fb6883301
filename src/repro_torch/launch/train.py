"""The training entry points (the counterpart of
``repro/launch/train.py``): GNNs, and the LM zoo's reduced models, on
the card unless ``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.train gnn \\
        --dataset alipay_like --model gat_e --hidden 32 --lr 5e-3 \\
        --strategy cluster --compact --halo-hops 1 --steps 200 \\
        --prefetch-mode process --checkpoint-dir ck --checkpoint-every 50

SIGINT and SIGTERM during training stop it after the step in flight,
save a checkpoint (with ``--checkpoint-dir``), retire the prefetch pool
and exit with 128 + the signal's number; ``--resume`` picks the run back
up. ``--engine-partitions P`` trains with the distributed engine over P
partitions of the graph (``--partition-method``), all on the one device;
with ``--ranks R`` over R processes, ``P // R`` partitions each, one a
card (NCCL; the host must have R cards) or over gloo with ``--device
cpu`` (:mod:`repro_torch.launch.ranks`)::

    PYTHONPATH=src python -m repro_torch.launch.train gnn --dataset cora \
        --engine-partitions 4 --ranks 4 --steps 10 --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train lm --arch qwen2-vl-2b \
        --steps 50 --batch 8 --seq 128

``lm`` trains the reference's reduced config of ``--arch`` (float32, the
vocabulary capped at 1,024) on its synthetic token stream with AdamW
under a warmup-cosine schedule, as the reference's ``train_lm``, and
prints ``final loss: ...``. The model's loss is the plain PyTorch path
under autograd; the forward-only kernels serve, and refuse to be
trained through. ``train_gnn`` is the reference's deprecated Python
shim over :func:`repro_torch.api.train`, with its keywords and return
dict.
"""
from __future__ import annotations

import argparse
import contextlib
import signal
import sys
import time
from typing import Mapping, Optional

from repro_torch.utils.logging import get_logger

log = get_logger("train")


def train_gnn(dataset: str, model_name: str, strategy: str, steps: int,
              hidden: int = 64, lr: float = 1e-2, seed: int = 0,
              num_layers: int = 2, eval_every: int = 20,
              use_engine: Optional[int] = None,
              partition_method: str = "1d_src",
              prefetch_workers: Optional[int] = None,
              prefetch_mode: str = "thread",
              compact: bool = False, fault_policy=None,
              checkpoint_dir: Optional[str] = None,
              checkpoint_every: int = 0, resume: bool = False,
              device: Optional[str] = None) -> dict:
    """Deprecated shim, kept for the reference's keyword set and return
    dict (``repro/launch/train.py:35``): build a
    :class:`repro_torch.api.TrainJob` and call :func:`repro_torch.api.train`
    instead. Runs on ``device``, the card unless the caller asks for
    ``"cpu"``. Returns ``history``, ``wall_s``, ``params``, ``final_acc``,
    ``model`` and ``graph`` (``TrainResult.as_dict``)."""
    import repro_torch.api as api
    job = api.TrainJob(
        dataset=dataset, model=model_name, strategy=strategy, steps=steps,
        hidden=hidden, lr=lr, seed=seed, num_layers=num_layers,
        eval_every=eval_every, engine_partitions=use_engine or 0,
        partition_method=partition_method,
        prefetch_workers=prefetch_workers, prefetch_mode=prefetch_mode,
        compact=compact, fault_policy=fault_policy,
        checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
        resume=resume, device=device)
    return api.train(job, log=log.info).as_dict()


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


def train_lm(arch: str, steps: int, batch: int, seq: int,
             reduced: bool = True, lr: float = 3e-4, seed: int = 0,
             log_every: int = 10, checkpoint_dir: Optional[str] = None,
             vocab_cap: int = 1024, device=None,
             state_dict: Optional[Mapping] = None) -> dict:
    """The reference's ``train_lm`` (``repro/launch/train.py:63``) on
    ``device`` (the card unless ``"cpu"``): the reduced config in float32
    with the vocabulary capped at ``vocab_cap``, ``remat`` off when
    reduced, AdamW under ``warmup_cosine_schedule(lr, max(10, steps //
    20), steps)``, the loss in chunks of ``min(LOSS_CHUNK, seq)``. The
    stub inputs are the reference's: ``embeds`` the current table looked
    up at the tokens (a constant input: no gradient flows through it),
    three equal ``mrope_positions`` streams, and ``enc_frames`` drawn
    from one ``default_rng(seed)`` step after step. The weights are
    drawn from ``seed`` on the device, or loaded from ``state_dict``
    (the JAX package's through ``lm_params_from_jax``). Returns the
    logged ``history``, every step's loss (``losses``), ``final_loss``,
    ``wall_s``, ``model`` and ``cfg``."""
    import numpy as np
    import torch
    from repro_torch.arch import build_model
    from repro_torch.arch.model import LOSS_CHUNK
    from repro_torch.config import get_arch_config
    from repro_torch.data import SyntheticLMDataset
    from repro_torch.device import resolve_device
    from repro_torch.launch.microbatch import microbatched_value_and_grad
    from repro_torch.optim import adamw, warmup_cosine_schedule

    dev = resolve_device(device)
    cfg = get_arch_config(arch)
    if reduced:
        cfg = cfg.reduced().replace(dtype="float32",
                                    vocab_size=min(cfg.reduced().vocab_size,
                                                   vocab_cap))
    model = build_model(cfg, torch.Generator(device=dev).manual_seed(seed),
                        remat=not reduced)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    params = dict(model.named_parameters())
    opt = adamw(warmup_cosine_schedule(lr, max(10, steps // 20), steps))
    opt_state = opt.init(params)
    ds = SyntheticLMDataset(cfg.vocab_size, seq, batch, seed=seed)
    rng = np.random.default_rng(seed)
    chunk = min(LOSS_CHUNK, seq)
    value_and_grad = microbatched_value_and_grad(
        lambda b: model.loss(b, chunk=chunk), 1)

    def make_batch(i):
        b = ds.batch(i)
        out = {k: torch.from_numpy(b[k]).long().to(dev)
               for k in ("tokens", "labels")}
        if cfg.embed_inputs:
            # the stub frontend embeds through the current table
            with torch.no_grad():
                out["embeds"] = model.embed["table"][out["tokens"]]
        if cfg.mrope:
            out["mrope_positions"] = torch.arange(
                seq, dtype=torch.int32, device=dev).expand(3, batch, seq)
        if cfg.encoder_layers:
            out["enc_frames"] = torch.from_numpy(rng.normal(
                size=(batch, cfg.encoder_seq, cfg.d_model)).astype(
                    np.float32)).to(dev)
        return out

    history, losses = [], []
    t0 = time.perf_counter()
    for i in range(steps):
        loss, grads = value_and_grad(params, make_batch(i))
        opt.update(grads, opt_state, params)
        losses.append(loss)
        if i % log_every == 0 or i == steps - 1:
            lv = float(loss)
            history.append({"step": i, "loss": lv})
            log.info("arch=%s step=%d loss=%.4f", arch, i, lv)
    losses = [float(x) for x in torch.stack(losses).cpu()]
    wall = time.perf_counter() - t0
    if checkpoint_dir:
        from repro_torch.checkpoint import save_checkpoint
        from repro_torch.weights import params_to_jax
        save_checkpoint(checkpoint_dir, steps,
                        {"params": params_to_jax(model.state_dict())})
    return {"history": history, "losses": losses, "wall_s": wall,
            "final_loss": history[-1]["loss"], "model": model, "cfg": cfg}


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
    g.add_argument("--ranks", type=int, default=1,
                   help="spread the engine's partitions over this many "
                        "processes, one a card (gloo processes with "
                        "--device cpu); P must be a multiple")
    g.add_argument("--partition-method", default="1d_src",
                   choices=["1d_src", "1d_dst", "vertex_cut"],
                   help="how the engine assigns edges to partitions")
    add_runtime_flags(g)
    lm = sub.add_parser("lm", help="train a reduced LM of the zoo")
    lm.add_argument("--arch", required=True)
    lm.add_argument("--steps", type=int, default=50)
    lm.add_argument("--batch", type=int, default=8)
    lm.add_argument("--seq", type=int, default=128)
    lm.add_argument("--reduced", action="store_true", default=True,
                    help="the reference's reduced config (always on, as "
                    "the reference's flag)")
    lm.add_argument("--checkpoint-dir", default=None)
    lm.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    if args.cmd == "lm":
        out = train_lm(args.arch, args.steps, args.batch, args.seq,
                       reduced=args.reduced,
                       checkpoint_dir=args.checkpoint_dir,
                       device=args.device)
        print(f"[{out['model'].device}] final loss: "
              f"{out['final_loss']:.4f} ({out['wall_s']:.1f}s)")
        return 0

    import repro_torch.api as api
    from repro_torch.core.comm import check_ranks
    from repro_torch.runtime.faults import TrainingInterrupted
    if args.ranks != 1:
        if not args.engine_partitions:
            ap.error("--ranks spreads the engine's partitions: give "
                     "--engine-partitions P")
        try:
            check_ranks(args.engine_partitions, args.ranks)
        except ValueError as e:
            ap.error(str(e))
    job = api.TrainJob(
        dataset=args.dataset, model=args.model, strategy=args.strategy,
        steps=args.steps, num_layers=args.layers, hidden=args.hidden,
        lr=args.lr, compact=args.compact, halo_hops=args.halo_hops,
        engine_partitions=args.engine_partitions, ranks=args.ranks,
        partition_method=args.partition_method,
        device=args.device, prefetch_workers=args.prefetch_workers,
        prefetch_mode=args.prefetch_mode,
        fault_policy=fault_policy_from(args),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        keep_checkpoints=args.keep_checkpoints, resume=args.resume)

    if args.ranks > 1:
        return _train_ranks(job)
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
    print(f"final train loss: {result.history[-1]['loss']!r}")
    return 0


def train_rank(rank: int, job) -> dict:
    """One rank of ``gnn --ranks R``: ``api.train(job)`` on this rank's
    partitions; what the parent prints."""
    import repro_torch.api as api
    result = api.train(job)
    return {"final_acc": result.final_acc,
            "loss": result.history[-1]["loss"],
            "step": result.trainer.step_num, "wall_s": result.wall_s,
            "device": str(result.trainer.device),
            "captures": result.trainer.trace_counts["train_step"]}


def _train_ranks(job) -> int:
    """``gnn --ranks R``: R processes (:mod:`repro_torch.launch.ranks`),
    which must end on the same loss, bit for bit; rank 0's result is
    printed."""
    from repro_torch.launch.ranks import launch
    out = launch(train_rank, job.ranks, args=(job,),
                 device=job.device or "cuda")
    if len({repr(r["loss"]) for r in out}) != 1:
        raise RuntimeError(f"the ranks ended on different losses: "
                           f"{[r['loss'] for r in out]}")
    r0 = out[0]
    kind = r0["device"].split(":")[0]
    print(f"[{kind} x{job.ranks} ranks] final test acc: "
          f"{r0['final_acc']:.4f} at step {r0['step']} "
          f"({r0['wall_s']:.1f}s; captures per rank "
          f"{[r['captures'] for r in out]})")
    print(f"final train loss: {r0['loss']!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Fault policy, deterministic fault injection, and retry/backoff (the
port's own copy of ``repro/runtime/faults.py``: the same taxonomy, and
the same crc32 decisions, so a chaos plan means the same thing in both
packages).

The paper trains over 1,024 small-memory docker workers (§5) — a regime
where sampler stalls, transient I/O failures, OOM-killed workers, and
numerically diverged steps are routine operating conditions, not
exceptional ones. This module is the vocabulary the runtime's
supervision layer speaks:

- :class:`FaultPolicy` — how hard to try: retry counts, exponential
  backoff with a cap and **deterministic** jitter (a pure function of
  ``(seed, stage, attempt)``, so two runs of the same config back off
  identically), per-stage timeouts, and what to do when a step diverges
  (``raise | skip_view | rollback``).
- :class:`FaultInjector` — seeded, deterministic chaos. Injection
  points (view build, device staging, step execution, checkpoint
  save/load, worker kill) are **no-ops in production** (no injector =
  zero overhead) and deterministic failures under test: whether
  occurrence *n* (or keyed occurrence *i*, e.g. a view index) fires is
  a pure function of ``(seed, point, n|i)`` — independent of thread
  scheduling, so chaos runs are exactly reproducible.
- :class:`Retrier` — the retry loop every supervised stage runs
  through: inject, call, catch *transient* errors only, back off,
  re-call. Retried units are pure functions of their inputs (view i of
  ``(seed, i)``, staging of its host arrays), which is what makes the
  recovered stream bit-identical to a fault-free run — the
  trajectory-invariance contract ``tests/test_torch_runtime.py`` asserts.

Everything here is host-side Python; nothing runs on the device.
"""
from __future__ import annotations

import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Mapping, Optional


# ---------------------------------------------------------------------------
# error taxonomy
# ---------------------------------------------------------------------------


class TransientError(RuntimeError):
    """An error worth retrying: the operation is a pure function of its
    inputs and the failure is environmental (I/O flake, injected)."""


class InjectedFault(TransientError):
    """A deterministic failure raised by a :class:`FaultInjector`."""

    def __init__(self, point: str, occurrence: int):
        super().__init__(f"injected fault at {point!r} "
                         f"(occurrence {occurrence})")
        self.point = point
        self.occurrence = occurrence


class WorkerKilled(BaseException):
    """A prefetch worker was killed (injected OOM-kill stand-in).

    Deliberately *not* a :class:`TransientError` — the unit of recovery
    is the worker (respawn + requeue its claimed index), not the call.
    Subclassing BaseException keeps it out of blanket ``except
    Exception`` handlers between the injection point and the worker
    loop's supervisor.
    """

    def __init__(self, occurrence: int = 0):
        super().__init__(f"worker killed (occurrence {occurrence})")
        self.occurrence = occurrence


class FaultRetriesExceeded(RuntimeError):
    """A supervised stage failed ``max_retries + 1`` consecutive times."""


class DivergenceError(RuntimeError):
    """A non-finite loss under ``on_divergence='raise'`` (or rollback
    with no checkpoint to roll back to)."""


class StepTimeoutError(RuntimeError):
    """The step watchdog: a device step failed to produce its loss
    within the policy's ``step`` timeout."""


class PrefetchShutdownError(RuntimeError):
    """``close()`` could not retire every prefetch thread — a producer
    is stuck in non-cancellable user code (leaking it silently hides a
    hung sampler and pins its staged buffers)."""


class SlotCorruptionError(TransientError):
    """A shared-memory view slot failed its crc32/seqlock check — a torn
    or corrupted cross-process handoff. Transient by design: views are
    pure in ``(seed, i)``, so the reaction is a bit-exact rebuild."""


class TrainingInterrupted(BaseException):
    """SIGINT/SIGTERM arrived mid-``fit``. Raised by ``fit`` at the step
    boundary after a launch-CLI signal handler's
    :func:`request_interrupt`, so the fit loop unwinds through its
    ``finally`` (the
    prefetcher / process view service drains — no orphaned samplers) and
    :func:`repro_torch.api.train` can save a final checkpoint on the way out.
    A BaseException so blanket ``except Exception`` recovery paths never
    swallow an operator's ctrl-C."""

    def __init__(self, signum: int):
        super().__init__(f"training interrupted by signal {signum}")
        self.signum = int(signum)


# the signal a handler asked the running fit to stop for, if any
_interrupt_signum: Optional[int] = None


def request_interrupt(signum: int) -> bool:
    """Ask the running ``fit`` to raise :class:`TrainingInterrupted` at
    its next step boundary (the training CLI's signal handlers call it).
    The optimizer updates parameters and moments in place, one at a
    time, so an exception raised where the signal lands could leave a
    step half applied for the checkpoint to save. Returns False when a
    request is already pending."""
    global _interrupt_signum
    if _interrupt_signum is not None:
        return False
    _interrupt_signum = int(signum)
    return True


def take_interrupt() -> Optional[int]:
    """The pending request's signal number, clearing it (None if
    none)."""
    global _interrupt_signum
    signum, _interrupt_signum = _interrupt_signum, None
    return signum


# retried by Retrier; everything else propagates immediately.
# OSError covers real transient I/O (checkpoint writes on flaky disks).
RETRYABLE = (TransientError, OSError)


# ---------------------------------------------------------------------------
# policy
# ---------------------------------------------------------------------------


def _unit_hash(*parts) -> float:
    """Deterministic uniform-ish [0, 1) from arbitrary parts (crc32 —
    stable across processes, unlike ``hash``)."""
    key = ":".join(str(p) for p in parts).encode()
    return (zlib.crc32(key) % 2**31) / 2**31


@dataclass(frozen=True)
class FaultPolicy:
    """How the runtime reacts to faults. The default is production-lean:
    a few retries with sub-second capped backoff, no per-step finite
    check (it serializes the loss sync), divergence raises."""

    max_retries: int = 3            # per stage call, on RETRYABLE errors
    backoff_base: float = 0.05     # seconds before retry 1
    backoff_factor: float = 2.0    # exponential growth per attempt
    backoff_cap: float = 2.0       # seconds, growth ceiling
    jitter: float = 0.1            # +/- fraction, deterministic
    seed: int = 0                  # jitter stream seed
    # per-stage timeouts in seconds: {"view_build": ..., "step": ...};
    # absent stage = no watchdog for it
    timeouts: Mapping[str, float] = field(default_factory=dict)
    on_divergence: str = "raise"   # raise | skip_view | rollback
    check_finite: bool = False     # sync + guard every step's loss
    max_worker_respawns: int = 8   # dead prefetch workers respawned
    keep_checkpoints: int = 0      # retention (0 = keep all)
    # process-pool sampler supervision (repro_torch.runtime.procpool): a
    # worker process whose heartbeat AND claimed build are both older
    # than worker_heartbeat_s is declared hung (terminate -> kill ->
    # respawn + requeue); max_proc_respawns caps total process respawns
    # before the pool aborts with FaultRetriesExceeded
    worker_heartbeat_s: float = 10.0
    max_proc_respawns: int = 8

    def __post_init__(self):
        if self.on_divergence not in ("raise", "skip_view", "rollback"):
            raise ValueError(
                f"on_divergence={self.on_divergence!r} — expected "
                "'raise', 'skip_view' or 'rollback'")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")

    def timeout(self, stage: str) -> Optional[float]:
        return self.timeouts.get(stage)

    def delay(self, stage: str, attempt: int) -> float:
        """Backoff before retry ``attempt`` (0-based): exponential with
        cap, +/- ``jitter`` fraction derived deterministically from
        ``(seed, stage, attempt)`` — reproducible, yet de-synchronized
        across stages/workers hammering one resource."""
        d = min(self.backoff_cap,
                self.backoff_base * self.backoff_factor ** attempt)
        u = _unit_hash(self.seed, stage, attempt)
        return max(0.0, d * (1.0 + self.jitter * (2.0 * u - 1.0)))


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------


class FaultInjector:
    """Seeded, deterministic chaos for the runtime's injection points.

    ``plan`` maps an injection point to *when it fires*:

    - a collection of occurrence indices: ``{"view_build": {2, 5}}``
      fires the 3rd and 6th invocation (or keyed occurrences 2 and 5
      when the call site passes ``key=``, e.g. the view index);
    - a float rate in (0, 1): occurrence *n* fires iff
      ``crc32(seed, point, n)`` maps under the rate — a pure function,
      so two runs (and any thread interleaving, for keyed sites) fire
      identically.

    Production code paths take ``injector=None`` and skip every check;
    a configured injector raises :class:`InjectedFault` (transient,
    retried) except at ``worker_kill``, which raises
    :class:`WorkerKilled` (supervised: respawn + requeue). ``fired``
    records every hit for test assertions ("the fault actually
    happened").
    """

    POINTS = ("view_build", "device_put", "step", "checkpoint_save",
              "checkpoint_load", "worker_kill", "diverge", "view_hang",
              # process-level points (repro_torch.runtime.procpool): SIGKILL a
              # sampler process mid-build, stall one without heartbeats,
              # flip payload bytes in a shared-memory slot behind the
              # trainer's back. Thread-mode prefetch maps them to its
              # closest in-process analogs so one chaos plan covers both
              # prefetch modes.
              "proc_kill", "proc_hang", "slot_corrupt")

    def __init__(self, plan: Optional[Mapping] = None, seed: int = 0,
                 hang_seconds: float = 30.0):
        self.seed = int(seed)
        self.hang_seconds = float(hang_seconds)
        self.plan: Dict[str, object] = {}
        for point, spec in (plan or {}).items():
            if point not in self.POINTS:
                raise ValueError(
                    f"unknown injection point {point!r} "
                    f"(expected one of {self.POINTS})")
            if isinstance(spec, float):
                if not 0.0 < spec < 1.0:
                    raise ValueError(
                        f"rate for {point!r} must be in (0, 1)")
                self.plan[point] = spec
            else:
                self.plan[point] = frozenset(int(i) for i in spec)
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}
        self.fired: Dict[str, List[int]] = {}

    def _occurrence(self, point: str, key: Optional[int]) -> int:
        if key is not None:
            return int(key)
        with self._lock:
            n = self._counts.get(point, 0)
            self._counts[point] = n + 1
        return n

    def fires(self, point: str, key: Optional[int] = None) -> bool:
        """Whether this occurrence of ``point`` fails. Pass ``key`` (a
        view index, step number, ...) wherever one exists: keyed
        decisions are independent of thread scheduling."""
        spec = self.plan.get(point)
        if spec is None:
            return False
        n = self._occurrence(point, key)
        if isinstance(spec, float):
            hit = _unit_hash(self.seed, point, n) < spec
        else:
            hit = n in spec
        if hit:
            with self._lock:
                self.fired.setdefault(point, []).append(n)
        return hit

    def maybe_fail(self, point: str, key: Optional[int] = None) -> None:
        """Raise at ``point`` if the plan says this occurrence fails."""
        if not self.plan:
            return
        if self.fires(point, key=key):
            n = int(key) if key is not None \
                else self._counts.get(point, 1) - 1
            if point in ("worker_kill", "proc_kill"):
                # thread-mode analog of SIGKILL: the supervised pool
                # requeues the claim and respawns the worker
                raise WorkerKilled(n)
            if point == "slot_corrupt":
                # thread-mode analog of a torn shm handoff: transient,
                # so the retrier rebuilds the (pure) view bit-exactly
                raise SlotCorruptionError(
                    f"injected slot corruption for view {n}")
            raise InjectedFault(point, n)

    def maybe_hang(self, point: str, key: Optional[int],
                   seconds: float, wait: Callable[[float], object]
                   ) -> bool:
        """Stall at ``point`` for ``seconds`` via ``wait`` (a
        *cancellable* waiter, e.g. ``Event.wait`` — an injected hang
        must never survive ``close()``). Returns whether it fired."""
        if self.fires(point, key=key):
            wait(seconds)
            return True
        return False

    def total_fired(self) -> int:
        return sum(len(v) for v in self.fired.values())


# ---------------------------------------------------------------------------
# retry loop
# ---------------------------------------------------------------------------


class Retrier:
    """``retrier(stage, fn)``: inject → call → retry transients with the
    policy's backoff. One instance is shared by the trainer and its
    prefetch workers (it is stateless apart from the event log, which is
    lock-guarded)."""

    def __init__(self, policy: FaultPolicy,
                 injector: Optional[FaultInjector] = None,
                 sleep: Callable[[float], None] = time.sleep):
        self.policy = policy
        self.injector = injector
        self._sleep = sleep
        self._lock = threading.Lock()
        self.events: List[dict] = []   # every retry, for observability

    def _record(self, stage: str, attempt: int, err: BaseException):
        with self._lock:
            self.events.append({"stage": stage, "attempt": attempt,
                                "error": f"{type(err).__name__}: {err}"})

    def __call__(self, stage: str, fn: Callable, key: Optional[int] = None,
                 label: str = ""):
        last: Optional[BaseException] = None
        for attempt in range(self.policy.max_retries + 1):
            try:
                if self.injector is not None:
                    # re-injecting on retries would loop keyed plans
                    # forever; a keyed occurrence fails exactly once
                    if attempt == 0 or key is None:
                        self.injector.maybe_fail(stage, key=key)
                return fn()
            except RETRYABLE as e:
                last = e
                self._record(stage, attempt, e)
                if attempt < self.policy.max_retries:
                    self._sleep(self.policy.delay(stage, attempt))
        raise FaultRetriesExceeded(
            f"stage {stage!r}{f' ({label})' if label else ''} failed "
            f"{self.policy.max_retries + 1} consecutive attempts; "
            f"last error: {type(last).__name__}: {last}") from last


def sync_with_timeout(pull: Callable[[], float],
                      timeout: Optional[float]) -> float:
    """The step watchdog: run ``pull`` (typically ``float(loss)``, which
    blocks on the device) and raise :class:`StepTimeoutError` if it does
    not complete within ``timeout`` seconds. A device computation cannot
    be cancelled from Python, so the puller runs on a daemon thread and
    is abandoned on timeout — the point is to fail the fit loudly with a
    diagnosable error instead of hanging the whole job."""
    if timeout is None:
        return pull()
    box: dict = {}
    done = threading.Event()

    def run():
        try:
            box["value"] = pull()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e
        finally:
            done.set()

    t = threading.Thread(target=run, daemon=True, name="step-watchdog")
    t.start()
    if not done.wait(timeout):
        raise StepTimeoutError(
            f"device step did not produce its loss within {timeout}s "
            "(watchdog 'step' timeout) — the step is hung or the "
            "timeout is too tight for this graph/model")
    if "error" in box:
        raise box["error"]
    return box["value"]

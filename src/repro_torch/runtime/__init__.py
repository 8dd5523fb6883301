"""Fault-tolerant training runtime: supervision, retry, and recovery (the
counterpart of ``repro/runtime``).

The layer between the trainer and everything that can fail — view
construction, device staging, step execution, checkpoint I/O. See
:mod:`repro_torch.runtime.faults` (policy / injection / retry),
:mod:`repro_torch.runtime.prefetch` (supervised in-process prefetch),
:mod:`repro_torch.runtime.procpool` (supervised sampler *processes* over
shared-memory view slots), and ``python -m repro_torch.runtime.chaos``
(the chaos harness).
"""
from repro_torch.runtime.faults import (DivergenceError, FaultInjector,
                                        FaultPolicy, FaultRetriesExceeded,
                                        InjectedFault, PrefetchShutdownError,
                                        Retrier, SlotCorruptionError,
                                        StepTimeoutError, TrainingInterrupted,
                                        TransientError, WorkerKilled,
                                        request_interrupt, sync_with_timeout,
                                        take_interrupt)
from repro_torch.runtime.prefetch import StreamPrefetcher, ViewPrefetcher
from repro_torch.runtime.procpool import (ProcessViewService,
                                          ProcPoolUnavailable,
                                          shared_memory_available)

__all__ = [
    "DivergenceError", "FaultInjector", "FaultPolicy",
    "FaultRetriesExceeded", "InjectedFault", "PrefetchShutdownError",
    "ProcessViewService", "ProcPoolUnavailable", "Retrier",
    "SlotCorruptionError", "StepTimeoutError", "StreamPrefetcher",
    "TrainingInterrupted", "TransientError", "ViewPrefetcher",
    "WorkerKilled", "request_interrupt", "shared_memory_available",
    "sync_with_timeout", "take_interrupt",
]

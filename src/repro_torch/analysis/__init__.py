"""Static analysis over recorded torch steps, the compiled CUDA kernels'
resources, and source (the counterpart of ``repro/analysis``).

Three analyzers share one :class:`Rule` registry and :class:`Finding`
vocabulary:

- :mod:`repro_torch.analysis.oplog`: contract rules over the aten ops one
  eager step dispatched, backward and optimizer update included
  (pre-gather / segment-scatter / backward-gather on the csc path,
  O(view) compact steps, f64 drift, host transfers, the captured step's
  static inputs);
- :mod:`repro_torch.analysis.resources`: registers, shared memory and
  spills of every compiled Hopper kernel against the H100's budget, at
  the launch shapes a step recorded;
- :mod:`repro_torch.analysis.srclint`: AST lint (bare asserts, per-step
  O(N) work in the hot view path, silent excepts, unjoined processes).

``python -m repro_torch.analysis --strict`` records the model zoo across
trainers, backends and the served steps, runs everything, and exits
nonzero on any error finding: the gate.
"""
from repro_torch.analysis.oplog import (ContractError, Finding, OpContext,
                                        OpEntry, OpLog, Rule, RULES,
                                        TensorInfo, check_or_raise,
                                        count_segment_scatters, record_ops,
                                        register, rule, run_rules)
from repro_torch.analysis.resources import (Budget, KernelStats,
                                            check_stats, library_stats,
                                            parse_max_threads,
                                            parse_resource_usage,
                                            stats_from_text)
from repro_torch.analysis.srclint import lint_file, lint_source, lint_tree

__all__ = [
    "ContractError", "Finding", "OpContext", "OpEntry", "OpLog", "Rule",
    "RULES", "TensorInfo", "check_or_raise", "count_segment_scatters",
    "record_ops", "register", "rule", "run_rules",
    "Budget", "KernelStats", "check_stats", "library_stats",
    "parse_max_threads", "parse_resource_usage", "stats_from_text",
    "lint_file", "lint_source", "lint_tree",
]

"""Rule registry over recorded torch steps: the memory and fusion
contracts of the port (the counterpart of ``repro/analysis/jaxpr.py``).

The reference walks a traced jaxpr. PyTorch has no trace that holds the
backward and the optimizer's update, so :func:`record_ops` runs one step
eagerly under a :class:`~torch.utils._python_dispatch.TorchDispatchMode`
and keeps an :class:`OpLog`: every aten op the step dispatched, with its
arguments' shapes, dtypes, devices and storages and its outputs'. The
dispatch level sees autograd's backward and the optimizer's update as
well (the mode reaches autograd's device thread with the rest of the
thread-local state), so the log is the counterpart of the VJP-spliced
jaxpr. Each kernel wrapper of :mod:`repro_torch.kernels.ops` runs in a
kernel scope: the log holds one entry per wrapper call (the counterpart
of a ``pallas_call`` equation), and the aten ops dispatched inside it
(the plain versions' gathers, on the CPU) carry the kernel's name. A
CUDA launch goes through ``ctypes`` and dispatches nothing, so on the
card the scope entry is the only trace that a kernel ran.

Rule catalog (each restates the reference rule of the same suffix):

=========================  ==================================================
``ops.pregather``          outside the kernels, no float output of an index
                           op whose index is the plan's ``perm`` (or an
                           integer tensor computed from it): a message
                           tensor laid out in plan order
``ops.segment-scatter``    outside the kernels, no ``index_add`` /
                           ``scatter_add`` / ``scatter_reduce`` /
                           accumulating ``index_put`` whose updates carry
                           the plan's edge axis: the atomic fallback
``ops.backward-gather``    outside the kernels, no ``(N, ...) -> (E, ...)``
                           index op (the old ``g[segment_ids]`` backward)
``ops.full-graph-tensor``  no float output whose leading dimension is the
                           full graph's N or E inside a compact step or a
                           served bucket (the O(view) memory claim)
``ops.f64-promotion``      no float64 output anywhere, kernel scopes
                           included
``ops.host-transfer``      no ``.item()``, data-dependent sync
                           (``nonzero``, ``masked_select``, ``unique``) or
                           copy across devices inside the step
``ops.static-inputs``      a captured step's staged inputs are loaded in
                           place into the capture's static tensors exactly
                           as often as the trainer promises
=========================  ==================================================

``cuda.resources`` (registers, shared memory and spills of the compiled
kernels) registers itself from :mod:`repro_torch.analysis.resources`;
the source lint lives in :mod:`repro_torch.analysis.srclint`.

The shims ``assert_pregather_free`` / ``assert_sum_stage_fused`` /
``count_segment_scatters`` of :mod:`repro_torch.kernels.ops` delegate
here and raise :class:`ContractError`, an ``AssertionError``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple)

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import ops


class ContractError(AssertionError):
    """A registry rule found a violation in assert-mode (the shim API)."""


# ---------------------------------------------------------------------------
# findings
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    """One rule violation: what rule, where, and what was seen."""
    rule: str                    # registry id, e.g. "ops.pregather"
    message: str                 # human-readable description of the hit
    severity: str = "error"      # "error" | "warning"
    label: str = ""              # which recorded computation was analyzed
    location: str = ""           # op/kernel/source location when known

    def render(self) -> str:
        where = f" [{self.label}]" if self.label else ""
        loc = f" ({self.location})" if self.location else ""
        return f"{self.severity}: {self.rule}{where}: {self.message}{loc}"

    def to_json(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "label": self.label, "message": self.message,
                "location": self.location}


# ---------------------------------------------------------------------------
# the op log
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TensorInfo:
    """What the rules read of one tensor: shape, dtype, device and the
    address of its storage (views of one storage share it; 0 where the
    tensor has none)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    device: str
    storage: int

    @property
    def is_float(self) -> bool:
        return self.dtype.is_floating_point


def storage_key(t: torch.Tensor) -> int:
    """The address of ``t``'s storage, shared by all its views."""
    try:
        return t.untyped_storage().data_ptr()
    except (RuntimeError, NotImplementedError):
        return 0


def tensor_info(t: torch.Tensor) -> TensorInfo:
    return TensorInfo(tuple(t.shape), t.dtype, str(t.device), storage_key(t))


def _summarize(v):
    """An argument as the log keeps it: tensors as :class:`TensorInfo`,
    sequences element-wise, plain values as they are, anything else by
    its type's name."""
    if isinstance(v, torch.Tensor):
        return tensor_info(v)
    if isinstance(v, (list, tuple)):
        return tuple(_summarize(x) for x in v)
    if v is None or isinstance(v, (bool, int, float, str, torch.dtype,
                                   torch.device)):
        return v
    return type(v).__name__


def _tensors(v) -> Iterator[TensorInfo]:
    if isinstance(v, TensorInfo):
        yield v
    elif isinstance(v, tuple):
        for x in v:
            yield from _tensors(x)


@dataclass(frozen=True)
class OpEntry:
    """One dispatched aten op, or one kernel wrapper's call.

    ``name`` is the op's overload packet (``index_add_``) or, for a
    kernel entry, ``kernel:<name>``; ``args`` maps the schema's argument
    names to their summaries (a kernel entry: ``operands``); ``kernel``
    is the kernel scope the op ran in ("" outside every scope); ``route``
    is a kernel entry's route, ``"cpu"`` (its plain version) or
    ``"cuda"``."""
    name: str
    args: Dict[str, Any]
    outputs: Tuple[TensorInfo, ...] = ()
    kernel: str = ""
    route: str = ""

    @property
    def is_kernel(self) -> bool:
        return self.name.startswith("kernel:")

    def arg(self, name: str):
        return self.args.get(name)

    def inputs(self) -> Iterator[TensorInfo]:
        for v in self.args.values():
            yield from _tensors(v)


@dataclass
class OpLog:
    """The ops one recorded step dispatched, in order. ``static`` holds
    the storages of a captured step's input tensors, where the recorded
    step loads its staged inputs into them (else empty)."""
    entries: List[OpEntry] = field(default_factory=list)
    static: frozenset = frozenset()

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def kernels(self) -> List[OpEntry]:
        """The kernel wrappers' calls, in order."""
        return [e for e in self.entries if e.is_kernel]

    def outside_kernels(self) -> Iterator[OpEntry]:
        """The aten ops dispatched outside every kernel scope (the
        reference's walk with ``skip_pallas_bodies``)."""
        return (e for e in self.entries
                if not e.is_kernel and not e.kernel)


def _schema_args(func, args, kwargs) -> Dict[str, Any]:
    names = [a.name for a in func._schema.arguments]
    out = {}
    for i, v in enumerate(args):
        out[names[i] if i < len(names) else f"arg{i}"] = _summarize(v)
    for k, v in kwargs.items():
        out[k] = _summarize(v)
    return out


class _Recorder(TorchDispatchMode):
    """Logs every aten op dispatched while it is active, and the kernel
    scopes of :mod:`repro_torch.kernels.ops` entered meanwhile."""

    def __init__(self, log: OpLog):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = out if isinstance(out, (tuple, list)) else (out,)
        self.log.entries.append(OpEntry(
            func.overloadpacket.__name__, _schema_args(func, args, kwargs),
            tuple(tensor_info(o) for o in outs
                  if isinstance(o, torch.Tensor)),
            kernel=ops.current_kernel()))
        return out

    def enter_kernel(self, name: str, route: str, operands) -> None:
        self.log.entries.append(OpEntry(
            f"kernel:{name}",
            {"operands": tuple(tensor_info(t) for t in operands
                               if isinstance(t, torch.Tensor))},
            kernel=name, route=route))


def record_ops(fn: Callable, *args, static=(), **kwargs):
    """Run ``fn(*args, **kwargs)`` eagerly and return ``(its result, the
    OpLog of what it dispatched)``. ``static`` are a captured step's
    input tensors, into whose storages ``ops.static-inputs`` counts the
    loads."""
    log = OpLog(static=frozenset(storage_key(t) for t in static))
    rec = _Recorder(log)
    ops.add_sink(rec)
    try:
        with rec:
            result = fn(*args, **kwargs)
    finally:
        ops.remove_sink(rec)
    return result, log


# ---------------------------------------------------------------------------
# rule framework
# ---------------------------------------------------------------------------


@dataclass
class OpContext:
    """Everything a rule may need about one recorded step.

    Optional fields gate rules: a rule requiring ``plan`` (the CSC
    contracts) skips contexts without one, and so on, so one
    ``run_rules`` call over a context runs exactly the applicable subset.
    """
    log: OpLog
    label: str = ""
    # CSC-plan contracts (pregather / segment-scatter / backward-gather)
    plan: Optional[object] = None            # kernels.plan.CSCPlan
    # compact-step O(view) contract: the FULL graph's (N, E); dims that
    # legitimately appear (a bucket pad that collides) go in exempt
    graph_shape: Optional[Tuple[int, int]] = None
    exempt_dims: Tuple[int, ...] = ()
    # how many staged inputs a captured step loads into its static
    # tensors (None = not checked for this context)
    expect_static: Optional[int] = None
    # cuda.resources: a resources.Budget (None = not run: no compiled
    # kernels to read, as on the CPU)
    budget: Optional[object] = None


@dataclass(frozen=True)
class Rule:
    id: str
    description: str
    check: Callable[[OpContext], List[Finding]]


RULES: Dict[str, Rule] = {}


def register(rule: Rule) -> Rule:
    if rule.id in RULES:
        raise ValueError(f"duplicate rule id {rule.id!r}")
    RULES[rule.id] = rule
    return rule


def rule(id: str, description: str):
    """Decorator: register ``fn(ctx) -> [Finding, ...]`` under ``id``."""
    def wrap(fn):
        register(Rule(id, description, fn))
        return fn
    return wrap


def run_rules(ctx: OpContext,
              ids: Optional[Iterable[str]] = None) -> List[Finding]:
    """Run the selected rules (default: all registered) over one context."""
    selected = list(RULES.values()) if ids is None else [
        RULES[i] for i in ids]
    findings: List[Finding] = []
    for r in selected:
        findings.extend(r.check(ctx))
    return findings


def check_or_raise(findings: List[Finding]) -> None:
    """Shim helper: raise :class:`ContractError` on any error finding."""
    errors = [f for f in findings if f.severity == "error"]
    if errors:
        raise ContractError("\n".join(f.render() for f in errors))


# ---------------------------------------------------------------------------
# the CSC-plan contracts
# ---------------------------------------------------------------------------

# index ops: name -> (source argument, index argument)
_INDEX_OPS = {"index_select": ("self", "index"), "gather": ("self", "index"),
              "take": ("self", "index"), "embedding": ("weight", "indices"),
              "index": ("self", "indices")}
# accumulating scatters: name -> the updates' argument
_SCATTER_OPS = {"index_add": "source", "index_add_": "source",
                "scatter_add": "src", "scatter_add_": "src",
                "scatter_reduce": "src", "scatter_reduce_": "src",
                "index_put": "values", "index_put_": "values",
                "_index_put_impl_": "values"}


def _index_operands(e: OpEntry):
    """(source, index) of an index op, else None."""
    names = _INDEX_OPS.get(e.name)
    if names is None:
        return None
    src, idx = e.arg(names[0]), e.arg(names[1])
    if isinstance(idx, tuple):          # aten.index: the first index given
        idx = next((i for i in idx if isinstance(i, TensorInfo)), None)
    if not isinstance(src, TensorInfo) or not isinstance(idx, TensorInfo):
        return None
    return src, idx


def _is_segment_scatter(e: OpEntry, num_edges: int) -> bool:
    """An accumulating scatter whose updates carry the plan's edge axis:
    a reference segment op (forward, or the backward of a gather)."""
    upd = _SCATTER_OPS.get(e.name)
    if upd is None:
        return False
    if e.name.startswith(("index_put", "_index_put")) \
            and not e.arg("accumulate"):
        return False
    u = e.arg(upd)
    return isinstance(u, TensorInfo) and bool(u.shape) \
        and u.shape[0] == num_edges


def count_segment_scatters(log: OpLog, plan) -> int:
    """Number of accumulating scatters outside the kernels whose updates
    carry the plan's edge axis. On model-level steps this cannot tell a
    Sum-stage fallback from the NN-Gather's backward, so the end-to-end
    certificate compares the count across backends (csc strictly below
    reference) while the combine-level rules demand zero."""
    return sum(_is_segment_scatter(e, plan.num_edges)
               for e in log.outside_kernels())


def _plan_order_storages(log: OpLog, plan) -> set:
    """The storage of ``plan.perm`` and of every integer tensor computed
    from it outside the kernels (its views share the storage)."""
    tainted = {storage_key(plan.perm)}
    for e in log.outside_kernels():
        if any(t.storage in tainted for t in e.inputs()):
            tainted.update(o.storage for o in e.outputs
                           if not o.is_float and o.storage)
    return tainted


@rule("ops.pregather",
      "outside the kernels, no float output of an index op through the "
      "plan's perm: the message tensor in plan order that the fused "
      "kernels eliminated")
def _check_pregather(ctx: OpContext) -> List[Finding]:
    if ctx.plan is None:
        return []
    tainted = _plan_order_storages(ctx.log, ctx.plan)
    findings = []
    for e in ctx.log.outside_kernels():
        pair = _index_operands(e)
        if pair is None or pair[1].storage not in tainted:
            continue
        for out in e.outputs:
            if out.is_float:
                findings.append(Finding(
                    "ops.pregather",
                    f"pre-gathered message tensor {out.shape} ({e.name} "
                    f"through the plan's perm, E={ctx.plan.num_edges})",
                    label=ctx.label, location=e.name))
    return findings


@rule("ops.segment-scatter",
      "outside the kernels, no accumulating scatter with edge-axis "
      "updates on the csc path (the atomic, non-deterministic fallback)")
def _check_segment_scatter(ctx: OpContext) -> List[Finding]:
    if ctx.plan is None:
        return []
    E = ctx.plan.num_edges
    return [Finding(
        "ops.segment-scatter",
        f"reference segment scatter ({e.name}) found on the csc path "
        f"(E={E})", label=ctx.label, location=e.name)
        for e in ctx.log.outside_kernels() if _is_segment_scatter(e, E)]


@rule("ops.backward-gather",
      "outside the kernels, no (N, ...) -> (E, ...) index op (the old "
      "g[segment_ids] reference backward)")
def _check_backward_gather(ctx: OpContext) -> List[Finding]:
    if ctx.plan is None:
        return []
    E, N = ctx.plan.num_edges, ctx.plan.num_segments
    findings = []
    for e in ctx.log.outside_kernels():
        pair = _index_operands(e)
        if pair is None or not e.outputs:
            continue
        src, out = pair[0].shape, e.outputs[0].shape
        if out and src and out[0] == E and src[0] == N:
            findings.append(Finding(
                "ops.backward-gather",
                f"reference backward gather ({src} -> {out}) found on the "
                f"csc path (E={E}, N={N})", label=ctx.label,
                location=e.name))
    return findings


# ---------------------------------------------------------------------------
# step hygiene
# ---------------------------------------------------------------------------


@rule("ops.full-graph-tensor",
      "no full-graph-shaped (N, ...)/(E, ...) float tensor inside a "
      "compact step or a served bucket (the O(view) memory contract)")
def _check_full_graph(ctx: OpContext) -> List[Finding]:
    if ctx.graph_shape is None:
        return []
    forbidden = {d for d in ctx.graph_shape if d not in ctx.exempt_dims}
    findings = []
    for e in ctx.log:
        for out in e.outputs:
            if out.shape and out.shape[0] in forbidden and out.is_float:
                findings.append(Finding(
                    "ops.full-graph-tensor",
                    f"full-graph-shaped float tensor {out.shape} from "
                    f"{e.name} inside a compact step (graph N, E = "
                    f"{ctx.graph_shape}): device memory must scale with "
                    "the view, not the graph", label=ctx.label,
                    location=e.kernel or e.name))
    return findings


@rule("ops.f64-promotion",
      "no float64 output anywhere in the step, kernel scopes included")
def _check_f64(ctx: OpContext) -> List[Finding]:
    findings = []
    for e in ctx.log:
        out = next((o for o in e.outputs if o.dtype == torch.float64), None)
        if out is not None:      # one finding per op is enough
            findings.append(Finding(
                "ops.f64-promotion",
                f"float64 tensor {out.shape} produced by '{e.name}': a "
                "float64 constant or array is promoting the compute "
                "dtype", label=ctx.label, location=e.kernel or e.name))
    return findings


# data-dependent syncs: the output's size is read back to the host
_SYNC_OPS = frozenset({"_local_scalar_dense", "nonzero", "masked_select",
                       "_unique", "_unique2", "unique_dim",
                       "unique_consecutive", "unique_dim_consecutive"})


def _crosses_devices(e: OpEntry) -> bool:
    if e.name == "copy_":
        dst, src = e.arg("self"), e.arg("src")
        return (isinstance(dst, TensorInfo) and isinstance(src, TensorInfo)
                and dst.device != src.device)
    if e.name == "_to_copy":
        src = e.arg("self")
        return (isinstance(src, TensorInfo) and bool(e.outputs)
                and e.outputs[0].device != src.device)
    return False


@rule("ops.host-transfer",
      "no .item(), data-dependent sync or copy across devices inside the "
      "step")
def _check_host_transfer(ctx: OpContext) -> List[Finding]:
    findings = []
    for e in ctx.log:
        if e.name in _SYNC_OPS:
            what = "a host sync"
        elif _crosses_devices(e):
            what = "a copy across devices"
        else:
            continue
        findings.append(Finding(
            "ops.host-transfer",
            f"'{e.name}' inside the step is {what}: every step pays it",
            label=ctx.label, location=e.kernel or e.name))
    return findings


@rule("ops.static-inputs",
      "a captured step loads its staged inputs into the capture's static "
      "tensors exactly as the trainer promised (expected_static)")
def _check_static_inputs(ctx: OpContext) -> List[Finding]:
    if ctx.expect_static is None:
        return []
    loads = sum(1 for e in ctx.log.outside_kernels()
                if e.name == "copy_" and isinstance(e.arg("self"), TensorInfo)
                and e.arg("self").storage in ctx.log.static)
    if loads == ctx.expect_static:
        return []
    if loads == 0:
        msg = (f"no staged input was loaded into the captured step's "
               f"static tensors, expected {ctx.expect_static}: record the "
               "step through the trainer (traced_step_ops)")
    else:
        msg = (f"{loads} staged inputs loaded into the captured step's "
               f"static tensors, expected {ctx.expect_static} (the staged "
               "view is copied in place on the card under CUDA graphs, "
               "and not at all eagerly)")
    return [Finding("ops.static-inputs", msg, label=ctx.label)]

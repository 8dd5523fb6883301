"""AST lint over ``src/repro_torch``: the bug classes the reference's lint
catches (a copy of ``repro/analysis/srclint.py``, pure ``ast``).

Four families, run by :func:`lint_tree` (and the ``python -m
repro_torch.analysis`` gate):

``src.bare-assert``
    A bare ``assert`` guarding inputs in library code vanishes under
    ``python -O`` and then crashes (or silently mis-computes) far from
    the call site, the bug the reference's ``_require_rng`` documents.
    Library code raises ``ValueError``/``TypeError`` with a message
    instead; the lint enforces zero remaining.

``src.hot-membership-scan`` / ``src.hot-full-graph-alloc``
    Per-step work in the **hot view path** must stay O(view). The
    configured hot functions of ``core/views.py``/``core/subgraph.py``
    may not call the O(N)-membership numpy scans
    (``np.isin``/``np.union1d``/``np.setdiff1d``) nor allocate fresh
    full-graph-sized arrays (``np.zeros(g.num_nodes, ...)`` and
    friends, including via locals assigned from ``.num_nodes`` /
    ``.num_edges``). Parity oracles (``bfs_layers_loop``,
    ``cluster_view_recompute``) are deliberately outside the hot set.

``src.silent-except``
    An ``except`` whose body is only ``pass`` (or ``...``) swallows the
    error with no trace — in a fault-tolerant runtime every discarded
    exception is a recovery decision and must be visible (retry it,
    count it, log it, or re-raise). Deliberate best-effort cleanup
    paths carry a waiver comment explaining why discarding is correct.

``src.unjoined-process``
    A module that calls ``Process(...).start()`` without any
    ``.join()``/``.terminate()``/``.kill()`` call anywhere in the file
    has no supervised shutdown path — on error the child is orphaned
    (and under spawn it pins shared-memory segments). Fire-and-forget
    helpers that genuinely cannot leak carry a waiver.

Waiving a finding: append ``# lint: waive=<rule-id>`` to the flagged
line (comma-separate several ids; ``all`` waives every rule). Waivers
are for documented one-off fallback paths — e.g. the scratch-buffer
allocation a function performs only when the caller didn't supply one.
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Set

from repro_torch.analysis.oplog import Finding

# hot view-path functions, keyed by path relative to the repro_torch
# package;
# values are qualnames (Class.method for methods)
HOT_FUNCTIONS: Dict[str, Set[str]] = {
    "core/subgraph.py": {
        "bfs_layers", "bfs_layers_fresh", "stamped_in_edges",
        "_expand_frontier", "fill_khop_masks",
    },
    "core/views.py": {
        "ViewBuilder.khop_view", "ViewBuilder.cluster_view",
        "ViewBuilder.khop_compact", "ViewBuilder.cluster_compact",
        "ClusterViewCache.compose", "CompactBlockBuilder.stage",
        "_fill_compact_block",
    },
}

MEMBERSHIP_SCANS = {"isin", "union1d", "setdiff1d", "intersect1d"}
ALLOC_FUNCS = {"zeros", "ones", "full", "empty"}
SIZE_ATTRS = {"num_nodes", "num_edges"}

_WAIVE_RE = re.compile(r"#\s*lint:\s*waive=([\w.,\-]+)")


def _waivers(source: str) -> Dict[int, Set[str]]:
    """lineno -> waived rule ids, from ``# lint: waive=...`` comments."""
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(source.splitlines(), start=1):
        m = _WAIVE_RE.search(line)
        if m:
            out[i] = {s.strip() for s in m.group(1).split(",")}
    return out


def _waived(waivers: Dict[int, Set[str]], lineno: int, rule_id: str) -> bool:
    ids = waivers.get(lineno, ())
    return "all" in ids or rule_id in ids or rule_id.split(".", 1)[-1] in ids


class _SizeNames(ast.NodeVisitor):
    """Collect local names assigned from ``<expr>.num_nodes``/``.num_edges``
    (simple and tuple assignments) within one function body."""

    def __init__(self):
        self.names: Set[str] = set()

    @staticmethod
    def _is_size_attr(node) -> bool:
        return isinstance(node, ast.Attribute) and node.attr in SIZE_ATTRS

    def visit_Assign(self, node: ast.Assign):
        targets = node.targets[0] if len(node.targets) == 1 else None
        if (isinstance(targets, ast.Tuple)
                and isinstance(node.value, ast.Tuple)
                and len(targets.elts) == len(node.value.elts)):
            pairs = zip(targets.elts, node.value.elts)
        else:
            pairs = [(t, node.value) for t in node.targets]
        for tgt, val in pairs:
            if isinstance(tgt, ast.Name) and self._is_size_attr(val):
                self.names.add(tgt.id)
        self.generic_visit(node)


def _references_graph_size(node, size_names: Set[str]) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in SIZE_ATTRS:
            return True
        if isinstance(sub, ast.Name) and sub.id in size_names:
            return True
    return False


def _np_call_name(node: ast.Call) -> Optional[str]:
    """'zeros' for ``np.zeros(...)``/``numpy.zeros(...)``, else None."""
    fn = node.func
    if (isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name)
            and fn.value.id in ("np", "numpy")):
        return fn.attr
    return None


class _Linter(ast.NodeVisitor):
    def __init__(self, rel: str, waivers: Dict[int, Set[str]],
                 hot: Set[str]):
        self.rel = rel
        self.waivers = waivers
        self.hot = hot
        self.stack: List[str] = []          # qualname parts
        self.size_names: List[Set[str]] = []   # per enclosing hot fn
        self.findings: List[Finding] = []
        # src.unjoined-process bookkeeping (file-level: Process(...)
        # call sites vs. whether ANY join/terminate/kill path exists)
        self.process_calls: List[int] = []
        self.has_reaper = False

    # -- helpers ----------------------------------------------------------

    def _qualname(self, name: str) -> str:
        return ".".join(self.stack + [name])

    def _in_hot_function(self) -> bool:
        return bool(self.size_names)

    def _emit(self, rule_id: str, lineno: int, message: str):
        if not _waived(self.waivers, lineno, rule_id):
            self.findings.append(Finding(
                rule_id, message, label=self.rel,
                location=f"{self.rel}:{lineno}"))

    # -- scopes -----------------------------------------------------------

    def visit_ClassDef(self, node: ast.ClassDef):
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    def _visit_function(self, node):
        qn = self._qualname(node.name)
        is_hot = qn in self.hot
        self.stack.append(node.name)
        if is_hot:
            collector = _SizeNames()
            collector.visit(node)
            self.size_names.append(collector.names)
        self.generic_visit(node)
        if is_hot:
            self.size_names.pop()
        self.stack.pop()

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    # -- rules ------------------------------------------------------------

    def visit_Assert(self, node: ast.Assert):
        self._emit(
            "src.bare-assert", node.lineno,
            "bare assert in library code (vanishes under python -O) — "
            "raise ValueError/TypeError with a message instead")
        self.generic_visit(node)

    def visit_ExceptHandler(self, node: ast.ExceptHandler):
        body = [n for n in node.body
                if not (isinstance(n, ast.Expr)
                        and isinstance(n.value, ast.Constant)
                        and isinstance(n.value.value, str))]  # docstrings
        silent = all(
            isinstance(n, ast.Pass)
            or (isinstance(n, ast.Expr)
                and isinstance(n.value, ast.Constant)
                and n.value.value is Ellipsis)
            for n in body)
        if silent:
            # a waiver reads most naturally next to the ``pass`` itself,
            # so accept it on the handler line or any body line
            lines = [node.lineno] + [n.lineno for n in node.body]
            if not any(_waived(self.waivers, ln, "src.silent-except")
                       for ln in lines):
                what = (ast.unparse(node.type) if node.type is not None
                        else "everything")
                self._emit(
                    "src.silent-except", node.lineno,
                    f"except {what} with a pass-only body swallows the "
                    "error invisibly — handle it (retry/count/log/raise) "
                    "or waive with a comment saying why discarding is "
                    "correct")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        fn = node.func
        if ((isinstance(fn, ast.Name) and fn.id == "Process")
                or (isinstance(fn, ast.Attribute)
                    and fn.attr == "Process")):
            self.process_calls.append(node.lineno)
        elif (isinstance(fn, ast.Attribute)
                and fn.attr in ("join", "terminate", "kill")):
            self.has_reaper = True
        if self._in_hot_function():
            name = _np_call_name(node)
            if name in MEMBERSHIP_SCANS:
                self._emit(
                    "src.hot-membership-scan", node.lineno,
                    f"np.{name} in a hot view-path function — an O(N) "
                    "membership scan per step; use a stamp/visited "
                    "buffer (or move the call to an oracle function)")
            elif name in ALLOC_FUNCS and _references_graph_size(
                    node, self.size_names[-1]):
                self._emit(
                    "src.hot-full-graph-alloc", node.lineno,
                    f"np.{name} of a full-graph-sized array in a hot "
                    "view-path function — allocate once (builder "
                    "scratch) and reuse per step")
        self.generic_visit(node)


def lint_source(source: str, rel: str,
                hot: Optional[Set[str]] = None) -> List[Finding]:
    """Lint one module's source; ``rel`` keys the hot-function config."""
    if hot is None:
        hot = HOT_FUNCTIONS.get(rel, set())
    tree = ast.parse(source)
    linter = _Linter(rel, _waivers(source), hot)
    linter.visit(tree)
    if not linter.has_reaper:
        for lineno in linter.process_calls:
            linter._emit(
                "src.unjoined-process", lineno,
                "Process(...) spawned in a file with no join()/"
                "terminate()/kill() anywhere — no supervised shutdown "
                "path; children orphan on error (add a close() that "
                "joins with escalation, or waive if the process cannot "
                "outlive its work)")
    return linter.findings


def lint_file(path: Path, root: Path,
              hot: Optional[Set[str]] = None) -> List[Finding]:
    rel = path.relative_to(root).as_posix()
    return lint_source(path.read_text(), rel, hot=hot)


def lint_tree(root) -> List[Finding]:
    """Lint every ``*.py`` under ``root`` (the ``repro_torch`` package
    dir)."""
    root = Path(root)
    findings: List[Finding] = []
    for path in sorted(root.rglob("*.py")):
        findings.extend(lint_file(path, root))
    return findings

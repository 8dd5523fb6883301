"""The port's analysis gate (``repro_torch.analysis``) on the CPU, held to
the reference's ``repro.analysis`` (``tests/test_analysis.py``).

- Every ``ops.*`` rule flags its fixture by id, and its clean twin is not
  flagged (the fixtures of ``tests/test_analysis.py:48-135``, restated
  over recorded torch ops).
- The recorder sees autograd's backward: a recorded combine-level
  forward and backward logs the backward kernel's scope and its ops.
- Oracle agreement: over the smoke matrix the port finds 0 over the same
  contexts as the reference's rules, less ``vmem.budget``, which also
  find 0 there; the csc backend counts fewer edge-axis scatters than
  ``reference`` for all four models, in both packages.
- The source lint gives the reference's findings on the shared fixtures
  and over ``src/repro``, and nothing over ``src/repro_torch``.
- The CLI gate, and the ``cuda.resources`` parser over a
  ``cuobjdump --dump-resource-usage`` text captured on an H100.
- ``cuda``-marked twins (skipped without a card): the CUDA route of each
  GNN kernel recorded clean, ``.cpu()`` inside a step flagged, and the
  captured step's static inputs on the card.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis import (ContractError, OpContext, RULES,
                                  record_ops, run_rules)
from repro_torch.analysis.cli import (COMBINE_RULES, COMPACT_RULES,
                                      INFER_RULES, TRAIN_RULES, Report,
                                      analyze, check_combine_modes,
                                      check_compact_buckets, check_serving,
                                      check_trainers, run_analysis)
from repro_torch.analysis.resources import (Budget, check_stats,
                                            launch_bounds, stats_from_text)
from repro_torch.analysis.srclint import lint_source as port_lint_source
from repro_torch.analysis.srclint import lint_tree as port_lint_tree
from repro_torch.kernels import build, ops
from repro_torch.kernels.plan import build_csc_plan

ROOT = Path(__file__).resolve().parents[1]
REF_ROOT = ROOT / "src" / "repro"
PORT_ROOT = ROOT / "src" / "repro_torch"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _plan(E=96, N=40):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, N, E).astype(np.int32)
    return torch.from_numpy(ids), build_csc_plan(ids, N)


def _ids(findings):
    return {f.rule for f in findings}


def _run(fn, rule_id, *args, **ctx):
    _, log = record_ops(fn, *args)
    return run_rules(OpContext(log, **ctx), ids=[rule_id])


# ---------------------------------------------------------------------------
# fixtures: each rule flags its fixture by id, and not its clean twin
# ---------------------------------------------------------------------------


def test_pregather_fixture_flagged():
    ids, plan = _plan()
    data = torch.ones(plan.num_edges, 8)
    # the message tensor laid out in plan order
    assert _ids(_run(lambda: data.index_select(0, plan.perm),
                     "ops.pregather", plan=plan)) == {"ops.pregather"}
    # through an index computed from perm, too
    assert _ids(_run(lambda: data[plan.perm.long() % plan.num_edges],
                     "ops.pregather", plan=plan)) == {"ops.pregather"}
    # integer gathers through the plan are allowed
    ints = torch.arange(plan.num_edges, dtype=torch.int32)
    assert _run(lambda: ints.index_select(0, plan.perm), "ops.pregather",
                plan=plan) == []
    # and the kernel wrapper's own gathers are inside its scope
    assert _run(lambda: ops.segment_sum_op(data, plan), "ops.pregather",
                plan=plan) == []


def test_segment_scatter_fixture_flagged():
    ids, plan = _plan()
    data = torch.ones(plan.num_edges, 8)

    def fallback():
        return torch.zeros(plan.num_segments, 8).index_add_(0, ids.long(),
                                                            data)

    assert _ids(_run(fallback, "ops.segment-scatter", plan=plan)) == {
        "ops.segment-scatter"}
    accumulate = lambda: torch.zeros(plan.num_segments, 8).index_put_(
        (ids.long(),), data, accumulate=True)
    assert _ids(_run(accumulate, "ops.segment-scatter", plan=plan)) == {
        "ops.segment-scatter"}
    assert _run(lambda: ops.segment_sum_op(data, plan),
                "ops.segment-scatter", plan=plan) == []


def test_backward_gather_fixture_flagged():
    ids, plan = _plan()
    g = torch.ones(plan.num_segments, 8)
    assert _ids(_run(lambda: g.index_select(0, ids), "ops.backward-gather",
                     plan=plan)) == {"ops.backward-gather"}
    assert _run(lambda: ops.segment_sum_bwd_op(g, plan),
                "ops.backward-gather", plan=plan) == []


def test_full_graph_tensor_fixture_flagged():
    N, E = 500, 2000
    x = torch.ones(N, 16)
    fn = lambda: torch.tanh(x).sum()
    assert _ids(_run(fn, "ops.full-graph-tensor", graph_shape=(N, E))) == {
        "ops.full-graph-tensor"}
    # an exempted (colliding) dim is not flagged
    assert _run(fn, "ops.full-graph-tensor", graph_shape=(N, E),
                exempt_dims=(N,)) == []
    # integer tensors of graph width (plan indices) are allowed
    i = torch.ones(N, dtype=torch.int32)
    assert _run(lambda: i + 1, "ops.full-graph-tensor",
                graph_shape=(N, E)) == []


def test_f64_fixture_flagged():
    x = torch.ones(4)
    assert _ids(_run(lambda: x * torch.tensor(2.0, dtype=torch.float64),
                     "ops.f64-promotion")) == {"ops.f64-promotion"}
    assert _run(lambda: x * 2.0, "ops.f64-promotion") == []


def test_host_transfer_fixture_flagged():
    x = torch.arange(4.0)

    def step():
        return x.sum().item(), torch.nonzero(x)

    findings = _run(step, "ops.host-transfer")
    assert _ids(findings) == {"ops.host-transfer"}
    assert len(findings) >= 2        # .item() AND the nonzero sync
    assert _run(lambda: x.sum() * 2, "ops.host-transfer") == []


def test_static_inputs_fixture_flagged():
    static = (torch.zeros(4), torch.zeros(3))
    staged = (torch.ones(4), torch.ones(3))

    def load():
        for dst, src in zip(static, staged):
            dst.copy_(src)
        return static[0] * 2

    _, log = record_ops(load, static=static)
    # expecting 3 loads but 2 happen: mismatch
    assert _ids(run_rules(OpContext(log, expect_static=3),
                          ids=["ops.static-inputs"])) == {
        "ops.static-inputs"}
    # the true count verifies clean
    assert run_rules(OpContext(log, expect_static=2),
                     ids=["ops.static-inputs"]) == []
    # a log with no load where one is expected cannot be verified
    _, bare = record_ops(lambda: staged[0] * 2, static=static)
    assert _ids(run_rules(OpContext(bare, expect_static=2),
                          ids=["ops.static-inputs"])) == {
        "ops.static-inputs"}


# ---------------------------------------------------------------------------
# the recorder and the kernel scopes
# ---------------------------------------------------------------------------


def _combine_step(dev, mode="mean"):
    """A recorded combine-level forward and backward on the csc backend."""
    from repro_torch.core.aggregate import combine
    rng = np.random.default_rng(7)
    E, N = 200, 50
    ids = rng.integers(0, N // 2, E).astype(np.int32)
    v = torch.tensor(rng.normal(size=(E, 2, 8)), dtype=torch.float32,
                     device=dev, requires_grad=True)
    lg = torch.tensor(rng.normal(size=(E, 2)), dtype=torch.float32,
                      device=dev, requires_grad=True)
    mask = torch.ones(E, device=dev)
    plan = build_csc_plan(ids, N).to(dev)

    def step():
        out = combine(mode, {"value": v, "logit": lg},
                      torch.from_numpy(ids).to(dev), N, mask,
                      backend="csc", plan=plan)
        torch.sum(torch.sin(out) * out).backward()

    return plan, record_ops(step)[1]


def test_recorder_sees_backward():
    """The backward kernel's scope and autograd's own backward ops (the
    cos of d sin) are in the log of a recorded value-and-grad."""
    _, log = _combine_step("cpu")
    kernels = [e.name for e in log.kernels()]
    assert kernels == ["kernel:segment_sum", "kernel:segment_sum",
                       "kernel:segment_sum_bwd"]
    assert "cos" in {e.name for e in log}
    # the plain version's ops are tagged with their kernel
    tagged = {e.kernel for e in log if not e.is_kernel and e.kernel}
    assert tagged == {"segment_sum", "segment_sum_bwd"}
    assert {e.route for e in log.kernels()} == {"cpu"}


def test_registry_is_complete():
    for rule_id in ("ops.pregather", "ops.segment-scatter",
                    "ops.backward-gather", "ops.full-graph-tensor",
                    "ops.f64-promotion", "ops.host-transfer",
                    "ops.static-inputs", "cuda.resources"):
        assert rule_id in RULES, rule_id
        assert RULES[rule_id].description
    for subset in (COMBINE_RULES, TRAIN_RULES, INFER_RULES, COMPACT_RULES):
        assert set(subset) <= set(RULES)


def test_ops_shims_raise_assertionerror():
    from repro_torch.kernels.ops import (assert_pregather_free,
                                         assert_sum_stage_fused,
                                         count_segment_scatters)
    ids, plan = _plan()
    data = torch.ones(plan.num_edges, 8)
    _, log = record_ops(lambda: torch.zeros(plan.num_segments, 8)
                        .index_add_(0, ids.long(), data))
    with pytest.raises(AssertionError, match="reference"):
        assert_sum_stage_fused(log, plan)
    with pytest.raises(ContractError):
        assert_sum_stage_fused(log, plan)
    assert count_segment_scatters(log, plan) == 1
    _, pre = record_ops(lambda: data.index_select(0, plan.perm).sum())
    with pytest.raises(AssertionError, match="pre-gather"):
        assert_pregather_free(pre, plan)
    fused_plan, fused = _combine_step("cpu", "softmax")
    assert_sum_stage_fused(fused, fused_plan)


# ---------------------------------------------------------------------------
# oracle agreement: the same matrix, 0 findings in both packages
# ---------------------------------------------------------------------------

CHECKS = {"combine": (check_combine_modes, 4), "trainers": (check_trainers, 16),
          "compact": (check_compact_buckets, 4), "serving": (check_serving, 2)}


def _reference_report():
    """The reference's report, less ``vmem.budget`` (its launch walk reads
    a field newer jax no longer has, ROADMAP C.2)."""
    from repro.analysis.cli import Report as RefReport
    from repro.analysis.jaxpr import run_rules as ref_run_rules

    class NoVmemReport(RefReport):
        def run(self, ctx, ids):
            self.contexts += 1
            self.findings.extend(ref_run_rules(
                ctx, ids=[i for i in ids if i != "vmem.budget"]))

    return NoVmemReport(16 * 2 ** 20)


@pytest.mark.parametrize("part", sorted(CHECKS))
def test_matrix_clean_in_both_packages(part):
    import repro.analysis.cli as ref_cli
    check, contexts = CHECKS[part]
    report = Report(torch.device("cpu"), None)
    check(report)
    assert report.findings == []
    assert report.contexts == contexts
    ref = _reference_report()
    getattr(ref_cli, check.__name__)(ref)
    assert ref.findings == []
    assert ref.contexts == contexts


@pytest.mark.parametrize("model", ["gcn", "sage", "sage_max", "gat"])
def test_scatter_certificate_in_both_packages(model):
    """csc counts strictly fewer edge-axis scatters than reference on a
    model-level train step, in the port and in the reference."""
    from repro.analysis.jaxpr import count_segment_scatters as ref_count
    from repro.config import GNNConfig as RefConfig
    from repro.core.engine import HybridParallelEngine as RefEngine
    from repro.core.partition import build_partitions as ref_partitions
    from repro.core.strategies import strategy_views as ref_views
    from repro.core.trainer import Trainer as RefTrainer
    from repro.graph import sbm_graph as ref_sbm
    from repro.models import make_gnn as ref_make_gnn
    from repro.optim import adam as ref_adam

    report = Report(torch.device("cpu"), None)
    check_trainers(report)
    [cert] = [c for c in report.certificates if c["model"] == model]
    assert cert["csc"] < cert["reference"]

    g = ref_sbm(num_nodes=220, num_classes=4, feature_dim=8, p_in=0.05,
                p_out=0.005, seed=0).add_self_loops()
    view = next(iter(ref_views(g, "global", K=2, steps=1)))
    counts, plan = {}, None
    for backend in ("csc", "reference"):
        cfg = RefConfig(model=model, num_layers=2, hidden_dim=16,
                        num_classes=4, feature_dim=8,
                        aggregate_backend=backend)
        engine = RefEngine(ref_make_gnn(cfg), ref_partitions(g, 1))
        plan = plan or engine._csc_meta
        trainer = RefTrainer(engine, ref_adam(1e-2), seed=0)
        counts[backend] = ref_count(trainer.traced_step_jaxpr(view), plan)
    assert counts["csc"] < counts["reference"]


# ---------------------------------------------------------------------------
# the analysis hooks leave the trainers as they found them
# ---------------------------------------------------------------------------


def _small_graph():
    from repro_torch.graph.datasets import sbm_graph
    return sbm_graph(num_nodes=120, num_classes=4, feature_dim=8,
                     p_in=0.05, p_out=0.005, seed=0).add_self_loops()


def _state(trainer):
    return ({k: p.detach().clone() for k, p in trainer.params.items()},
            {k: ({n: t.clone() for n, t in v.items()} if isinstance(v, dict)
                 else v) for k, v in trainer.opt_state.items()})


def _same_state(a, b):
    assert a[0].keys() == b[0].keys()
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    for k, v in a[1].items():
        if isinstance(v, dict):
            for n in v:
                assert torch.equal(v[n], b[1][k][n]), (k, n)
        else:
            assert v == b[1][k], k


def test_traced_step_ops_leave_the_trainers_as_they_were():
    from repro_torch.config import GNNConfig
    from repro_torch.core.engine import HybridParallelEngine
    from repro_torch.core.partition import build_partitions
    from repro_torch.core.strategies import strategy_views
    from repro_torch.core.trainer import CompactTrainer, Trainer
    from repro_torch.models import make_gnn
    from repro_torch.optim import adam

    g = _small_graph()
    cfg = GNNConfig(model="gcn", num_layers=2, hidden_dim=16, num_classes=4,
                    feature_dim=8, aggregate_backend="csc")
    views = list(strategy_views(g, "mini", K=2, seed=0, steps=3,
                                batch_nodes=16, compact=True))
    tr = CompactTrainer(make_gnn(cfg), g, adam(1e-2), device="cpu")
    tr.fit(iter(views[:2]), prefetch=False)
    before, calls = _state(tr), dict(tr.step_calls)
    log = tr.traced_step_ops(views[2])
    assert len(log.kernels()) > 0 and tr.expected_static(views[2]) == 0
    _same_state(before, _state(tr))
    assert tr.step_calls == calls and tr.captures == {}
    tr.assert_compiled_per_bucket()

    engine = HybridParallelEngine(make_gnn(cfg), build_partitions(g, 1),
                                  device="cpu")
    et = Trainer(engine, adam(1e-2))
    gv = next(iter(strategy_views(g, "global", K=2, steps=1)))
    et.fit(iter([gv]), prefetch=False)
    before, counts = _state(et), dict(et.trace_counts)
    assert len(et.traced_step_ops(gv)) > 0
    assert len(et.traced_infer_ops(gv).kernels()) > 0
    _same_state(before, _state(et))
    assert et.trace_counts == counts and et.steps_run == 1


# ---------------------------------------------------------------------------
# the source lint: the reference's findings, and a clean port
# ---------------------------------------------------------------------------

LINT_FIXTURES = {
    "bare-assert": ("def f(x):\n    assert x > 0\n    return x\n", None),
    "hot-path": ("import numpy as np\n"
                 "def hot(g, sel):\n"
                 "    n = g.num_nodes\n"
                 "    buf = np.zeros(n, bool)\n"
                 "    mask = np.isin(np.arange(g.num_nodes), sel)\n"
                 "    return buf, mask\n", {"hot"}),
    "hot-path-cold": ("import numpy as np\n"
                      "def hot(g, sel):\n"
                      "    return np.zeros(g.num_nodes, bool)\n", set()),
    "waiver": ("def f(x):\n"
               "    assert x > 0  # lint: waive=src.bare-assert\n"
               "    assert x < 9\n", None),
    "silent-except": ("def f():\n"
                      "    try:\n"
                      "        g()\n"
                      "    except OSError:\n"
                      "        pass\n"
                      "    try:\n"
                      "        g()\n"
                      "    except Exception:\n"
                      "        ...\n", None),
    "silent-except-waived": ("def f():\n"
                             "    try:\n"
                             "        g()\n"
                             "    except OSError:\n"
                             "        pass  # lint: waive=src.silent-except\n",
                             None),
    "unjoined-process": ("import multiprocessing as mp\n"
                         "def launch(fn):\n"
                         "    p = mp.Process(target=fn)\n"
                         "    p.start()\n"
                         "    return p\n", None),
    "joined-process": ("from multiprocessing import Process\n"
                       "def launch(fn):\n"
                       "    Process(target=fn).start()\n"
                       "def wait(p):\n"
                       "    p.join()\n", None),
}


def _key(findings):
    return [(f.rule, f.location, f.severity) for f in findings]


@pytest.mark.parametrize("name", sorted(LINT_FIXTURES))
def test_srclint_matches_the_reference_on_fixtures(name):
    from repro.analysis.srclint import lint_source as ref_lint_source
    src, hot = LINT_FIXTURES[name]
    assert _key(port_lint_source(src, "fixture.py", hot=hot)) == _key(
        ref_lint_source(src, "fixture.py", hot=hot))


def test_srclint_matches_the_reference_over_its_tree():
    from repro.analysis.srclint import lint_tree as ref_lint_tree
    assert _key(port_lint_tree(REF_ROOT)) == _key(ref_lint_tree(REF_ROOT))


def test_srclint_port_tree_clean():
    assert port_lint_tree(PORT_ROOT) == []


# ---------------------------------------------------------------------------
# the CLI gate
# ---------------------------------------------------------------------------


def test_cli_strict_cpu(tmp_path):
    out, lines = tmp_path / "analysis.json", []
    rc = run_analysis(strict=True, json_path=str(out), device="cpu",
                      out=lines.append)
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["findings"] == []
    assert report["contexts_traced"] >= 24
    assert report["not_run"] == ["cuda.resources"]
    assert any("cuda.resources: not run" in line for line in lines)
    assert {c["model"] for c in report["certificates"]} == {
        "gcn", "sage", "sage_max", "gat"}
    assert {c["kernel"] for c in report["launches"]} >= {
        "segment_sum", "segment_sum_bwd", "segment_max", "segment_max_bwd",
        "edge_softmax", "edge_softmax_bwd"}


def test_cli_strict_fails_on_findings(tmp_path):
    """--strict exits nonzero when the lint root holds a violation."""
    bad = tmp_path / "pkg"
    bad.mkdir()
    (bad / "mod.py").write_text("def f(x):\n    assert x\n    return x\n")
    rc = run_analysis(strict=True, lint_root=str(bad), device="cpu",
                      out=lambda *a, **k: None)
    assert rc == 1


def test_cli_default_device_is_the_card(monkeypatch):
    from repro_torch.analysis.cli import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--strict"])


def test_full_matrix_records_the_sequence_kernels():
    report = analyze(full=True, device="cpu", out=lambda *a: None)
    assert report.findings == []
    assert {c["kernel"] for c in report.launches} >= {"flash_attention",
                                                      "wkv6"}


# ---------------------------------------------------------------------------
# cuda.resources: the parser over cuobjdump output captured on an H100
# (NVIDIA H100 80GB HBM3, CUDA 12.9, the sources' sm_90a build)
# ---------------------------------------------------------------------------

USAGE = """
Fatbin elf code:
================
arch = sm_90a
code version = [1,7]
host = linux
compile_size = 64bit

Resource usage:
 Common:
  GLOBAL:0
 Function _ZN54_GLOBAL__N__d43d1596_21_flash_attention_tc_cu_6107570415flash_tc_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PKiPS1_lllillf:
  REG:128 STACK:0 SHARED:1024 LOCAL:0 CONSTANT[0]:620 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN54_GLOBAL__N__d43d1596_21_flash_attention_tc_cu_6107570415flash_tc_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PKiPS1_lllillf:
  REG:128 STACK:0 SHARED:1024 LOCAL:0 CONSTANT[0]:620 TEXTURE:0 SURFACE:0 SAMPLER:0
 Function _ZN52_GLOBAL__N__a496e073_19_edge_softmax_bwd_cu_edbcd78323edge_softmax_bwd_kernelILb0ELi0EEEvNS_4ArgsE:
  REG:64 STACK:16 SHARED:0 LOCAL:0 CONSTANT[0]:680 TEXTURE:0 SURFACE:0 SAMPLER:0
"""

ELF = """
.nv.info._ZN54_GLOBAL__N__d43d1596_21_flash_attention_tc_cu_6107570415flash_tc_kernelILi128EEEvPK13__nv_bfloat16S3_S3_PKiPS1_lllillf
\t<0x19>
\tAttribute:\tEIATTR_MAX_THREADS
\tFormat:\tEIFMT_SVAL
\tValue:\t0x100 0x1 0x1
\t<0x20>
.nv.info._ZN54_GLOBAL__N__d43d1596_21_flash_attention_tc_cu_6107570415flash_tc_kernelILi64EEEvPK13__nv_bfloat16S3_S3_PKiPS1_lllillf
\tAttribute:\tEIATTR_MAX_THREADS
\tFormat:\tEIFMT_SVAL
\tValue:\t0x100 0x1 0x1
.nv.info._ZN52_GLOBAL__N__a496e073_19_edge_softmax_bwd_cu_edbcd78323edge_softmax_bwd_kernelILb0ELi0EEEvNS_4ArgsE
\tAttribute:\tEIATTR_MAX_THREADS
\tFormat:\tEIFMT_SVAL
\tValue:\t0x100 0x1 0x1
"""

SOURCE = """
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_tc_kernel(const bf16* __restrict__ q) {}
template <bool kVec, int kG>
__global__ void __launch_bounds__(32 * kWarpsPerBlock)
edge_softmax_bwd_kernel(const Args p) {}
"""


def test_resource_parser_reads_the_captured_dump():
    stats = stats_from_text("fixture", USAGE, ELF, SOURCE)
    assert [(s.kernel, s.registers, s.static_smem, s.spill_bytes,
             s.max_threads, s.min_blocks) for s in stats] == [
        ("flash_tc_kernel", 128, 1024, 0, 256, 2),
        ("flash_tc_kernel", 128, 1024, 0, 256, 2),
        ("edge_softmax_bwd_kernel", 64, 0, 16, 256, 1)]
    # within the budget (128 x 256 x 2 is the SM's 65,536 exactly); the
    # spill is a warning, not an error
    findings = check_stats(stats, Budget())
    assert [(f.rule, f.severity) for f in findings] == [
        ("cuda.resources", "warning")]
    assert "spilled" in findings[0].message


def test_resource_budget_flags_shared_memory_and_registers():
    flash = stats_from_text("fixture", USAGE, ELF, SOURCE)[0]
    flash.dynamic_smem = {"D=128": 232_448}       # + 1,024 static: over
    [f] = check_stats([flash], Budget())
    assert f.severity == "error" and "shared memory" in f.message
    flash.dynamic_smem = {"D=128": 231_424}       # exactly the budget
    assert check_stats([flash], Budget()) == []
    flash.registers = 129                         # x 256 x 2 > 65,536
    [f] = check_stats([flash], Budget())
    assert f.severity == "error" and "65536" in f.message
    flash.registers = 256
    assert len(check_stats([flash], Budget())) == 2    # > 255 as well


def test_launch_bounds_of_the_sources():
    """Every source's __global__ functions are found: 13, and only the
    bf16 attention kernel promises a minimum of blocks per SM."""
    found = {}
    for src in sorted(build.CSRC.glob("*.cu")):
        found.update(launch_bounds(src.read_text()))
    assert len(found) == 13
    assert {k: v for k, v in found.items() if v != 1} == {
        "flash_tc_kernel": 2}


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.device import resolve_device
    return resolve_device("cuda")


@pytest.mark.cuda
def test_cuda_combine_route_clean(cuda):
    """Each GNN kernel's CUDA route, forward and backward, recorded: the
    Sum-stage rules and cuda.resources find no error."""
    report = Report(cuda, Budget())
    check_combine_modes(report)
    assert report.errors == []
    assert report.contexts == 4
    assert {(c["kernel"], c["route"]) for c in report.launches} == {
        (k, "cuda") for k in ("segment_sum", "segment_sum_bwd",
                              "segment_max", "segment_max_bwd",
                              "edge_softmax", "edge_softmax_bwd")}


@pytest.mark.cuda
def test_cuda_recorder_sees_backward(cuda):
    _, log = _combine_step(cuda)
    assert [e.name for e in log.kernels()][-1] == "kernel:segment_sum_bwd"
    assert "cos" in {e.name for e in log}


@pytest.mark.cuda
def test_cuda_host_transfer_flagged(cuda):
    x = torch.ones(8, device=cuda)
    assert _ids(_run(lambda: (x * 2).cpu(), "ops.host-transfer")) == {
        "ops.host-transfer"}
    assert _run(lambda: x * 2, "ops.host-transfer") == []


@pytest.mark.cuda
def test_cuda_static_inputs_on_a_captured_step(cuda):
    from repro_torch.config import GNNConfig
    from repro_torch.core.strategies import strategy_views
    from repro_torch.core.trainer import CompactTrainer
    from repro_torch.models import make_gnn
    from repro_torch.optim import adam

    g = _small_graph()
    cfg = GNNConfig(model="gcn", num_layers=2, hidden_dim=16, num_classes=4,
                    feature_dim=8, aggregate_backend="csc")
    views = list(strategy_views(g, "mini", K=2, seed=0, steps=3,
                                batch_nodes=16, compact=True))
    tr = CompactTrainer(make_gnn(cfg), g, adam(1e-2), device=cuda)
    tr.fit(iter(views[:2]), prefetch=False)
    captures, before = dict(tr.captures), _state(tr)
    log = tr.traced_step_ops(views[2])
    expected = tr.expected_static(views[2])
    assert expected > 0
    assert run_rules(OpContext(log, expect_static=expected),
                     ids=["ops.static-inputs"]) == []
    assert _ids(run_rules(OpContext(log, expect_static=expected + 1),
                          ids=["ops.static-inputs"])) == {
        "ops.static-inputs"}
    assert tr.captures == captures
    _same_state(before, _state(tr))
    tr.assert_compiled_per_bucket()

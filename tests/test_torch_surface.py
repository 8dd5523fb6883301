"""The JAX package's public surface against the port's.

An ``ast`` walk of every ``src/repro/**/*.py`` lists each module's public
top-level names (functions, classes, assigned names) and each package
``__init__``'s exports. Every one of them must resolve in ``repro_torch``:

- under the same name in the counterpart module (``repro.a.b`` ->
  ``repro_torch.a.b``);
- or through :data:`MAPPING`, to the port's counterpart under another
  name or in another module, which the test imports;
- or it is waived in :data:`WAIVERS` for one of :data:`REASONS`, and only
  for the names each reason lists: what exists only because the
  reference runs on JAX and a TPU.

One case per module of the JAX package, plus the tables' own checks.
"""
import ast
import importlib
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"

PALLAS = "Pallas kernel → `kernels/csrc` via `kernels/ops.py`"
XLA = "XLA lowering or cost parsing; the port traces (ROADMAP C.29)"
JAXPR = "jaxpr/VMEM analysis → `oplog.py`/`resources.py`"
SHIM = "JAX version shim"
REASONS = (PALLAS, XLA, JAXPR, SHIM)

# "repro.module.name" -> "repro_torch.module.name" of its counterpart
MAPPING = {
    # the analysis vocabulary over recorded torch ops (ROADMAP A.11)
    **{f"repro.analysis.jaxpr.{n}": f"repro_torch.analysis.oplog.{n}"
       for n in ("ContractError", "Finding", "Rule", "RULES", "register",
                 "rule", "run_rules", "check_or_raise",
                 "count_segment_scatters")},
    "repro.analysis.jaxpr.JaxprContext":
        "repro_torch.analysis.oplog.OpContext",
    "repro.analysis.JaxprContext": "repro_torch.analysis.OpContext",
    "repro.analysis.vmem.KernelStats":
        "repro_torch.analysis.resources.KernelStats",
    "repro.analysis.vmem.check_vmem":
        "repro_torch.analysis.resources.check_stats",
    "repro.analysis.check_vmem": "repro_torch.analysis.check_stats",
    # a mesh axis name in the reference's collectives; the port's engine
    # holds a communicator instead
    "repro.core.engine.Axis": "repro_torch.core.comm.Comm",
    # the once-per-bucket callable lives with the server that uses it
    "repro.core.trainer.BucketedFn": "repro_torch.serving.server.BucketedFn",
    # the build_*csc_plan* functions live in the port's plan module
    **{f"repro.kernels.ops.{n}": f"repro_torch.kernels.plan.{n}"
       for n in ("build_csc_plan", "build_bucket_csc_plan",
                 "build_csc_plans_stacked")},
    "repro.kernels.segment_sum.NEG": "repro_torch.kernels.ref.NEG",
    # the link between chips: TPU ICI -> NVLink
    "repro.launch.mesh.ICI_BW": "repro_torch.launch.mesh.NVLINK_BW",
    # the GNN zoo's layer factories -> its TGARLayer modules
    **{f"{m}.{n}_layer": f"repro_torch.models.gnn_zoo.{c}Layer"
       for m in ("repro.models", "repro.models.gnn_zoo")
       for n, c in (("gcn", "GCN"), ("sage", "SAGE"), ("gat", "GAT"),
                    ("gat_e", "GATE"))},
}

# reason -> the names it waives, and no others
WAIVERS = {
    PALLAS: ("repro.kernels.segment_sum.segment_sum_csc",
             "repro.kernels.segment_sum.segment_max_csc",
             "repro.kernels.edge_softmax.edge_softmax_csc",
             "repro.kernels.backward.segment_sum_bwd_csc",
             "repro.kernels.backward.segment_max_bwd_csc",
             "repro.kernels.backward.edge_softmax_bwd_csc",
             "repro.kernels.flash_attention.flash_attention",
             "repro.kernels.wkv6.wkv6"),
    XLA: ("repro.launch.roofline.extract_costs",
          "repro.launch.roofline.parse_collective_bytes",
          "repro.launch.roofline.combine_calibrated",
          "repro.launch.dryrun.lower_train",
          "repro.launch.dryrun.lower_prefill",
          "repro.launch.dryrun.lower_decode",
          "repro.launch.dryrun.lower_step",
          "repro.launch.sharding.named"),
    JAXPR: ("repro.analysis.jaxpr.jaxpr_eqns",
            "repro.analysis.jaxpr.jaxpr_avals",
            "repro.analysis.jaxpr.pallas_src",
            "repro.analysis.vmem.DEFAULT_VMEM_BUDGET",
            "repro.analysis.vmem.analyze_pallas_eqn",
            "repro.analysis.vmem.iter_kernel_stats",
            "repro.analysis.jaxpr_eqns", "repro.analysis.jaxpr_avals",
            "repro.analysis.DEFAULT_VMEM_BUDGET",
            "repro.analysis.analyze_pallas_eqn",
            "repro.analysis.iter_kernel_stats"),
    SHIM: ("repro.utils.compat.shard_map",),
}
WAIVED = {name: reason for reason, names in WAIVERS.items()
          for name in names}


def _module_name(path: Path) -> str:
    parts = path.relative_to(ROOT / "src").with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


MODULES = {_module_name(p): p for p in sorted(REF.rglob("*.py"))}


def public_names(path: Path) -> list:
    """The module's public top-level definitions and assigned names; for
    a package ``__init__`` also the names it imports (its exports)."""
    init = path.name == "__init__.py"
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            names.append(node.target.id)
        elif init and isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return [n for n in dict.fromkeys(names)
            if not n.startswith("_") and n != "__all__"]


def _port_module(module: str):
    """The counterpart module, or None where the port has none."""
    name = module.replace("repro", "repro_torch", 1)
    if importlib.util.find_spec(name) is None:
        return None
    return importlib.import_module(name)


def _resolve(dotted: str):
    module, _, name = dotted.rpartition(".")
    return getattr(importlib.import_module(module), name)


@pytest.mark.parametrize("module", sorted(MODULES))
def test_every_public_name_resolves_in_the_port(module):
    port = _port_module(module)
    missing = []
    for name in public_names(MODULES[module]):
        qual = f"{module}.{name}"
        if port is not None and hasattr(port, name):
            continue
        if qual in MAPPING:
            _resolve(MAPPING[qual])
            continue
        if qual not in WAIVED:
            missing.append(name)
    assert not missing, (f"{module}: no counterpart in the port for "
                         f"{missing}; port it, or map it in MAPPING")


def test_the_tables_name_only_what_the_walk_lists():
    """A mapping or a waiver of a name the JAX package does not define, or
    that the port has under the same name, is stale."""
    listed = {f"{m}.{n}" for m, p in MODULES.items()
              for n in public_names(p)}
    for qual in list(MAPPING) + list(WAIVED):
        assert qual in listed, f"{qual} is not a public name of repro"
        module, _, name = qual.rpartition(".")
        port = _port_module(module)
        assert port is None or not hasattr(port, name), (
            f"{qual} has a counterpart under its own name")
    assert not set(MAPPING) & set(WAIVED)


def test_waivers_take_only_the_closed_reasons():
    assert set(WAIVERS) == set(REASONS)
    prefixes = {PALLAS: ("repro.kernels.segment_sum.",
                         "repro.kernels.edge_softmax.",
                         "repro.kernels.backward.",
                         "repro.kernels.flash_attention.",
                         "repro.kernels.wkv6."),
                XLA: ("repro.launch.roofline.", "repro.launch.dryrun.",
                      "repro.launch.sharding."),
                JAXPR: ("repro.analysis.",),
                SHIM: ("repro.utils.compat.",)}
    for reason, names in WAIVERS.items():
        for qual in names:
            assert qual.startswith(prefixes[reason]), (reason, qual)


def test_the_walk_sees_the_sum_stage_and_the_helpers():
    """The names this slice ported, which the walk must list (so that
    their cases above hold them)."""
    assert {"segment_sum", "segment_mean", "segment_max", "segment_softmax",
            "combine_messages", "NEG"} <= set(public_names(
                MODULES["repro.core.tgar"]))
    assert "train_gnn" in public_names(MODULES["repro.launch.train"])
    assert "mha_ref" in public_names(MODULES["repro.kernels.ref"])
    assert {"tree_add", "tree_scale"} <= set(public_names(
        MODULES["repro.utils"]))
    assert len(MODULES) > 80

"""The benchmark's files: every cell finds its configuration, traffic
mix, limits, metric readers, model reference and FLOP count, strategy
and graph generator by name; ``BENCHMARK.json`` keeps the shapes and
limits its format sets; nothing imports JAX or the JAX package, and the
yardstick (the reference, the strategies' step graphs, the generators,
the counts) imports nothing of the program."""
import ast
import json
import re
from pathlib import Path

import pytest

from bench_h100 import spec as specs

BENCH = Path(specs.__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCHMARK = specs.load_benchmark()
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
YARDSTICK = ("reference", "strategies", "data", "counts")
# a model's file: the default form (a stack of layers and a decoder) or
# the declared form (its own parameters and forward pass; ``loss`` and
# ``initial`` optional); its counts: a layer's FLOPs or the whole step's
MODEL_FORMS = (("layer_shapes", "edge_inputs", "layer"),
               ("param_shapes", "edge_inputs", "logits"))
COUNT_FORMS = ("layer_flops", "train_step_flops")
# the harness's own files, which find every model by name
GENERAL = ("reference/train.py", "counts/__init__.py", "program.py")


@pytest.mark.parametrize("workload", CELLS)
def test_every_cell_resolves_by_name(workload):
    c = specs.load_cell(BENCHMARK, workload)
    cfg, mix = c["cfg"], c["mix"]
    assert cfg["name"] == c["cell"]["config"]
    assert set(c["limits"]) == {"loss_rel", "grad1_rel", "change_rel"}
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(specs.reader(m["name"]))
    model = specs.piece("reference", cfg["model"])
    assert any(all(callable(getattr(model, f, None)) for f in form)
               for form in MODEL_FORMS)
    assert all(callable(getattr(model, f)) for f in ("loss", "initial")
               if hasattr(model, f))
    steps = specs.piece("counts", cfg["model"])
    assert any(callable(getattr(steps, f, None)) for f in COUNT_FORMS)
    strategy = specs.piece("strategies", mix["strategy"])
    assert callable(strategy.step_graphs) and callable(strategy.warmup_steps)
    assert callable(specs.piece("data", mix["graph"]["generator"]).make)
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and c["per_layer"]


@pytest.mark.parametrize("path", GENERAL)
def test_the_harness_names_no_model(path):
    models = {p.stem for p in (BENCH / "reference").glob("*.py")} \
        - {"__init__", "train"}
    text = (BENCH / path).read_text()
    assert models and not [m for m in models if re.search(
        rf"\b{re.escape(m)}\b", text, re.IGNORECASE)]


def test_benchmark_json_keeps_its_format():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["bench_h100"] and 1 <= b["run_seconds"] <= 51
    names = {}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench_h100/")
        cfg = json.loads((BENCH.parent / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert all(len(c[k]) <= 200 for k in ("source", "why"))
        names[c["name"]] = c
    four = 0
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        pairs.add((w["config"], w["traffic"]))
        four += w["chips"] == 4
    assert len(pairs) == len(b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    reporting = {m["name"]: set(m.get("workloads", CELLS))
                 for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}
        assert set(m["workloads"]) <= reporting[m["moves"]]
    everything = b["configs"] + b["workloads"] + b["end_to_end"] \
        + b["per_layer"]
    assert all(NAME.match(x["name"]) for x in everything)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in b["end_to_end"] + b["per_layer"])
    assert len({x["name"] for x in everything}) == len(everything)


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            out.add(node.module)
    return out


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_loads_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    if set(YARDSTICK) & set(path.relative_to(BENCH).parts):
        assert "repro_torch" not in tops

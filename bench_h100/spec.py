"""Where the benchmark's pieces are, found by the names that
``BENCHMARK.json`` and the files it points to give: a cell's
configuration file, its traffic mix (``traffic/<traffic>.json``), its
correctness limits (``limits/<workload>.json``), and one module a name
(:func:`piece`): the reader of each metric (``metrics/<metric>.py``),
the reference and the FLOP count of each model (``reference/<model>.py``,
``counts/<model>.py``), the step graphs of each strategy
(``strategies/<strategy>.py``) and each graph generator
(``data/<generator>.py``)."""
from __future__ import annotations

import copy
import importlib.util
import json
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(bench: dict, workload: str, overrides=None) -> dict:
    """``{"cell", "cfg", "mix", "limits", "end_to_end", "per_layer"}``
    for the workload: its entry, configuration, traffic mix, limits,
    and the metrics it reports. ``overrides`` (``{"cfg": {...},
    "mix": {...}}``) replaces keys, as the CPU tests do to run a cell
    small."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"have {sorted(cells)}")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = _json(ROOT / configs[cell["config"]]["file"])
    mix = _json(BENCH / "traffic" / f"{cell['traffic']}.json")
    for part, over in (overrides or {}).items():
        target = {"cfg": cfg, "mix": mix}[part]
        for k, v in over.items():
            if isinstance(v, dict) and isinstance(target.get(k), dict):
                target[k] = {**target[k], **copy.deepcopy(v)}
            else:
                target[k] = copy.deepcopy(v)
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    return {"cell": cell, "cfg": cfg, "mix": mix,
            "limits": _json(BENCH / "limits" / f"{workload}.json"),
            "end_to_end": e2e, "per_layer": per_layer}


def piece(kind: str, name: str):
    """The module ``<kind>/<name>.py`` under the benchmark's folder,
    loaded once a process (a name may hold dots, or be a keyword such
    as ``global``)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"no {kind} piece {name!r}: {path} is missing")
    key = "bench_h100_{}_{}".format(
        kind, name.replace(".", "_").replace("-", "_"))
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[key] = mod
    return sys.modules[key]


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    return piece("metrics", metric).read

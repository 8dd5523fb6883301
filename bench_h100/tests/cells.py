"""Each cell at a test's size, for the CPU tests: a few hundred nodes and
a few steps, at the configuration's widths. A cell's overrides are
``small/<workload>.json``, found by its name."""
import json
from pathlib import Path

SMALL = {p.name[:-len(".json")]: json.loads(p.read_text())
         for p in sorted((Path(__file__).resolve().parent / "small")
                         .glob("*.json"))}
# the GAT-E cell's mix over two ranks (gloo on the CPU), each holding one
# partition of the engine: the harness's path for a cell over cards
TWO_RANKS = {"ranks": 2, "engine_partitions": 2,
             "partition_method": "1d_src"}

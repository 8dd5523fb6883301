"""On the card (``cuda``-marked; each test looks for a card itself and
skips where there is none): the command's result line, and the control,
the reference in TF32 put in the program's place, failing the
comparison at a test's size. The control at the cells' own sizes is
``bench_h100/readings.py --what control``."""
import json
import subprocess
import sys

import pytest

from bench_h100 import check, program, spec as specs
from bench_h100.data import make_graph
from bench_h100.reference.train import make_params

BENCH = specs.load_benchmark()

# each cell's graph at a size a test run holds on the card
CONTROL = {
    "gat_e.alipay_share.global": {"cfg": {"num_nodes": 20000}},
    "gcn.reddit_quarter.global": {"cfg": {"num_nodes": 4000}},
}


def _card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_the_command_prints_a_correct_result_line():
    _card()
    out = subprocess.run(
        [sys.executable, str(specs.BENCH / "run.py"), "--workload",
         "gat_e.alipay_share.global", "--seed", "3000000017", "--seconds", "1",
         "--trace", "0"], cwd=specs.ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", sorted(CONTROL))
def test_the_tf32_control_is_not_correct(workload):
    dev = _card()
    c = specs.load_cell(BENCH, workload, CONTROL[workload])
    cfg, mix = c["cfg"], c["mix"]
    for seed in (1, 2, 3):
        g = make_graph(cfg, mix, seed, dev)
        params0 = {k: v.cpu() for k, v in make_params(cfg, seed, dev).items()}
        ref = check.reference_readings(cfg, mix, g, params0, seed,
                                       program.CHECK_STEPS, dev)
        ctl = check.reference_readings(cfg, mix, g, params0, seed,
                                       program.CHECK_STEPS, dev, tf32=True)
        assert not check.verdict(check.compare(ctl, ref), c["limits"])

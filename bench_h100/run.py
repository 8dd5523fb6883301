"""Run one cell of the benchmark of ``repro_torch`` once and print its
result as the last line of standard output::

    python3 bench_h100/run.py --workload gat_e.alipay200k.global \
        --seed 1234 --seconds 10 --trace 0

Exits 2 without a result where the host lacks the cards the cell asks
for, and 3 where the run loaded JAX or the JAX package."""
import time

T0 = time.time()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    from bench_h100 import harness
    return harness.main(args.workload, args.seed, args.seconds, args.trace,
                        T0)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python benchmarks/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

A cell is an entry of `workloads` in BENCHMARK.json. Everything that
belongs to it is found by name: `benchmarks/workloads/<cell>.json` (the
traffic, naming its configuration), `benchmarks/configs/<config>.json` (the
deployment, naming its driver), `benchmarks/drivers/<driver>.py` and, for
each per-layer metric, `benchmarks/layers/<metric>.py`. The harness itself
is `benchmarks/harness.py`.

Exits non-zero, printing no result, when no CUDA device is present or fewer
than the cell asks for, when the checkout holds no program, and when JAX or
the JAX package is loaded once the window has closed.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmarks import harness
    return harness.run(ROOT, args.workload, args.seed, args.seconds,
                       bool(args.trace), T_PROCESS)


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Readings for the limits of a cell's check: the program's numbers and
its control's, over many seeds in one process, at the cell's own size.

    python benchmarks/calibrate.py --workload <name> --seeds <first> <count> [--control 0|1]

For each seed: the inputs from the seed, one decode through the program
(the first seed's decode also warms up), the check's numbers against the
plain reference, and with `--control 1` the control's numbers (the
reference in the next lower precision, in the program's place) and the
readings of the faults the driver plants in the reference put in the
program's place, where it has any. One JSON line a seed; the limits in
the configuration are set from these readings (PERF.md gives them).
"""
import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", nargs=2, type=int, required=True)
    ap.add_argument("--control", type=int, default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from benchmarks import harness
    spec = harness.resolve(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    driver = harness.load_module(spec["driver"], "bench_driver")
    first, count = args.seeds
    for seed in range(first, first + count):
        with tempfile.TemporaryDirectory(prefix="bench_cal_") as wd:
            t0 = time.perf_counter()
            st = driver.setup(spec["cfg"], spec["traffic"], seed, dev, wd)
            rec = driver.decode_once(st, True)
            t1 = time.perf_counter()
            driver.release(st)
            numbers, failed = driver.check(st, [rec])
            t2 = time.perf_counter()
            line = {"seed": seed, "program": {k: v for k, v, _ in numbers},
                    "failed": failed, "decode_s": round(t1 - t0, 3),
                    "check_s": round(t2 - t1, 3)}
            if args.control:
                line["control"] = driver.control(st)
                if hasattr(driver, "planted"):
                    line["planted"] = driver.planted(st)
                line["control_s"] = round(time.perf_counter() - t2, 3)
            print(json.dumps(line, default=str), flush=True)
            del st, rec
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

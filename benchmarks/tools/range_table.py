#!/usr/bin/env python3
"""The card's time by program range, from one traced run of a cell:

    python benchmarks/tools/range_table.py --workload <name> --seed <n> \
        --seconds <s> [--json <path>]

Runs the cell as `benchmarks/run.py --trace 1` does (its lines printed as
there), keeps the trace and its `Events` and prints, for each range the
program opened (`models.stages.span_names()`), a decode
(`benchmarks/ranges.py` reads the trace by range):

- n: ranges of that name;
- s: their summed length inside the window;
- busy: s less the idle `idle_by_range(ev, {name})` puts inside them;
- idle: the idle `idle_by_range(ev, span_names())` puts down to the range
  as the innermost open one (a child's idle goes to the child);
- launches: the host's kernel launch calls inside them (`launches_in`);

then "unranged" (idle under no range of the program's), the window's idle
share, and the sum of the idle column against the window's idle.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def table(ev, launches, names) -> dict:
    """The rows of `ev` (with its trace's `launch_times`) for the ranges
    `names`, a decode: {name: {"n", "s", "busy", "idle", "launches"}},
    with "unranged" ({"idle"}) and "window" ({"decodes", "idle_share",
    "idle_s", "idle_sum_s"})."""
    from benchmarks.ranges import idle_by_range, launches_in
    names = set(names)
    decodes = max(len(ev.spans), 1)
    innermost = idle_by_range(ev, names)
    rows = {}
    for name in sorted(names):
        got = [(max(s, ev.lo), min(e, ev.hi)) for s, e, n in ev.stages if n == name]
        got = [(s, e) for s, e in got if e > s]
        if not got:
            continue
        length = sum(e - s for s, e in got) * 1e-6
        inside = idle_by_range(ev, {name}).get(name, 0.0)
        rows[name] = {"n": len(got) / decodes, "s": length / decodes,
                      "busy": (length - inside) / decodes,
                      "idle": innermost.get(name, 0.0) / decodes,
                      "launches": launches_in(ev, launches, name) / decodes}
    idle_s = ev.window_s - ev.busy_s
    rows["unranged"] = {"idle": innermost["unranged"] / decodes}
    rows["window"] = {"decodes": len(ev.spans),
                      "idle_share": idle_s / ev.window_s if ev.window_s > 0 else 0.0,
                      "idle_s": idle_s, "idle_sum_s": sum(innermost.values())}
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--json", help="also write the rows here")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from benchmarks import harness, ranges, trace
    kept = []

    class Keeping(trace.Events):
        """`Events` that keeps its trace's launch calls."""

        def __init__(self, tr: dict):
            super().__init__(tr)
            kept.append((self, ranges.launch_times(tr)))

    trace.Events = Keeping      # `Tracer.stop` builds the window's `Events`
    rc = harness.run(ROOT, args.workload, args.seed, args.seconds, True, T_PROCESS)
    if rc != 0 or not kept:
        return rc or 1
    from directdemod_tpu_torch.models import stages
    rows = table(*kept[0], stages.span_names())
    print(f"{args.workload} (seed {args.seed}): range | n | s | busy | idle | launches")
    for name, r in rows.items():
        if name not in ("unranged", "window"):
            print(f"{name} | {r['n']:.4g} | {r['s']:.4g} | {r['busy']:.4g} | "
                  f"{r['idle']:.4g} | {r['launches']:.6g}")
    w = rows["window"]
    print(f"unranged | | | | {rows['unranged']['idle']:.4g} |")
    print(f"decodes {w['decodes']}, idle share {100 * w['idle_share']:.4g} %, "
          f"idle {w['idle_s']:.6g} s, by range {w['idle_sum_s']:.6g} s")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"workload": args.workload, "seed": args.seed, "rows": rows}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

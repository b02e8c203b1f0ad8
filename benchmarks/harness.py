"""The benchmark's harness: set-up, the measured window, the trace, the check.

One client decodes whole captures back to back in a closed loop. The window
starts a new decode while less than `--seconds` has elapsed and ends when
the last decode started completes, so it holds whole decodes only.

A configuration's driver (`benchmarks/drivers/<driver>.py`) gives:

- `setup(cfg, traffic, seed, device, workdir) -> state`: make the inputs
  from the seed (the capture, on the device or as a file), nothing timed;
- `decode_once(state, sample) -> record`: one whole decode through the
  program's entry, ending in `torch.cuda.synchronize()` or with its
  products on disk. The record keeps the products (small), the program's
  stage seconds and the kernels' least seconds; with `sample` it also keeps
  references to the large products the check compares for one decode;
- `capture_seconds(state) -> float`: seconds of signal a decode covers;
- `check(state, records) -> (numbers, failed)`: after the window, the
  comparison with the plain reference; `numbers` are (name, value, limit)
  with value <= limit passing, `failed` the number of records whose
  products failed;
- `release(state)`: drop the program's objects before the check runs.

Per-layer metrics are readers (`benchmarks/layers/<metric>.py`, a function
`read(ctx)` returning a number, or None when there is nothing to read);
`ctx` holds the window's decode records and the trace's `Events`.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

FORBIDDEN = ("jax", "jaxlib", "flax", "directdemod_tpu")


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(root: str, workload: str) -> dict:
    """The cell's manifest entry, traffic, configuration, driver path and
    metric entries, all found by name."""
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}")
    cell = cells[workload]
    bench = os.path.join(root, "benchmarks")
    with open(os.path.join(bench, "workloads", f"{workload}.json")) as f:
        traffic = json.load(f)
    if traffic["config"] != cell["config"]:
        raise SystemExit(f"{workload}: traffic names {traffic['config']}, "
                         f"BENCHMARK.json {cell['config']}")
    with open(os.path.join(bench, "configs", f"{cell['config']}.json")) as f:
        cfg = json.load(f)

    def applies(m):
        return "workloads" not in m or workload in m["workloads"]

    return {"cell": cell, "traffic": traffic, "cfg": cfg,
            "driver": os.path.join(bench, "drivers", f"{cfg['driver']}.py"),
            "end_to_end": [m for m in manifest["end_to_end"] if applies(m)],
            "per_layer": [m for m in manifest["per_layer"] if applies(m)],
            "layer_dir": os.path.join(bench, "layers")}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def run(root: str, workload: str, seed: int, seconds: float, trace: bool,
        t_process: float, device=None) -> int:
    """Run the cell once and print its result line; returns the exit code.
    `device` other than None (a CPU run) skips the look for a card: the
    tests use it at tiny sizes."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, ".bench_cache", "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, ".bench_cache",
                                                      "torch_extensions")
    os.environ.setdefault("USE_FLAX", "0")
    spec = resolve(root, workload)
    import torch
    chips = int(spec["cell"]["chips"])
    if device is None:
        if not torch.cuda.is_available():
            print("no CUDA device: the benchmark runs on the card only",
                  file=sys.stderr)
            return 2
        if torch.cuda.device_count() < chips:
            print(f"{workload} asks for {chips} cards, "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device(device)
    on_card = device.type == "cuda"
    driver = load_module(spec["driver"], f"bench_driver_{spec['cfg']['driver']}")
    rng = np.random.default_rng([seed, 0x5EED])

    with tempfile.TemporaryDirectory(prefix="bench_") as workdir:
        state = driver.setup(spec["cfg"], spec["traffic"], seed, device, workdir)
        warm = driver.decode_once(state, False)         # the cold decode
        del warm
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_process
        print(f"set-up {setup_s:.3f} s on "
              f"{card_line() if on_card else device}", flush=True)

        tracer = None
        if trace:
            from benchmarks.trace import Tracer
            tracer = Tracer(workdir, on_card)
            tracer.start()
        records, walls = [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            i = len(records) + 1
            sample = rng.random() < 1.0 / i        # reservoir: one decode kept
            if sample:
                for r in records:
                    r.pop("heavy", None)
            ts = time.perf_counter()
            with (tracer.span("bench.decode") if tracer else _null()):
                rec = driver.decode_once(state, sample)
            walls.append(time.perf_counter() - ts)
            records.append(rec)
        window_s = time.perf_counter() - t0
        events = tracer.stop() if tracer else None
        peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
        cap_s = driver.capture_seconds(state)

        print(f"window {window_s} s, {len(records)} decodes of {cap_s} s, "
              f"walls {json.dumps(walls)}", flush=True)
        stages = {}
        for r in records:
            for k, v in r.get("stage_seconds", {}).items():
                stages.setdefault(k, []).append(v)
        print("stage seconds a decode (mean over the window): "
              + json.dumps({k: round(sum(v) / len(v), 4) for k, v in stages.items()}),
              flush=True)
        print("launches a decode: " + json.dumps(records[-1].get("launches", {}))
              + f", peak device memory {peak} B", flush=True)

        metrics = {}
        device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device)
                       if on_card else "cpu", "count": chips,
                       "memory_peak_bytes": peak}
        breakdown = None
        if trace:
            ctx = {"records": records, "events": events}
            for m in spec["per_layer"]:
                reader = load_module(os.path.join(spec["layer_dir"], f"{m['name']}.py"),
                                     "bench_layer_" + m["name"].replace(".", "_"))
                v = reader.read(ctx)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            if events is not None:
                device_info["busy_s"] = events.busy_s
                device_info["window_s"] = events.window_s
                breakdown = events.breakdown()
        else:
            e2e = {"setup_s": setup_s,
                   "realtime_x": len(records) * cap_s / window_s,
                   "decode_p95_s": percentile(walls, 95)}
            for m in spec["end_to_end"]:
                metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}

        driver.release(state)
        numbers, failed = driver.check(state, records)

    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    ok_numbers = all(v <= lim for _, v, lim in numbers)
    correct = bool(records) and failed == 0 and ok_numbers
    checks = {name: {"value": v, "limit": lim} for name, v, lim in numbers}
    print(f"correct {correct}: {failed} of {len(records)} decodes failed",
          file=sys.stderr)
    for name, v, lim in numbers:
        print(f"check {name}: {v!r} (limit {lim!r}) "
              f"{'ok' if v <= lim else 'FAILS'}", file=sys.stderr, flush=True)
    result = {"correct": correct, "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def finite_or(v: float, big: float) -> float:
    """A comparison's value as a finite number: nan and inf read as `big`
    (beyond any limit)."""
    return big if not math.isfinite(v) else float(v)

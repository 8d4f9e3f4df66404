"""One run of one cell of ``BENCHMARK.json``.

Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, whose ``regime`` names its module in
``regimes/``; its traffic mix in ``traffic/<traffic>.json``, whose
``kind`` names the module in ``kinds/`` that builds the system under test;
the limits of its comparison in ``limits/<workload>.json``; and each
metric's reader in ``metrics/<metric>.py``, a module with ``read(run) ->
float | None``. Adding a cell, a configuration, a mix, a kind of traffic, a
regime or a metric adds files and entries and edits none.

A run: set-up (inputs from the seed, the program built, its steps captured
and warmed), then with ``--trace 0`` the window, which runs units of
traffic back to back until ``--seconds`` have passed and ends in a device
synchronise, giving the cell's end-to-end metrics; with ``--trace 1``
instead ``trace_units`` units under ``torch.profiler``, giving its per-layer
metrics. Then the program's state is freed, the reference recomputes what
the timed path produced, and the result line is printed.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from perfbench import parts, trace

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that no run may load: JAX, its libraries, the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "lvae_tpu")


class Cell(NamedTuple):
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, its files found by name; its
    metrics are those that name it."""
    bench = json.loads(bench_path.read_text())
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in {bench_path.name}: {sorted(by_name)}")
    w = by_name[name]
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    config = json.loads((ROOT / conf["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{w['traffic']}.json").read_text())
    limits = json.loads((HERE / "limits" / f"{name}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(w, config, traffic, limits, e2e, per_layer)


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("perfbench_metric_" + metric.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Run(NamedTuple):
    """What a metric's reader reads: the cell, the traced window (None in
    an untraced run), the work done in the window (its ``seconds``, and
    what the kind counts: ``frames``, ``steps``, ``flops``; untraced also
    ``setup_s``) and the peak of the device memory the allocator held in
    it."""

    config: dict
    traffic: dict
    window: Optional[trace.Window]
    work: dict
    peak_bytes: int


def readings(metrics: List[dict], run: Run) -> dict:
    """Each of ``metrics`` that its reader finds, with its unit."""
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def loaded_forbidden() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, t0: float,
             device: str = "cuda") -> Tuple[dict, List[str]]:
    """One run of ``cell`` on ``device``; returns the result line as a dict
    and notes for the standard error (the set-up's phases). ``t0`` is the
    host clock at the process's start."""
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    # the host's share of a step (draws, launches) is timed too: one
    # thread, so that idle pool threads compete less for the host's cores
    torch.set_num_threads(1)
    sut = parts.find("kinds", cell.traffic["kind"]).make(cell.config, cell.traffic, seed,
                                                          device)
    started = time.perf_counter() - t0
    sut.setup()
    sync()
    peak_setup = torch.cuda.max_memory_reserved() if cuda else 0
    breakdown = None
    if traced:
        from torch.profiler import ProfilerActivity, profile, record_function

        units = cell.traffic["trace_units"]
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts) as prof:
            with record_function(trace.WINDOW):
                for _ in range(units):
                    sut.unit()
                sync()
        peak_window = torch.cuda.max_memory_reserved() if cuda else 0
        window = trace.reduce(trace.events_of(prof))
        del prof
        run = Run(cell.config, cell.traffic, window, sut.work(units, window.window_s),
                  peak_window)
        metrics = readings(cell.per_layer, run)
        breakdown = window.breakdown()
        dev_extra = {"busy_s": window.busy_s, "window_s": window.window_s}
        peak = max(peak_setup, peak_window)
    else:
        sync()
        start = time.perf_counter()
        setup_s = start - t0
        units = 0
        while time.perf_counter() - start < seconds:
            sut.unit()
            units += 1
        sync()
        elapsed = time.perf_counter() - start
        peak = torch.cuda.max_memory_reserved() if cuda else 0
        run = Run(cell.config, cell.traffic, None, {**sut.work(units, elapsed), "setup_s": setup_s},
                  peak)
        metrics = readings(cell.end_to_end, run)
        dev_extra = {}
    attempted, failed = sut.attempted, sut.failed
    sut.release()
    gaps = sut.gaps()
    checks = {}
    for name, value in gaps.items():
        checks[name] = {"value": value, "limit": cell.limits[name]["limit"]}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.workload["chips"] if cuda else 1,
           "memory_peak_bytes": int(peak), **dev_extra}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    notes = [f"setup {name} {sec:.3f} s" for name, sec in [("start", started)] + sut.phases.done]
    return out, notes


def check_lines(checks: Dict[str, dict]) -> List[str]:
    return [f"check {k} {c['value']!r} limit {c['limit']!r}" for k, c in checks.items()]


def main(argv: Optional[List[str]], t0: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json on the card.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")
    cell = load(args.workload)
    chips = cell.workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: {args.workload} needs {chips} CUDA device(s), found {n}",
              file=sys.stderr)
        return 2
    result, notes = run_cell(cell, args.seed, args.seconds, bool(args.trace), t0)
    bad = loaded_forbidden()
    if bad:
        print(f"perfbench: the run loaded {bad}, which the port must not import", file=sys.stderr)
        return 3
    for line in notes:
        print(line, file=sys.stderr)
    for line in check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0

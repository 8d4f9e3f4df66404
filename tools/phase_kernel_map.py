"""Device time of one eager training epoch of a benchmark cell, by phase and
by the op that launched each kernel.

Builds the cell's trainer from ``perfbench`` on the seed's inputs, runs two
eager epochs to warm up, then one more under ``torch.profiler``. With the
profiler on, an eager step opens a ``record_function`` range for each phase
(``vae_forward``, ``gp_forward``, ``gp_backward``, ``vae_backward``,
``update``; ``lvae_torch/utils/metrics.py``). Each kernel is put to the
phase whose range holds its launch and to the chain of CPU ops around the
launch on the launching thread. Prints the phases' device ms and the
largest rows; ``--out`` writes every row to a JSON file.

    python tools/phase_kernel_map.py --workload hmnist_closed.train --seed 1234567

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PHASES = ("vae_forward", "gp_forward", "gp_backward", "vae_backward", "update")


def build_trainer(workload: str, seed: int):
    from perfbench import harness, parts
    from perfbench.inputs import Maker
    from perfbench.reference import gp as rg

    cfg = harness.load(workload).config
    parts.set_precision(cfg)
    regime = parts.find("regimes", cfg["regime"])
    mk = Maker(seed, torch.device("cuda"))
    data = mk.cohort(cfg, range(cfg["P"]), cfg["pixel_missing"])
    regime.inputs(mk, cfg, data)
    state = mk.state(cfg, rg.split_components(cfg))
    model = parts.model(cfg, state, torch.float32)
    return regime.build(cfg, data, model, seed, torch.device("cuda"), torch.float32)


def trace_events(trainer) -> list:
    from torch.profiler import ProfilerActivity, profile

    from lvae_torch.train.graph import eager_steps

    with eager_steps():
        trainer.run_epochs(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with eager_steps():
            trainer.run_epochs(1)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def kernel_rows(events: list):
    """(device ms by phase, rows ``[phase, op chain, kernel, ms, count]``
    sorted by ms)."""
    phases = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e.get("name") in PHASES)
    launch = {e["args"]["correlation"]: (e["ts"], e["tid"]) for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    ops = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op":
            ops[e["tid"]].append((e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
    rows = collections.defaultdict(lambda: [0.0, 0])
    total = collections.defaultdict(float)
    for e in events:
        if e.get("cat") != "kernel":
            continue
        ts, tid = launch.get(e["args"].get("correlation"), (None, None))
        phase = next((n for a, b, n in phases if ts is not None and a <= ts <= b), "none")
        chain = ([n for a, b, n in sorted(ops.get(tid, [])) if a <= ts <= b]
                 if ts is not None else [])
        key = (phase, " > ".join(chain), e["name"])
        rows[key][0] += e["dur"] / 1e3
        rows[key][1] += 1
        total[phase] += e["dur"] / 1e3
    out = sorted(([*k, round(v[0], 4), v[1]] for k, v in rows.items()), key=lambda r: -r[3])
    return dict(total), out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="hmnist_closed.train")
    ap.add_argument("--seed", type=int, default=1234567)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--out", help="a JSON file for every row")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("phase_kernel_map: needs a CUDA device", file=sys.stderr)
        return 2
    total, rows = kernel_rows(trace_events(build_trainer(args.workload, args.seed)))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "seed": args.seed,
                       "device": torch.cuda.get_device_name(0), "phase_ms": total,
                       "rows": rows}, f, indent=1)
    print(json.dumps({"phase_ms": {k: round(v, 3) for k, v in total.items()}}))
    for phase, chain, kernel, ms, n in rows[:args.top]:
        print(f"{phase:12s} {ms:9.3f} ms {n:5d}  {chain[-90:]}  |  {kernel[:70]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings that each limit of ``limits/<workload>.json`` is set from.

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 [--control-seeds 3] \
        [--out readings.json]

For every seed, in one process, at the cell's own size: the program's
numbers, as a run of the benchmark compares them (the lower readings). For
the first ``--control-seeds`` seeds also the control, the reference itself
put in the program's place and computed with TF32 on in its matrix products
and convolutions (the step below the configuration's float32 with TF32 off),
and two faults planted in the program where the window runs it, in the
captured step that it replays: half of each batch left out with the mean
taken over the rest (the regime's ``half_batch``), and a replay that leaves
the step's fixed inputs as they were (every compared step then trains on
the batch and noise that the inputs last held). A step that leaves its
state unchanged reads 1 on the change by construction. Not run by the
benchmark's own runs.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from perfbench import harness, parts  # noqa: E402
from perfbench.reference import steps as rs  # noqa: E402


@contextlib.contextmanager
def stale_inputs():
    """Every replay of a captured step runs on the fixed inputs it already
    holds: the copies of the new batch into them are left out."""
    from lvae_torch.train import graph

    real = graph.CapturedStep.replay

    def replay(self, *inputs):
        self.graph.replay()
        graph.add_launches(self.launches)
        return self.out

    graph.CapturedStep.replay = replay
    try:
        yield
    finally:
        graph.CapturedStep.replay = real


def _program(cell, seed: int, device, fault=contextlib.nullcontext):
    """The cell's system under test, set up (its compared steps run) under
    ``fault`` and released."""
    sut = parts.find("kinds", cell.traffic["kind"]).make(cell.config, cell.traffic, seed, device)
    with fault():
        sut.setup()
    sut.release()
    return sut


def train_readings(cell, seed: int, with_control: bool, device) -> dict:
    sut = _program(cell, seed, device)
    ref = sut.reference()
    out = {"program": _names(rs.train_gaps(sut.run_trace, ref))}
    if with_control:
        out["control_tf32"] = _names(rs.train_gaps(sut.reference(tf32=True), ref))
        for name, fault in (("fault_half_batch_replay", lambda: sut.regime.half_batch(True)),
                            ("fault_stale_inputs", stale_inputs)):
            out[name] = _names(rs.train_gaps(_program(cell, seed, device, fault).run_trace, ref))
    return out


def _names(g: dict) -> dict:
    return {f"{k}_gap": v for k, v in g.items()}


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cell = harness.load(args.workload)
    device = "cuda" if torch.cuda.is_available() else "cpu"
    seeds = [int(s) for s in args.seeds.split(",")]
    rows = []
    for i, seed in enumerate(seeds):
        t0 = time.perf_counter()
        row = train_readings(cell, seed, i < args.control_seeds, device)
        row.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(row), flush=True)
        rows.append(row)
    summary = {}
    for kind in ("program", "control_tf32", "fault_half_batch_replay", "fault_stale_inputs"):
        got = [r[kind] for r in rows if kind in r]
        if got:
            summary[kind] = {k: {"max": max(g[k] for g in got), "min": min(g[k] for g in got)}
                             for k in got[0]}
    print(json.dumps({"workload": args.workload, "summary": summary}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"workload": args.workload, "device": device, "rows": rows,
                       "summary": summary}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())

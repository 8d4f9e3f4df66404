"""Device time of one eager training epoch of a benchmark cell, by phase and
by the op that launched each kernel.

Builds the cell's trainer from ``perfbench`` on the seed's inputs, runs two
eager epochs to warm up, then one more under ``torch.profiler``. With the
profiler on, an eager step opens a ``record_function`` range for each phase
(``vae_forward``, ``gp_forward``, ``gp_backward``, ``vae_backward``,
``update``; the GPPVAE step's ``encode``, ``gp_forward``, ``gp_backward``,
``replay``, ``update``; ``lvae_torch/utils/metrics.py``). Each kernel is
put to the phase whose range holds its launch and to the chain of CPU ops
around the launch on the launching thread. Prints the phases' device ms
and the largest rows; ``--out`` writes every row to a JSON file.

    python tools/phase_kernel_map.py --workload hmnist_closed.train --seed 1234567

Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import json
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lvae_torch.utils.metrics import GPPVAE_PHASES, PHASES  # noqa: E402

STEP_PHASES = frozenset(PHASES + GPPVAE_PHASES)


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
                    if e.get("cat") == "user_annotation" and e.get("name") in STEP_PHASES)
    starts = [a for a, _, _ in phases]
    launch = {e["args"]["correlation"]: (e["ts"], e["tid"]) for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    ops = collections.defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op":
            ops[e["tid"]].append((e["ts"], e["ts"] + e.get("dur", 0), e["name"]))
    kernels = [e for e in events if e.get("cat") == "kernel"]
    chains = _launch_chains(ops, [launch[c] for c in {e["args"].get("correlation")
                                                     for e in kernels} if c in launch])
    rows = collections.defaultdict(lambda: [0.0, 0])
    total = collections.defaultdict(float)
    for e in kernels:
        ts, tid = launch.get(e["args"].get("correlation"), (None, None))
        phase = "none"
        if ts is not None:
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= phases[i][1]:
                phase = phases[i][2]
        chain = chains.get((ts, tid), ())
        key = (phase, " > ".join(chain), e["name"])
        rows[key][0] += e["dur"] / 1e3
        rows[key][1] += 1
        total[phase] += e["dur"] / 1e3
    out = sorted(([*k, round(v[0], 4), v[1]] for k, v in rows.items()), key=lambda r: -r[3])
    return dict(total), out


def _launch_chains(ops: dict, launches: list) -> dict:
    """``(ts, tid) → `` the names of the CPU ops open on thread ``tid`` at
    ``ts``, outermost first: one sweep a thread over its ops in start
    order with a stack of the open ones (a thread's ops nest)."""
    out = {}
    by_tid = collections.defaultdict(list)
    for ts, tid in launches:
        by_tid[tid].append(ts)
    for tid, times in by_tid.items():
        spans = sorted(ops.get(tid, []), key=lambda o: (o[0], -o[1]))
        stack, i = [], 0
        for ts in sorted(times):
            while i < len(spans) and spans[i][0] <= ts:
                while stack and stack[-1][1] < spans[i][0]:
                    stack.pop()
                stack.append(spans[i])
                i += 1
            while stack and stack[-1][1] < ts:
                stack.pop()
            out[(ts, tid)] = tuple(n for a, b, n in stack if a <= ts <= b)
    return out


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

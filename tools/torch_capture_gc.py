"""Captures of a small step while Python's cyclic garbage collector frees a
dead reference cycle, collected inside the capture, that holds CUDA state.

For each kind of garbage (none, a CUDA tensor, a recorded event, pinned
host memory after a copy from and to the card, a captured CUDA graph, two
graphs of one memory pool) ``--captures`` captures of a step: once the
capture has begun the step moves the object into a new dead reference
cycle, and the collector, at threshold 1, runs at the step's next
allocations. Each kind is captured through
``lvae_torch.train.graph.CapturedStep``, which turns the collector off
during its capture, and then straight through ``torch.cuda.graph`` (in
``train/graph.CAPTURE_MODE``), with one more capture without garbage at
the end. Prints, per kind and path, the captures that
failed and the first error, with the card's name and power limit. Needs a
card:

    python tools/torch_capture_gc.py [--captures 5]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("none", "tensor", "event", "pinned", "graph", "graphs_in_one_pool")


def held(kind: str, x):
    """What the garbage holds: nothing, a CUDA tensor, a recorded event,
    pinned memory after copies from and to the card, a captured graph, or
    two graphs of one pool."""
    import torch

    from lvae_torch.train.graph import CapturedStep

    if kind == "tensor":
        out = torch.randn(1 << 20, device="cuda")
    elif kind == "event":
        out = torch.cuda.Event()
        out.record()
    elif kind == "pinned":
        host = torch.empty(x.shape, pin_memory=True)
        host.copy_(x, non_blocking=True)
        out = (host, host.to("cuda", non_blocking=True))
    elif kind == "graph":
        out = CapturedStep(lambda a: a * 2, [x])
    elif kind == "graphs_in_one_pool":
        pool = torch.cuda.graph_pool_handle()
        out = [CapturedStep(lambda a: a * 2, [x], pool=pool) for _ in range(2)]
    else:
        out = None
    torch.cuda.synchronize()
    return out


def capture(kind: str, path: str, x) -> str:
    """One capture in which ``kind`` becomes a dead reference cycle that the
    collector may reach; "" or the error."""
    import torch

    from lvae_torch.train import graph

    holder = [held(kind, x)]

    def step(a):
        y = a + 1
        if holder and torch.cuda.is_current_stream_capturing():
            cycle = {"held": holder.pop()}  # a young cycle, the only holder now
            cycle["self"] = cycle
            del cycle
            _ = [[] for _ in range(64)]  # allocations: the collector's turn
        return y * 3

    prev = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        if path == "CapturedStep":
            graph.CapturedStep(step, [x])
        else:
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step(x)
            torch.cuda.current_stream().wait_stream(side)
            with torch.cuda.graph(torch.cuda.CUDAGraph(), stream=side,
                                  capture_error_mode=graph.CAPTURE_MODE):
                step(x)
        return ""
    except RuntimeError as e:  # torch.AcceleratorError is one
        return str(e).splitlines()[0]
    finally:
        gc.set_threshold(*prev)
        holder.clear()
        gc.collect()
        torch.cuda.synchronize()


def run(n: int) -> dict:
    import torch

    sys.path.insert(0, ROOT)
    x = torch.randn(1 << 16, device="cuda")
    out = {}
    # CapturedStep first: a failed capture may leave the process unable to
    # capture, so the straight path's failures come last, and a capture
    # with no garbage after them says whether the process still captures
    for path, kinds in (("CapturedStep", KINDS), ("torch.cuda.graph", KINDS + ("none",))):
        for i, kind in enumerate(kinds):
            errors = [e for e in (capture(kind, path, x) for _ in range(n)) if e]
            name = f"{kind} via {path}" + (" (after the others)" if i == len(KINDS) else "")
            out[name] = {"failed": len(errors), "of": n,
                         "first_error": errors[0] if errors else None}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--captures", type=int, default=5)
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip()
    for name, res in run(args.captures).items():
        print(f"{name}: {json.dumps(res)} | {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

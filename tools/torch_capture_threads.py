"""Captures of ``lvae_torch.train.graph.CapturedStep`` while another thread
of the process queries events, under each capture mode.

Each mode runs in a fresh process (a failed capture leaves torch's CUDA
generator in capture state): ``--captures`` captures of a small training
step (a dense layer's forward, backward and an in-place update) with a
thread recording and querying events on a stream of its own the whole
time, then the same captures with no such thread. Prints, per mode and
thread, the captures that failed and the first error, with the card's name
and power limit. Needs a card:

    python tools/torch_capture_threads.py [--captures 20]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def captures(mode: str, n: int, poll: bool) -> dict:
    import torch

    sys.path.insert(0, ROOT)
    from lvae_torch.train import graph

    graph.CAPTURE_MODE = mode
    stop, queries = threading.Event(), [0]

    def poller():
        stream = torch.cuda.Stream()
        while not stop.is_set():
            ev = torch.cuda.Event()
            ev.record(stream)
            try:
                ev.query()
                queries[0] += 1
            except RuntimeError:
                pass

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(512, 512, device="cuda", generator=gen)
    w = torch.randn(512, 512, device="cuda", generator=gen, requires_grad=True)

    def step(a):
        loss = torch.tanh(a @ w).square().mean()
        (g,) = torch.autograd.grad(loss, w)
        with torch.no_grad():
            w.sub_(1e-3 * g)
        return loss.detach()

    thread = threading.Thread(target=poller, daemon=True)
    if poll:
        thread.start()
    failed, first = 0, None
    try:
        for _ in range(n):
            try:
                graph.CapturedStep(step, (x,), torch.empty((), device="cuda"))
            except Exception as exc:  # the witness counts them
                failed += 1
                first = first or f"{type(exc).__name__}: {str(exc).splitlines()[0]}"
                break  # the generator is left in capture state
            torch.cuda.synchronize()
    finally:
        stop.set()
        if poll:
            thread.join()
    return {"mode": mode, "other_thread": poll, "captures": n, "failed": failed,
            "first_error": first, "queries": queries[0]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--captures", type=int, default=20)
    ap.add_argument("--mode", help=argparse.SUPPRESS)
    ap.add_argument("--poll", type=int, default=1, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.mode:
        print(json.dumps(captures(args.mode, args.captures, bool(args.poll))), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    for mode in ("global", "thread_local"):
        for poll in (1, 0):
            out = subprocess.run([sys.executable, __file__, f"--mode={mode}", f"--poll={poll}",
                                  f"--captures={args.captures}"], capture_output=True, text=True)
            lines = out.stdout.strip().splitlines()
            print(lines[-1] if out.returncode == 0 and lines else
                  f"{mode} poll={poll}: exit {out.returncode}\n{out.stderr[-2000:]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

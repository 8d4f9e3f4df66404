"""What a traced window's ``torch.profiler`` timeline says.

The window is the span of the benchmark's own annotation
:data:`WINDOW` (it ends after a device synchronise). Inside it: the device's
operations (kernels, copies, fills) with their intervals, the busy time as
the union of those intervals, so that overlapping kernels count once, the
idle gaps between them with what the host was doing meanwhile (the
innermost host event open at the gap's middle), and the host's CUDA runtime
calls by name.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

WINDOW = "perfbench.window"
# the runtime calls by which the host puts work on the card or waits for it
HOST_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpy",
              "cudaMemset", "cudaDeviceSynchronize", "cudaStreamSynchronize",
              "cudaEventSynchronize", "cudaStreamWaitEvent")
TOP = 10


class Event(NamedTuple):
    name: str
    start: float  # seconds, the trace's clock
    end: float
    device: bool


class Window(NamedTuple):
    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float, float]]  # (name, start, end), clipped to the window
    host_calls: Counter  # runtime call name → count
    gaps: List[Tuple[float, float, str]]  # (start, end, host activity)

    def device_seconds(self, pattern: str) -> Optional[float]:
        """Device time of the operations whose name holds ``pattern``; None
        where none ran."""
        hits = [e - s for n, s, e in self.device_ops if pattern in n]
        return sum(hits) if hits else None

    def breakdown(self) -> dict:
        ops: Dict[str, float] = defaultdict(float)
        for n, s, e in self.device_ops:
            ops[n[:120]] += e - s
        gaps: Dict[str, float] = defaultdict(float)
        for s, e, what in self.gaps:
            gaps[what[:120]] += e - s
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, v] for n, v in top], "idle_gaps": [[n, v] for n, v in idle]}


def events_of(prof) -> List[Event]:
    """Every event of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        device = e.device_type() == DeviceType.CUDA
        if device and (e.is_user_annotation() or e.name() == WINDOW):
            continue  # a host range drawn on the device's timeline, not device work
        start = e.start_ns() * 1e-9
        out.append(Event(e.name(), start, start + e.duration_ns() * 1e-9, device))
    return out


def reduce(events: List[Event]) -> Window:
    """The window of :data:`WINDOW` in ``events``."""
    wins = [e for e in events if not e.device and e.name == WINDOW]
    if len(wins) != 1:
        raise ValueError(f"expected one {WINDOW!r} annotation in the trace, found {len(wins)}")
    w0, w1 = wins[0].start, wins[0].end
    ops = sorted(((e.name, max(e.start, w0), min(e.end, w1)) for e in events
                  if e.device and e.end > w0 and e.start < w1), key=lambda o: o[1])
    merged: List[List[float]] = []
    for _, s, e in ops:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    host = [e for e in events if not e.device and e.name != WINDOW and e.end > w0 and e.start < w1]
    calls = Counter(e.name for e in host if e.name.startswith(HOST_CALLS))
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    holes = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    return Window(w1 - w0, busy, ops, calls, _host_activity(holes, host))


def _host_activity(holes, host: List[Event]):
    """Each idle gap with the innermost host event open at its middle: one
    sweep over the host events in start order, with a stack of the open
    ones (host events nest)."""
    host = sorted(host, key=lambda e: (e.start, -e.end))
    out, stack, i = [], [], 0
    for s, e in holes:  # in time order
        mid = 0.5 * (s + e)
        while i < len(host) and host[i].start <= mid:
            while stack and stack[-1].end < host[i].start:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end < mid:
            stack.pop()
        out.append((s, e, stack[-1].name if stack else "(no host event)"))
    return out

"""What the program's own tracing (``lvae_torch.utils.metrics.RECORDER``)
adds to a traced window: the device's idle time put down to the training
loop's phase that the host was in, and the captured step's phase times.

The program keeps its spans on the host clock that the profiler stamps its
events with, so a span's interval lies over the window's idle gaps as
they are. A program without the recorder, or a window in which it kept
nothing, gives None.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Sequence, Tuple

# the training loop's spans that idle time is put down to
LOOP = ("lvae.train.draws", "lvae.train.dispatch", "lvae.train.read", "lvae.train.callback")


def recorder():
    try:
        from lvae_torch.utils import metrics
    except ImportError:
        return None
    return getattr(metrics, "RECORDER", None)


def bounds(window) -> Tuple[float, float]:
    """The window's start and end on the trace's clock: its idle gaps and
    device operations tile it."""
    edges = [x for g in window.gaps for x in g[:2]] + [x for o in window.device_ops
                                                      for x in o[1:]]
    return min(edges), max(edges)


def loop_spans(run) -> List[Tuple[str, float, float]]:
    """The training loop's spans (:data:`LOOP`) that overlap the window, as
    ``(name, start, end)`` in seconds on the trace's clock."""
    rec = recorder()
    if rec is None:
        return []
    w0, w1 = bounds(run.window)
    spans = ((s.name, s.start_ns * 1e-9, s.end_ns * 1e-9) for s in list(rec.spans))
    return [(n, a, b) for n, a, b in spans if n in LOOP and b > w0 and a < w1]


def idle_by_span(run) -> Optional[Dict[Optional[str], float]]:
    """Seconds of the window's idle gaps under each innermost open loop span
    (None: under none of them); None where the window holds no loop span."""
    spans = loop_spans(run)
    if not spans:
        return None
    # the stretches between span edges, each with its innermost open span:
    # spans of one thread nest, so the latest started one
    edges = sorted({x for _, a, b in spans for x in (a, b)})
    stretches = []
    for lo, hi in zip(edges, edges[1:]):
        mid = 0.5 * (lo + hi)
        open_ = [(a, n) for n, a, b in spans if a <= mid < b]
        stretches.append((lo, hi, max(open_)[1] if open_ else None))
    out: Dict[Optional[str], float] = dict.fromkeys((None,) + LOOP, 0.0)
    i = 0
    for s, e, _ in run.window.gaps:  # in time order, as the stretches
        while i < len(stretches) and stretches[i][1] <= s:
            i += 1
        covered = 0.0
        for lo, hi, name in stretches[i:]:
            if lo >= e:
                break
            part = min(e, hi) - max(s, lo)
            out[name] += part
            covered += part
        out[None] += (e - s) - covered
    return out


def idle_share_under(run, names: Sequence[str]) -> Optional[float]:
    """The share of the window, in %, in which the device idles while the
    innermost open loop span is one of ``names``."""
    idle = idle_by_span(run)
    if idle is None:
        return None
    return 100.0 * sum(idle[n] for n in names) / run.window.window_s


def phase_ms(run, phases: Sequence[str]) -> Optional[float]:
    """The median over the window's phase samples of the sum of ``phases``'
    device ms a step; None where the window has no sample."""
    rec = recorder()
    if rec is None:
        return None
    w0, w1 = bounds(run.window)
    got = [sum(s.ms[p] for p in phases) for s in list(rec.samples)
           if w0 <= s.at_ns * 1e-9 <= w1 and all(p in s.ms for p in phases)]
    return statistics.median(got) if got else None

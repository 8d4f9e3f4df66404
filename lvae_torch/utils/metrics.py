"""Structured metrics logging and device observability (port of
lvae_tpu.utils.metrics).

A JSONL metrics stream per run (one record per epoch, append-only, the JAX
package's format), the CUDA caching allocator's memory statistics, and the
program's own tracing: spans at the training loop's phase boundaries and
timing events at a captured step's phase boundaries.

Tracing is on exactly while ``torch.profiler`` runs (the pipeline's
``--profile``, a benchmark's traced run). Off, a span costs one read of the
profiler's flag and a phase boundary one more read. On, a span is also a
``record_function`` of its name, so it shows in every profiler trace, and
:data:`RECORDER` keeps its ``(name, parent, start_ns, end_ns)`` on the host
clock the profiler stamps its events with (``time.time_ns()``), with a
count and total per name.

A step's phases (:data:`PHASES`) are marked by :func:`phase`,
:func:`phase_at_grads` and :func:`phase_end`. While a graph is captured
(``train/graph.CapturedStep``) each boundary records a timing event that
the capture turns into an event-record node, so that every replay stamps
its phases on the device; the owner reads the last replay's times with
:meth:`StepMarkers.times`. In an eager step with tracing on each phase is a
``record_function`` instead; otherwise a boundary does nothing.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Sequence

import torch
from torch.autograd import profiler as _profiler

# a training step's phases in program order: the VAE's forward (encoder,
# sample, decoder, reconstruction loss), the GP part's forward, the
# backward until every input of the GP part has its gradient, the rest of
# the backward, and the update (zero-gradient fill, the optimizer, the
# natural-gradient step, the noise pin)
PHASES = ("vae_forward", "gp_forward", "gp_backward", "vae_backward", "update")
SPAN_LIMIT = 1 << 16  # spans kept; the oldest go first
SAMPLE_LIMIT = 1 << 12  # phase samples kept


class MetricsLogger:
    """Append-only JSONL metrics writer; buffered, explicit flush."""

    def __init__(self, out_dir: Optional[str], filename: str = "metrics.jsonl"):
        self.path = os.path.join(out_dir, filename) if out_dir else None
        self._buf: list = []
        self._t0 = time.perf_counter()

    def log(self, step: int, metrics: dict) -> None:
        rec = {"step": step, "t": round(time.perf_counter() - self._t0, 4)}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._buf.append(rec)
        if len(self._buf) >= 50:
            self.flush()

    def flush(self) -> None:
        if not self.path or not self._buf:
            self._buf.clear()
            return
        os.makedirs(os.path.dirname(os.path.abspath(self.path)), exist_ok=True)
        with open(self.path, "a") as f:
            for rec in self._buf:
                f.write(json.dumps(rec) + "\n")
        self._buf.clear()


def device_memory_stats() -> dict:
    """Per-card memory statistics of the caching allocator (bytes in use,
    peak and the card's total); empty without CUDA."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


# ------------------------------------------------------------------ spans
class Span(NamedTuple):
    name: str
    parent: Optional[str]  # the enclosing span of the same thread
    start_ns: int  # time.time_ns(), the profiler's host clock
    end_ns: int


class PhaseSample(NamedTuple):
    graph: object  # the captured step's key
    at_ns: int  # when it was read
    ms: Dict[str, float]  # phase → device ms of the graph's last replay


class Recorder:
    """The spans and phase samples of the process, kept in memory, the
    oldest dropped past :data:`SPAN_LIMIT` and :data:`SAMPLE_LIMIT`; a
    count and total per span name besides."""

    def __init__(self):
        self.spans: collections.deque = collections.deque(maxlen=SPAN_LIMIT)
        self.samples: collections.deque = collections.deque(maxlen=SAMPLE_LIMIT)
        self.counts: Dict[str, int] = collections.Counter()
        self.total_ns: Dict[str, int] = collections.Counter()
        self._open = threading.local()

    def clear(self) -> None:
        self.spans.clear()
        self.samples.clear()
        self.counts.clear()
        self.total_ns.clear()

    def stack(self) -> List[str]:
        if not hasattr(self._open, "names"):
            self._open.names = []
        return self._open.names

    def add(self, span: Span) -> None:
        self.spans.append(span)
        self.counts[span.name] += 1
        self.total_ns[span.name] += span.end_ns - span.start_ns

    def add_sample(self, graph, ms: Optional[Dict[str, float]]) -> None:
        """One sample of a captured step's phase times ``ms`` (its last
        replay, ``StepMarkers.times``), read now; None adds nothing."""
        if ms:
            self.samples.append(PhaseSample(graph, time.time_ns(), ms))

    def summary(self, since_ns: int = 0) -> dict:
        """Each phase's median ms a step over the samples read since
        ``since_ns``, and each span's count and total seconds since then."""
        phases: Dict[str, List[float]] = collections.defaultdict(list)
        for s in self.samples:
            if s.at_ns >= since_ns:
                for k, v in s.ms.items():
                    phases[k].append(v)
        spans: Dict[str, List[float]] = {}
        for s in self.spans:
            if s.start_ns >= since_ns:
                n, total = spans.get(s.name, (0, 0.0))
                spans[s.name] = (n + 1, total + (s.end_ns - s.start_ns) * 1e-9)
        return {"phase_ms": {k: _median(v) for k, v in phases.items()},
                "spans": {k: {"count": n, "total_s": t} for k, (n, t) in spans.items()}}


def _median(values: Sequence[float]) -> float:
    v = sorted(values)
    mid = len(v) // 2
    return v[mid] if len(v) % 2 else 0.5 * (v[mid - 1] + v[mid])


RECORDER = Recorder()


def tracing() -> bool:
    """Whether ``torch.profiler`` runs, and with it the program's tracing."""
    return _profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "parent", "start", "rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = RECORDER.stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        self.start = time.time_ns()
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()
        return self

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        RECORDER.add(Span(self.name, self.parent, self.start, time.time_ns()))
        RECORDER.stack().pop()
        return False


_OFF = contextlib.nullcontext()


def span(name: str):
    """``with span("lvae.train.draws"):`` — a program span: with tracing on a
    ``record_function`` of ``name`` and an entry of :data:`RECORDER`
    (stamped just outside the ``record_function``); off, nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


# ---------------------------------------------------------- step phases
class StepMarkers:
    """The timing events of a captured step's phase boundaries, recorded on
    ``stream`` (the capture's) in program order while the step is captured
    inside :func:`capturing`; each replay stamps them on the device."""

    def __init__(self, stream: torch.cuda.Stream):
        self.stream = stream
        self.marks: List[tuple] = []  # (phase starting there or None, event)

    def mark(self, name: Optional[str]) -> None:
        ev = torch.cuda.Event(enable_timing=True, external=True)  # an event-record node
        with torch.cuda.stream(self.stream):  # the autograd thread's stream too
            ev.record()
        self.marks.append((name, ev))

    def times(self) -> Optional[Dict[str, float]]:
        """Device ms of each phase in the last replay, summed over a phase's
        stretches; None where a replay is still in flight or nothing was
        marked."""
        if len(self.marks) < 2 or not all(ev.query() for _, ev in self.marks):
            return None
        out: Dict[str, float] = {}
        for (name, a), (_, b) in zip(self.marks, self.marks[1:]):
            if name is not None:
                out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


_markers: Optional[StepMarkers] = None  # those of the step being captured
_eager_phase = None  # the open record_function of an eager step's phase
_hooks: list = []  # the step's multi-grad hooks, removed at its end


@contextlib.contextmanager
def capturing(markers: StepMarkers):
    """Inside the block each phase boundary records an event of
    ``markers`` (``CapturedStep`` holds it around the capture)."""
    global _markers
    _markers = markers
    try:
        yield markers
    finally:
        _markers = None
        _remove_hooks()  # those of a capture that raised


def _boundary(markers: Optional[StepMarkers], name: Optional[str]) -> None:
    global _eager_phase
    if markers is not None:
        if name is not None or markers.marks:
            markers.mark(name)
        return
    if _eager_phase is not None:
        _eager_phase.__exit__(None, None, None)
        _eager_phase = None
    if name is not None and _profiler._is_profiler_enabled:
        _eager_phase = _profiler.record_function(name)
        _eager_phase.__enter__()


def phase(name: str) -> None:
    """Phase ``name`` of the step starts here (the one before ends)."""
    if _markers is None and not _profiler._is_profiler_enabled:
        return
    _boundary(_markers, name)


def phase_at_grads(tensors: Sequence[Optional[torch.Tensor]], name: str) -> None:
    """Phase ``name`` starts when the backward has computed the gradient of
    every one of ``tensors`` that takes one (a multi-grad hook, removed at
    :func:`phase_end`). Autograd runs the later-made nodes first, so over
    the inputs of the step's last part it marks where that part's backward
    ends."""
    markers = _markers
    if markers is None and not _profiler._is_profiler_enabled:
        return
    grads = [t for t in tensors if t is not None and t.requires_grad]
    if not grads:
        return
    handle = torch.autograd.graph.register_multi_grad_hook(
        grads, lambda _grads: _boundary(markers, name))
    _hooks.append(handle)


def _remove_hooks() -> None:
    for h in _hooks:
        h.remove()
    _hooks.clear()


def phase_end() -> None:
    """The step's last phase ends here."""
    if _markers is None and _eager_phase is None and not _hooks:
        return
    _remove_hooks()
    _boundary(_markers, None)


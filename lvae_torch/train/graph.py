"""One training step captured as a CUDA graph and replayed.

The JAX package runs a chunk of epochs as one compiled program: a
``lax.scan`` over batches and epochs, one dispatch (``train/hensman.py
make_epochs_fn``). On the card the port captures the step function once per
batch shape into a ``torch.cuda.CUDAGraph`` and replays it for every batch:
the host then enqueues one replay and a few copies a step instead of the
step's hundreds of kernel launches. The step function must run on fixed
buffers and be safe to capture: no host-to-device copy of a Python number
(``torch.tensor(x, device=...)``; a fill, ``torch.full((), x, ...)``, gives
the same bits), no read of a device value on the host, no draw from a CPU
generator inside it, and every piece of state it updates updated in place,
since a replay reads and writes the addresses the capture saw.

:class:`CapturedStep` builds such a graph. Its first step runs eagerly on a
side stream (the warm-up: cuDNN and cuBLAS choose their algorithms there,
the kernels build and plan, the optimizer makes its state) and is a real
step of training; the capture that follows runs nothing. The kernel
wrappers count their launches on the host, which a replay does not reach:
the step's launches are recorded at the capture and added to the counters
after every replay, so the counters still say how many launches ran.

:class:`StepGraphs` holds an owner's graphs by key and makes the one
decision every owner makes: on the CPU and on a mesh view a step runs
eagerly (by rule), on the card it replays its graph, captured at its first
run. The trainers (Hensman, pre-training, both VI phases) and the serving
bundle (``inference.CompiledServing``, which captures its programs at
construction, under ``torch.inference_mode()``, several graphs of one
bundle in one memory pool: each replay's output is copied out before the
next replay, so one graph's scratch may reuse another's) all go through
it; :func:`eager_steps` runs every step eagerly on the card too, the
reference a replay is compared with. :func:`run_staged` stages a chunk's
host-drawn inputs in one pinned slab and :func:`run_chunks` runs the chunks
with the one-chunk lag of the JAX package's ``fit``.
"""

from __future__ import annotations

import contextlib
import gc
import math
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import torch

from lvae_torch.kernels_cuda import adam as k5
from lvae_torch.kernels_cuda import b_chain as k1
from lvae_torch.kernels_cuda import block_pair as k4
from lvae_torch.kernels_cuda import cholesky as k2
from lvae_torch.kernels_cuda import kernel_matrix as k3
from lvae_torch.ops import kernels as kx
from lvae_torch.utils import metrics

# (module, wrapper name) of every kernel wrapper with a ``launches`` count,
# read by name at each use so that a replaced wrapper is the one counted
COUNTERS = ((k1, "b_chain"), (k2, "cholesky_inverse"), (k3, "kernel_matrix_fused"),
            (k4, "block_pair"), (k5, "fused_adam_update"))


def launch_counts() -> Tuple[int, ...]:
    """The launch count of every wrapper of :data:`COUNTERS`."""
    return tuple(getattr(mod, name).launches for mod, name in COUNTERS)


def add_launches(delta: Sequence[int]) -> None:
    for (mod, name), d in zip(COUNTERS, delta):
        getattr(mod, name).launches += d


def route_key() -> tuple:
    """The switches a capture bakes in, for an owner's key: the kernel route
    (``ops.kernels.use_b_chain_kernel`` and ``use_block_pair_kernel``) and
    the backend switches whose algorithms a graph keeps from its warm-up
    (cuDNN's ``deterministic``, TF32 in cuDNN and in matmuls)."""
    return (kx.use_b_chain_kernel, kx.use_block_pair_kernel, torch.backends.cudnn.deterministic,
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


# A capture refuses the calls that would break it (a synchronisation, a
# query of an event) in the thread that captures. torch's default mode,
# "global", refuses them in every thread of the process and invalidates the
# capture when another thread makes one, so that the capture fails or not
# by when the other thread runs (tools/torch_capture_threads.py shows it
# with a thread that queries events). "thread_local" leaves the other
# threads alone; the work the step sends to the captured stream, from
# whichever thread, is held to the same rules as before.
CAPTURE_MODE = "thread_local"


@contextlib.contextmanager
def collector_off() -> Iterator[None]:
    """Python's cyclic garbage collector off inside the block. A CUDA graph
    that the collector frees during another graph's capture (one held in a
    dead reference cycle: a trainer's, a model's evaluation programs)
    resets inside that capture, which CUDA refuses, and the capture fails
    with "operation failed due to a previous error during capture"
    (``tools/torch_capture_gc.py`` shows it); a collection deferred past
    the capture frees it safely."""
    was_on = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was_on:
            gc.enable()


class CapturedStep:
    """``step(*inputs) -> Tensor`` captured on the card over fixed copies of
    ``inputs``.

    Construction runs ``step`` on ``inputs`` once, eagerly on a side stream,
    and writes its result into ``out`` where one is given (a training
    step's warm-up is this step of training), then captures ``step`` on the
    same stream, with the garbage collector off (:func:`collector_off`), in
    the memory pool ``pool`` (a
    ``torch.cuda.graph_pool_handle()`` that several graphs share, or a pool
    of its own) and, with ``inference``, under ``torch.inference_mode()``.
    :meth:`replay` copies new inputs into the fixed ones, replays the
    graph, adds the step's kernel launches to the counters and returns the
    fixed output (overwritten by the next replay). ``launches`` holds the
    step's launches in the order of :data:`COUNTERS`. ``markers`` holds the
    timing events of the step's phase boundaries (``utils/metrics``), which
    every replay stamps; :meth:`phase_times` reads the last replay's."""

    def __init__(self, step: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor],
                 out: Optional[torch.Tensor] = None, pool=None, inference: bool = False):
        self.inputs = tuple(x.clone() for x in inputs)
        mode = torch.inference_mode if inference else contextlib.nullcontext
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream(device=self.inputs[0].device)
        side.wait_stream(main)
        with torch.cuda.stream(side), mode():
            warm = step(*self.inputs)
            if out is not None:
                out.copy_(warm)
        main.wait_stream(side)
        before = launch_counts()
        self.markers = metrics.StepMarkers(side)
        self.replays = 0
        self.graph = torch.cuda.CUDAGraph()
        with collector_off(), torch.cuda.graph(self.graph, pool=pool, stream=side,
                                               capture_error_mode=CAPTURE_MODE), mode(), \
                metrics.capturing(self.markers):
            self.out = step(*self.inputs)
        self.launches = tuple(a - b for a, b in zip(launch_counts(), before))
        add_launches([-d for d in self.launches])  # the capture launched nothing

    def replay(self, *inputs: torch.Tensor) -> torch.Tensor:
        """Replay on ``inputs``, on the card or on the host (each is copied
        into its fixed input without waiting for the device)."""
        for fixed, x in zip(self.inputs, inputs):
            fixed.copy_(x, non_blocking=True)
        self.graph.replay()
        self.replays += 1
        add_launches(self.launches)
        return self.out

    def phase_times(self):
        """Device ms of each marked phase in the last replay; None before
        the first replay, while one is in flight, or where the step marks
        no phase."""
        return self.markers.times() if self.replays else None


def record_phases(graphs: "StepGraphs") -> None:
    """With tracing on, one sample of each captured step's phase times in
    ``metrics.RECORDER`` (a step with a replay in flight gives none)."""
    if metrics.tracing():
        for key, captured in graphs.items():
            metrics.RECORDER.add_sample(key, captured.phase_times())


# set by :func:`eager_steps`: every step of :class:`StepGraphs` runs eagerly
_eager_everywhere = False


@contextlib.contextmanager
def eager_steps() -> Iterator[None]:
    """Inside the block every step of a :class:`StepGraphs` runs eagerly, on
    the card too (no capture, no replay): the reference a replay is held
    to."""
    global _eager_everywhere
    prev, _eager_everywhere = _eager_everywhere, True
    try:
        yield
    finally:
        _eager_everywhere = prev


class StepGraphs(dict):
    """One owner's captured steps by key (a batch shape, a kernel route, a
    program name), captured in the memory pool ``pool`` and, with
    ``inference``, under ``torch.inference_mode()``.

    :meth:`run` holds the one decision every owner makes: where the caller
    says ``eager`` (the CPU, a mesh view: a rule of the device or the view,
    never a fallback) the step runs eagerly; otherwise it is a replay of
    the key's graph, captured at the key's first run (that run is the
    capture's warm-up) or beforehand by :meth:`capture`. A capture that
    fails raises."""

    def __init__(self, pool=None, inference: bool = False):
        super().__init__()
        self.pool, self.inference = pool, inference

    def capture(self, key, step: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor],
                out: Optional[torch.Tensor] = None) -> CapturedStep:
        with metrics.span("lvae.train.capture"):
            self[key] = CapturedStep(step, inputs, out, self.pool, self.inference)
        return self[key]

    def run(self, key, step: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor],
            out: Optional[torch.Tensor] = None, eager: bool = False) -> torch.Tensor:
        """``step(*inputs)``, written into ``out`` where one is given (a key
        captured here needs one: its warm-up's result goes there), else
        returned: a replay returns the graph's fixed output, which the
        key's next replay overwrites."""
        if eager or _eager_everywhere:
            y = step(*inputs)
        elif key in self:
            y = self[key].replay(*inputs)
        elif out is None:
            raise ValueError(f"step {key!r} is not captured and has no output to warm up into")
        else:
            self.capture(key, step, inputs, out)
            return out
        if out is None:
            return y
        return out.copy_(y)


def run_chunks(total: int, chunk: int, dispatch: Callable[[int], object],
               read: Callable[[int, int, object], Optional[str]], overlap: bool) -> None:
    """``total`` steps in chunks of ``chunk``: ``dispatch(n)`` starts a
    chunk of ``n`` and returns what ``read(done, n, dispatched)`` later
    waits for (``done`` the steps before the chunk). With ``overlap``
    chunk k+1 is dispatched before chunk k is read: the same values, read
    in the same order. Without it a ``read`` that returns ``"rollback"``
    (an earlier state was restored) has the chunk's steps run again."""
    done, pending = 0, None
    while done < total or pending is not None:
        nxt = None
        if done < total:
            n = min(max(chunk, 1), total - done)
            nxt = (done, n, dispatch(n))
            done += n
        if pending is not None:
            read(*pending)
        pending = nxt
        if not overlap and pending is not None:
            if read(*pending) == "rollback":
                done -= pending[1]
            pending = None


# the most bytes of draws a chunk stages on the host for one copy to the
# device; a chunk whose epochs draw more is staged and copied in parts
SLAB_BYTES = 64 << 20


def epochs_per_slab(epoch_bytes: int) -> int:
    """How many epochs' draws of ``epoch_bytes`` each one slab holds."""
    return max(1, SLAB_BYTES // max(1, epoch_bytes))


def run_staged(n: int, specs: Sequence[Tuple[tuple, torch.dtype]],
               fill: Callable[[int, List[torch.Tensor]], None],
               run_step: Callable[[int, List[torch.Tensor]], None], device: torch.device) -> None:
    """Run ``n`` steps whose inputs are drawn on the host, without waiting
    for the device. Step ``i`` takes one input of each ``(shape, dtype)``
    of ``specs``: ``fill(i, inputs)`` draws them on the host, in step
    order, into fresh slabs (pinned on the card), which go to ``device`` in
    one copy each, in parts of at most :data:`SLAB_BYTES`; then
    ``run_step(i, inputs)`` runs the step on their device copies. The
    allocator keeps a pinned block until its copy is done, so a slab in
    flight is never refilled."""
    step_bytes = sum(math.prod(shape) * torch.empty((), dtype=dtype).element_size()
                     for shape, dtype in specs)
    part = epochs_per_slab(step_bytes)
    pin = device.type == "cuda"
    for start in range(0, n, part):
        m = min(part, n - start)
        with metrics.span("lvae.train.draws"):
            slabs = [torch.empty((m,) + tuple(shape), dtype=dtype, pin_memory=pin)
                     for shape, dtype in specs]
            for i in range(m):
                fill(start + i, [slab[i] for slab in slabs])
            staged = [slab.to(device, non_blocking=True) for slab in slabs]
        with metrics.span("lvae.train.dispatch"):
            for i in range(m):
                run_step(start + i, [x[i] for x in staged])


def start_host_copy(t: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.cuda.Event]]:
    """Start copying ``t`` to the host without waiting for the device: on
    the card a pinned copy in flight and the event that marks it done, on
    the CPU ``t`` itself. :func:`finish_host_copy` waits for it."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done


def finish_host_copy(copy: Tuple[torch.Tensor, Optional[torch.cuda.Event]]) -> torch.Tensor:
    host, done = copy
    if done is not None:
        done.synchronize()
    return host

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
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from lvae_torch.kernels_cuda import adam as k5
from lvae_torch.kernels_cuda import b_chain as k1
from lvae_torch.kernels_cuda import block_pair as k4
from lvae_torch.kernels_cuda import cholesky as k2
from lvae_torch.kernels_cuda import kernel_matrix as k3

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


class CapturedStep:
    """``step(*inputs) -> Tensor`` captured on the card over fixed copies of
    ``inputs``.

    Construction runs ``step`` on ``inputs`` once, eagerly on a side stream,
    and writes its result into ``out`` (the warm-up is this step of
    training), then captures ``step`` on the same stream. :meth:`replay`
    copies new inputs into the fixed ones, replays the graph, adds the
    step's kernel launches to the counters and returns the fixed output
    (overwritten by the next replay). ``launches`` holds the step's launches
    in the order of :data:`COUNTERS`."""

    def __init__(self, step: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor],
                 out: torch.Tensor):
        self.inputs = tuple(x.clone() for x in inputs)
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream(device=out.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out.copy_(step(*self.inputs))
        main.wait_stream(side)
        before = launch_counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=side):
            self.out = step(*self.inputs)
        self.launches = tuple(a - b for a, b in zip(launch_counts(), before))
        add_launches([-d for d in self.launches])  # the capture launched nothing

    def replay(self, *inputs: torch.Tensor) -> torch.Tensor:
        for fixed, x in zip(self.inputs, inputs):
            fixed.copy_(x)
        self.graph.replay()
        add_launches(self.launches)
        return self.out


# the most bytes of draws a chunk stages on the host for one copy to the
# device; a chunk whose epochs draw more is staged and copied in parts
SLAB_BYTES = 64 << 20


def epochs_per_slab(epoch_bytes: int) -> int:
    """How many epochs' draws of ``epoch_bytes`` each one slab holds."""
    return max(1, SLAB_BYTES // max(1, epoch_bytes))


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

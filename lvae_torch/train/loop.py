"""The epoch program of every trainer of the port (the JAX package's
``make_epochs_fn``, ``epochs_fn`` and ``pred_steps``).

``run_epochs(n)`` draws a chunk's inputs on the host, in the steps' own
order, from a CPU ``torch.Generator`` (so a run on the card and one on the
CPU consume the same numbers), copies them to the device in one pinned slab
(``graph.run_staged``), runs every step of the chunk without waiting for
the device, and reads the chunk's metrics once. ``fit`` runs chunks with
the one-chunk lag (``graph.run_chunks``). A step is one function on fixed
buffers that updates the state in place; on the card it is captured as a
CUDA graph at its first run and replayed after, on the CPU and on a mesh
view it runs eagerly (``graph.steps_eagerly``). Assigning ``state`` drops
the graphs, so that the next chunk captures again on the new state's
tensors.

A trainer supplies what differs between trainers:

* ``_step(*inputs)``, the step function, returning the step's metrics row;
* ``_epoch_specs()``, an epoch's host inputs as ``(shape, dtype)``, and
  ``_draw(e, inputs)``, which draws epoch ``e``'s into them (by default
  each from the state's generator, as ``torch.randn`` draws it);
* ``_epoch(inputs, out)``, which runs an epoch's steps on their device
  inputs into the epoch's metrics ``out`` of ``_out_shape`` (by default one
  step);
* ``_reduce(host, n)``, the ``n`` epochs' metrics from the chunk's rows;
* ``LOG``, the log line, formatted with ``epoch``, ``epochs`` and ``m``.
"""

from __future__ import annotations

from typing import Callable, List

import torch

from lvae_torch.ops.shard import LOCAL, Local
from lvae_torch.train.graph import (
    StepGraphs, finish_host_copy, record_phases, route_key, run_chunks, run_staged,
    start_host_copy, steps_eagerly,
)
from lvae_torch.utils.metrics import span

Fill = Callable[[int, List[torch.Tensor]], None]


class EpochProgram:
    """The shell of a trainer's epoch program (see the module). A trainer
    sets ``device``, ``dtype``, ``history`` and ``state`` and supplies the
    hooks the module lists."""

    view: Local = LOCAL  # a rank's shard on a mesh (parallel/mesh.py)
    _out_shape: tuple = (4,)
    LOG = ("Iter {epoch}/{epochs} - Loss: {m.net:.3f}  - GP loss: {m.gp:.3f}"
           "  - NLL Loss: {m.nll:.3f}  - Recon Loss: {m.recon:.3f}")
    OVERLAP = True  # fit's lag where neither a callback nor ``overlap`` rules it out

    @property
    def state(self):
        return self._state

    @state.setter
    def state(self, value) -> None:
        """A new state drops the captured steps: a graph reads and writes the
        tensors it was captured on, so the next chunk captures again."""
        self._state = value
        self._graphs = StepGraphs()

    # ------------------------------------------------------------- one step
    def _run_step(self, *args) -> None:
        """Step the device inputs ``args[:-1]`` into the metrics row
        ``args[-1]``: the step captured under the inputs' shape and
        ``route_key()`` at its first run (which is the capture's warm-up)
        and replayed after, or run eagerly by ``steps_eagerly``'s rule; then
        count the step."""
        *inputs, out = args
        self._graphs.run((tuple(inputs[0].shape), *route_key()), self._step, inputs, out,
                         eager=steps_eagerly(self.device, self.view))
        self._advance()

    def _advance(self) -> None:
        """Count a step taken (its tensors were updated in place)."""
        self._state = self._state._replace(step=self._state.step + 1)

    # --------------------------------------------------------------- epochs
    def _draw(self, e: int, inputs: List[torch.Tensor]) -> None:
        for x in inputs:
            x.normal_(generator=self._state.rng)  # torch.randn's draw

    def _epoch(self, inputs: List[torch.Tensor], out: torch.Tensor) -> None:
        self._run_step(*inputs, out)

    def _dispatch(self, n: int, fill: Fill):
        """Run ``n`` epochs without waiting for the device, their inputs
        drawn by ``fill``; returns their metrics' host copy in flight."""
        out = torch.empty((n, *self._out_shape), dtype=self.dtype, device=self.device)
        run_staged(n, self._epoch_specs(), fill, lambda e, inputs: self._epoch(inputs, out[e]),
                   self.device)
        return start_host_copy(out)

    def _dispatch_epochs(self, n: int):
        return self._dispatch(n, self._draw)

    def _materialize_metrics(self, chunk, n: int) -> list:
        """Wait for a dispatched chunk's metrics; returns each epoch's as
        host floats (appended to ``history``). With tracing on the captured
        steps' phase times are sampled after the wait."""
        with span("lvae.train.read"):
            host = finish_host_copy(chunk)
            record_phases(self._graphs)
            ms = self._reduce(host, n)
            self.history.extend(ms)
        return ms

    def _run_one(self, fill: Fill):
        """One epoch, its inputs drawn by ``fill``; returns its metrics."""
        return self._materialize_metrics(self._dispatch(1, fill), 1)[0]

    def run_epochs(self, n: int) -> list:
        """Run ``n`` epochs as one chunk; returns their metrics."""
        return self._materialize_metrics(self._dispatch_epochs(n), n)

    def fit(self, epochs: int, log_every: int = 1, callback=None, chunk: int = 25,
            overlap=None) -> list:
        """Train ``epochs`` epochs in ``chunk``-epoch chunks, calling
        ``callback(trainer, done, last metrics)`` after every chunk. A
        callback that returns ``"rollback"`` has restored an earlier state:
        the chunk's epochs are then run again, so the run trains as many
        epochs as it reports. Without a callback (and unless ``overlap``, by
        default ``OVERLAP``, is False) chunk k+1 is dispatched before chunk
        k's metrics are read: the same values, printed in the same order."""
        lag = callback is None and (self.OVERLAP if overlap is None else bool(overlap))

        def read(done: int, n: int, chunk_):
            ms = self._materialize_metrics(chunk_, n) if lag else chunk_
            with span("lvae.train.callback"):
                for epoch, m in enumerate(ms, done + 1):
                    if log_every and epoch % log_every == 0:
                        print(self.LOG.format(epoch=epoch, epochs=epochs, m=m), flush=True)
                return None if callback is None else callback(self, done + n, ms[-1])

        # without the lag each chunk runs through run_epochs and is read at once
        run_chunks(epochs, chunk, self._dispatch_epochs if lag else self.run_epochs, read, lag)
        return self.history

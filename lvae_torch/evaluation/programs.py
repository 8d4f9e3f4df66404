"""The evaluation programs: fixed-shape functions captured once as CUDA
graphs on the card and replayed (the counterpart of the JAX package's jit
caches keyed on the static flax module: ``evaluation/encode.py``'s
``vae_forward``, ``_encode_scan`` and ``_decode_scan``,
``evaluation/validate.py:_validate_jit`` and ``ops/predict.py:gp_predict_jit``).

:func:`run` runs a program: on the card its first run at a key is the
warm-up of a capture (``train/graph.CapturedStep``) and every later run a
replay, which copies the inputs into the graph's fixed inputs; on the CPU
and under ``train.graph.eager_steps()`` the program runs eagerly, by rule.
Every program runs under ``torch.inference_mode()``.

A program's key is its name, its inputs' shapes and dtypes, the model's
compute dtype, the kernel route (``ops.kernels.use_b_chain_kernel`` and
``use_block_pair_kernel``) and the backend switches a capture bakes in
(cuDNN's ``deterministic``, TF32 in cuDNN and in matmuls: a graph keeps the
algorithms its warm-up chose), the program's static arguments (specs,
jitter, ``type_kl``, ``num_samples``) and the addresses of the model's
parameters and buffers. A graph reads the addresses it was captured with:
an update in place (an optimizer step, ``load_state_dict``) is seen by the
next replay, while a model whose storages were replaced
(``model.to(...)``, ``load_state_dict(..., assign=True)``) gets a new
capture, and the graphs of that name and shape on the old storages are
dropped. The GP tensors and the
data are inputs, copied into the graph's fixed inputs at each replay.

The graphs live in one :class:`~lvae_torch.train.graph.StepGraphs` a model
(held weakly: they go with the model), the model-free GP programs in one a
device. A program keeps at most :data:`GRAPHS_PER_NAME` graphs of one name;
capturing another drops the oldest.

A dataset's arrays (frames, pixel mask, labels, its subject blocks) are
moved to the card once per array object (:func:`dataset_tensor`,
:func:`dataset_blocks`) and held while the array lives: a dataset whose
arrays change must come as new arrays. Host noise goes in as one pinned slab
(:func:`host_noise`), one copy; results come out through one pinned copy
(``train/graph.start_host_copy``).
"""

from __future__ import annotations

import functools
import math
import weakref
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from lvae_torch.data.blocks import build_subject_blocks
from lvae_torch.train.graph import StepGraphs, route_key, steps_eagerly

# graphs kept per program name: the keys one run meets (two validation
# cohorts in three modes, the test and generation cohorts) without holding
# the memory of every shape ever seen
GRAPHS_PER_NAME = 8

_model_graphs: "weakref.WeakKeyDictionary[nn.Module, StepGraphs]" = weakref.WeakKeyDictionary()
_gp_graphs: Dict[torch.device, StepGraphs] = {}


def graphs_of(model: Optional[nn.Module], device: torch.device) -> StepGraphs:
    """The graphs of ``model``'s programs (of the GP programs on ``device``
    where ``model`` is None), in one memory pool on the card: one program
    runs at a time and its output is copied out before the next."""
    table = _gp_graphs if model is None else _model_graphs
    owner = device if model is None else model
    graphs = table.get(owner)
    if graphs is None:
        pool = torch.cuda.graph_pool_handle() if device.type == "cuda" else None
        graphs = table[owner] = StepGraphs(pool, inference=True)
    return graphs


def program_key(name: str, inputs: Sequence[torch.Tensor], model: Optional[nn.Module] = None,
                static: tuple = ()) -> tuple:
    """The key of program ``name`` on ``inputs`` (see the module's
    docstring); its first two entries, the name and the inputs' shapes and
    dtypes, say which graph a new capture replaces."""
    sig = tuple((tuple(x.shape), x.dtype) for x in inputs)
    route = route_key()
    if model is None:
        return (name, sig, None, route, static, ())
    ptrs = tuple(t.data_ptr() for t in (*model.parameters(), *model.buffers()))
    return (name, sig, getattr(model, "compute_dtype", None), route, static, ptrs)


def _make_room(graphs: StepGraphs, key: tuple) -> None:
    """Before ``key``'s capture: drop the graphs of its name and shape on
    other storages, and the oldest of its name beyond GRAPHS_PER_NAME - 1."""
    for k in [k for k in graphs if k[:2] == key[:2] and k[5] != key[5]]:
        del graphs[k]
    same_name = [k for k in graphs if k[0] == key[0]]
    for k in same_name[:max(0, len(same_name) - GRAPHS_PER_NAME + 1)]:
        del graphs[k]


@torch.inference_mode()
def run(name: str, fn: Callable[..., torch.Tensor], inputs: Sequence[torch.Tensor],
        out_shape: Tuple[int, ...], out_dtype: torch.dtype, device: torch.device,
        model: Optional[nn.Module] = None, static: tuple = ()) -> torch.Tensor:
    """``fn(*inputs)`` (a tensor of ``out_shape`` and ``out_dtype``) in a
    fresh tensor on ``device``: on the card a replay of the program's graph,
    captured at the key's first run; on the CPU the eager program. Host
    inputs are copied to ``device`` (without waiting, from pinned memory)."""
    inputs = [x.detach().to(device, non_blocking=True) for x in inputs]
    out = torch.empty(out_shape, dtype=out_dtype, device=device)
    graphs = graphs_of(model, device)
    eager = steps_eagerly(device)
    key = program_key(name, inputs, model, static)
    if not eager and key not in graphs:
        _make_room(graphs, key)
    return graphs.run(key, fn, inputs, out, eager=eager)


# ------------------------------------------------------------- host → device
def on_device(a, dtype, device) -> torch.Tensor:
    """A numpy array or a tensor as a tensor of ``dtype`` on ``device``."""
    return torch.as_tensor(a if isinstance(a, torch.Tensor) else np.asarray(a),
                           dtype=dtype, device=device)


def staged(a, dtype, device: torch.device) -> torch.Tensor:
    """A host array (or a tensor) as a tensor of ``dtype`` on ``device``: on
    the card a host array goes through one pinned buffer and one copy that
    does not wait for the device."""
    if device.type != "cuda" or isinstance(a, torch.Tensor):
        return on_device(a, dtype, device)
    a = np.asarray(a)
    host = torch.empty(a.shape, dtype=dtype, pin_memory=True)
    host.copy_(torch.from_numpy(np.ascontiguousarray(a)))
    return host.to(device, non_blocking=True)


# device copies of dataset arrays, by (id of the array, what, dtype, device);
# an entry goes with its array
_on_card: dict = {}


def _cached(arr, what: tuple, make: Callable[[], object]):
    if not isinstance(arr, (np.ndarray, torch.Tensor)):
        return make()
    key = (id(arr),) + what
    hit = _on_card.get(key)
    if hit is None:
        hit = _on_card[key] = make()
        weakref.finalize(arr, _on_card.pop, key, None)
    return hit


def dataset_tensor(arr, dtype, device: torch.device) -> torch.Tensor:
    """A dataset's array as a tensor of ``dtype`` on ``device``: on the card
    moved once per array object (while it lives), on the CPU
    :func:`on_device`."""
    if device.type != "cuda":
        return on_device(arr, dtype, device)
    return _cached(arr, ("tensor", dtype, device), lambda: staged(arr, dtype, device))


def dataset_blocks(labels, id_covariate: int, dtype,
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The subject blocks of ``labels`` on ``device``: the row index of each
    block slot, flat ``[P·T]`` (int64), and the block mask ``[P, T]`` in
    ``dtype``; on the card made once per labels array."""
    def make():
        blocks = build_subject_blocks(labels, id_covariate)
        idx = staged(blocks.index.reshape(-1).astype(np.int64), torch.long, device)
        return idx, staged(blocks.mask, dtype, device)

    if device.type != "cuda":
        return make()
    return _cached(labels, ("blocks", id_covariate, dtype, device), make)


def host_noise(parts: Sequence[Tuple[tuple, torch.dtype, Optional[torch.Tensor]]],
               generator: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
    """The noise ``parts``, each ``(shape, dtype, given)``, flat and one after
    another in one host slab (pinned on the card) of their promoted dtype:
    ``given`` where it is not None (cast to ``dtype``), else a
    standard-normal draw of ``shape`` in ``dtype`` from ``generator``, all
    from one fresh generator seeded 0 when that is None, in the parts'
    order. :func:`split_noise` takes the parts back out."""
    dtype = functools.reduce(torch.promote_types, (d for _, d, _ in parts))
    sizes = [math.prod(shape) for shape, _, _ in parts]
    slab = torch.empty(sum(sizes), dtype=dtype, pin_memory=device.type == "cuda")
    start = 0
    for (shape, part_dtype, given), n in zip(parts, sizes):
        if given is None:
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            given = torch.randn(shape, generator=generator, dtype=part_dtype)
        slab[start:start + n] = given.reshape(-1).to(part_dtype)
        start += n
    return slab


def split_noise(slab: torch.Tensor, parts: Sequence[Tuple[tuple, torch.dtype]]) -> list:
    """The parts ``(shape, dtype)`` of a :func:`host_noise` slab."""
    out, start = [], 0
    for shape, dtype in parts:
        n = math.prod(shape)
        out.append(slab[start:start + n].reshape(shape).to(dtype))
        start += n
    return out

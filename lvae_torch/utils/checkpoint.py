"""Checkpoint and resume: the port's own format.

A checkpoint is ONE ``torch.save`` file holding a dict of CPU tensors and
plain values, so it loads with ``weights_only=True`` on any device. A
training state is stored whole, so resume is exact:

* ``vae`` — the VAE's ``state_dict``;
* ``gp`` — the GP hyperparameters (``kp0``/``kp1`` raw scale and
  lengthscale, ``raw_noise``);
* ``m``, ``h_factor``, ``z`` — the variational parameters and learnable
  inducing points where the regime trains them; ``m_nat``, ``H_nat`` — the
  natural-gradient variational parameters;
* ``opt`` — the optimizer's ``state_dict`` (Adam's moments and step, or
  :class:`~lvae_torch.kernels_cuda.adam.FusedAdam`'s flat moments);
* ``rng`` — the CPU generator's state; ``step``;
* ``metadata`` — the caller's dict (epoch, validation loss, ...).

A pre-trained VAE is stored alone (kind ``vae``, its ``state_dict``). A VI
state (kind ``vi``) holds ``mu``, ``log_var``, ``vae``, ``gp``, ``opt`` and
``rng``; the VI regime's prediction set (kind ``vi_prediction``) the dict
``{"mu_pred", "log_var_pred"}``. A
training state is restored INTO a live one (``like``): tensors are copied in place,
so the optimizer keeps its references to the parameters, and each tensor
lands on the device and in the dtype of the one it replaces.

Three writers, the counterparts of the JAX package's ``checkpoint_backend``
values:

* ``pickle`` — :func:`save_checkpoint`, the file above;
* ``orbax`` — :func:`save_checkpoint_dir`, a directory holding the same
  payload (``state.pt``) and a JSON file (``checkpoint.json``: format,
  version, metadata): the path is a link to a snapshot directory beside
  it (``.<name>.snapshot-<id>``). This is the port's own layout, not
  orbax's OCDBT/tensorstore one;
* ``orbax_async`` — :func:`save_checkpoint_async`, the same directory
  written by a background thread while training goes on;
  :func:`wait_for_async_saves` waits for it.

Every write goes to a new sibling that is committed in one step (a rename
of the file, or of a link to the directory, over the path), so a crash
leaves the old checkpoint or the new one at the path, never half of one;
:func:`leftovers` names what a crash left beside it. The readers
take a file or a directory alike, so a run resumes across writers. The JAX
package's pickle and orbax files are not read here: ``utils/convert.py``
carries a JAX state over where JAX is installed.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import uuid
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from lvae_torch.train.state import GPParams, HensmanState
from lvae_torch.train.vi import VIState

PREDICTION_KEYS = ("mu_pred", "log_var_pred")

FORMAT = "lvae_torch"
VERSION = 1


STATE_FILE = "state.pt"  # a directory checkpoint's payload
META_FILE = "checkpoint.json"  # its format, version and metadata


def _cpu(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t``: a device tensor's move to the host is the copy."""
    t = t.detach()
    return t.clone() if t.device.type == "cpu" else t.to("cpu")


def _map_tensors(fn: Callable[[torch.Tensor], torch.Tensor], x):
    """``x`` with ``fn`` applied to every tensor in it, in one fixed order."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, dict):
        return {k: _map_tensors(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_map_tensors(fn, v) for v in x)
    return x  # an optimizer's hyperparameters and step counts


def _gp_dict(gp: GPParams) -> Dict[str, torch.Tensor]:
    return {
        "kp0.raw_scale": gp.kp0.raw_scale,
        "kp0.raw_lengthscale": gp.kp0.raw_lengthscale,
        "kp1.raw_scale": gp.kp1.raw_scale,
        "kp1.raw_lengthscale": gp.kp1.raw_lengthscale,
        "raw_noise": gp.raw_noise,
    }


def _payload_refs(state: Any) -> Dict[str, Any]:
    """The checkpoint dict of ``state`` over the state's own tensors (no
    copy, save the generator's state): :func:`state_payload` copies it to
    the host, :class:`AsyncSaver` into pinned buffers."""
    if isinstance(state, nn.Module):
        return {"kind": "vae", "vae": state.state_dict()}
    if isinstance(state, dict):
        return {"kind": "vi_prediction",
                **{k: torch.as_tensor(np.asarray(state[k])) for k in PREDICTION_KEYS}}
    if isinstance(state, VIState):
        return {"kind": "vi", "mu": state.mu, "log_var": state.log_var,
                "vae": state.vae.state_dict(), "gp": _gp_dict(state.gp),
                "opt": state.opt_state.state_dict(), "rng": state.rng.get_state()}
    tr = state.trainables
    hensman = isinstance(state, HensmanState)
    out: Dict[str, Any] = {
        "kind": "hensman" if hensman else "standard",
        "vae": tr.vae.state_dict(), "gp": _gp_dict(tr.gp),
        "m": tr.m, "h_factor": tr.h_factor, "z": tr.z,
        "opt": state.opt_state.state_dict(),
        "rng": state.rng.get_state(),
        "step": int(state.step),
    }
    if hensman:
        out.update(m_nat=state.m_nat, H_nat=state.H_nat)
    return out


def state_payload(state: Any) -> Dict[str, Any]:
    """The checkpoint dict of ``state``, every tensor a host copy: a bare
    VAE module (kind ``vae``, a pre-training result), a Hensman, standard
    or VI training state, or the VI prediction set's dict of arrays."""
    return _map_tensors(_cpu, _payload_refs(state))


def _commit(new: str, path: str) -> None:
    """Put ``new`` (a finished file, or a finished snapshot directory) at
    ``path`` in one step: a file is renamed over ``path``; a directory stays
    where it was written and a symbolic link to it is renamed over
    ``path``. A rename replaces a file or a link at once, so ``path`` holds
    the old checkpoint or the new one at every moment; the snapshot
    directory that ``path`` linked to before is removed after. A directory
    at ``path`` that this module did not write (not a link) cannot be
    replaced at once: it is moved aside first."""
    old = os.path.realpath(path) if os.path.islink(path) else None
    if os.path.isdir(new):
        link = new + ".link"
        os.symlink(os.path.basename(new), link)
        new = link
    aside = None
    if old is None and os.path.isdir(path):
        aside = os.path.join(os.path.dirname(path),
                             f".{os.path.basename(path)}.replaced-{uuid.uuid4().hex}")
        os.rename(path, aside)
    try:
        os.replace(new, path)
    except BaseException:
        if aside is not None:
            os.rename(aside, path)
        raise
    for gone in (old, aside):
        if gone is not None:
            shutil.rmtree(gone, ignore_errors=True)


def leftovers(folder: str) -> List[str]:
    """The entries of ``folder`` that a crash or a failed write left behind:
    temporary files, and snapshot directories (with their links) that no
    checkpoint in ``folder`` refers to."""
    def ours(n: str) -> bool:
        return n.endswith(".tmp") or (n.startswith(".") and (".snapshot-" in n
                                                             or ".replaced-" in n))

    names = os.listdir(folder)
    used = {os.path.basename(os.readlink(os.path.join(folder, n))) for n in names
            if os.path.islink(os.path.join(folder, n)) and not ours(n)}
    return sorted(n for n in names if ours(n) and n not in used)


def save_checkpoint(path: str, state: Any, metadata: Optional[dict] = None) -> str:
    """Write ``state`` (see :func:`state_payload`) to the file ``path``
    atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = state_payload(state)
    payload.update(format=FORMAT, version=VERSION, metadata=dict(metadata or {}))
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    _commit(tmp, path)
    return path


def _meta_json(metadata: Optional[dict]) -> str:
    return json.dumps({"format": FORMAT, "version": VERSION, "metadata": dict(metadata or {})})


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_dir(path: str, payload: Dict[str, Any], meta: str) -> None:
    """Write the directory checkpoint ``path``: ``payload`` and ``meta``
    into a new sibling snapshot directory with a unique name, each file
    synced to disk, then committed at ``path`` (:func:`_commit`). What an
    earlier crash left beside ``path`` is removed first; a snapshot that
    fails here is removed, and ``path`` keeps what it held."""
    path = os.path.abspath(path)
    parent, name = os.path.split(path)
    os.makedirs(parent, exist_ok=True)
    for stale in leftovers(parent):
        if stale.startswith(f".{name}."):
            stale = os.path.join(parent, stale)
            if os.path.isdir(stale) and not os.path.islink(stale):
                shutil.rmtree(stale)
            else:
                os.remove(stale)
    snapshot = os.path.join(parent, f".{name}.snapshot-{uuid.uuid4().hex}")
    os.mkdir(snapshot)
    try:
        with open(os.path.join(snapshot, STATE_FILE), "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(snapshot, META_FILE), "w") as f:
            f.write(meta)
            f.flush()
            os.fsync(f.fileno())
        _fsync(snapshot)
        _commit(snapshot, path)
    except BaseException:
        shutil.rmtree(snapshot, ignore_errors=True)
        raise
    _fsync(parent)


def save_checkpoint_dir(path: str, state: Any, metadata: Optional[dict] = None) -> str:
    """Write ``state`` (see :func:`state_payload`) as the directory ``path``,
    committed atomically over whatever ``path`` held (the ``orbax``
    backend)."""
    _write_dir(path, state_payload(state), _meta_json(metadata))
    return path


class AsyncSaver:
    """Directory checkpoints written by a background thread (the
    ``orbax_async`` backend), one in flight at a time.

    :meth:`save` waits for the save in flight, then snapshots the state on
    the caller's current CUDA stream: each device tensor is copied without
    blocking into pinned host buffers (allocated once per payload layout
    and reused), and an event is recorded after the copies. The step, the
    generator's state and the metadata are copied at the call. It returns
    without waiting for the device; a writer thread waits on the event,
    then writes and commits as :func:`save_checkpoint_dir` does. Work the
    caller queues on that stream afterwards (the next replayed steps, which
    update the state in place) runs after the copies, so it cannot change
    what is saved. On the CPU the snapshot is a host copy made at the call.

    A failure in the writer is kept and raised by :meth:`wait` or by the
    next :meth:`save`, whichever comes first; the path keeps the checkpoint
    it held."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        self._buffers: Dict[tuple, List[torch.Tensor]] = {}
        # the last snapshot's event, released here and not in the writer's
        # thread, which may run while this thread captures a CUDA graph
        self._done: Optional[torch.cuda.Event] = None

    def save(self, path: str, state: Any, metadata: Optional[dict] = None) -> str:
        self.wait()
        meta = _meta_json(metadata)
        refs = _payload_refs(state)
        on_card: List[torch.Tensor] = []
        _map_tensors(lambda t: on_card.append(t) if t.is_cuda else None, refs)
        done = None
        if on_card:
            key = tuple((t.device, t.dtype, tuple(t.shape)) for t in on_card)
            if key not in self._buffers:
                self._buffers[key] = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                                      for t in on_card]
            buffers = iter(self._buffers[key])
            payload = _map_tensors(
                lambda t: (next(buffers).copy_(t.detach(), non_blocking=True) if t.is_cuda
                           else _cpu(t)),
                refs)
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(on_card[0].device))
        else:
            payload = _map_tensors(_cpu, refs)
        self._done = done
        self._thread = threading.Thread(target=self._write, args=(path, payload, meta, done),
                                        name="lvae-checkpoint-writer")
        self._thread.start()
        return path

    def _write(self, path: str, payload: Dict[str, Any], meta: str,
               done: Optional[torch.cuda.Event]) -> None:
        try:
            if done is not None:
                done.synchronize()
            _write_dir(path, payload, meta)
        except Exception as e:  # noqa: BLE001 — kept, raised by wait() or the next save
            self._error = e

    def wait(self) -> None:
        """Wait for the save in flight; raise the writer's failure, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error


_saver = AsyncSaver()


def save_checkpoint_async(path: str, state: Any, metadata: Optional[dict] = None) -> str:
    """Snapshot ``state`` and write it as the directory ``path`` in the
    background (see :class:`AsyncSaver`); call :func:`wait_for_async_saves`
    before reading it."""
    return _saver.save(path, state, metadata)


def wait_for_async_saves() -> None:
    """Wait for the background save in flight; raise its failure, if any."""
    _saver.wait()


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint dict at ``path`` (a file or a directory), every tensor
    on the CPU."""
    if os.path.isdir(path):
        with open(os.path.join(path, META_FILE)) as f:
            head = json.load(f)
        payload = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                             weights_only=True)
        payload.update(head)
    else:
        payload = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        raise ValueError(f"{path} is not an lvae_torch checkpoint")
    if payload.get("version") != VERSION:
        raise ValueError(f"unsupported lvae_torch checkpoint version {payload.get('version')}")
    return payload


def _copy_into(dst: Optional[torch.Tensor], src: Optional[torch.Tensor], name: str):
    if (dst is None) != (src is None):
        raise ValueError(f"checkpoint entry {name!r}: present in one state, absent in the other")
    if dst is None:
        return
    if tuple(dst.shape) != tuple(src.shape):
        raise ValueError(f"checkpoint entry {name!r}: shape {tuple(src.shape)}, "
                         f"expected {tuple(dst.shape)}")
    with torch.no_grad():
        dst.copy_(src)


def _like_tensor(src: Optional[torch.Tensor], like: Optional[torch.Tensor]):
    if src is None or like is None:
        return src if like is None else None
    return src.to(device=like.device, dtype=like.dtype)


def _restore_gp(dst: GPParams, gp: Dict[str, torch.Tensor]) -> None:
    for name, t in (("kp0.raw_scale", dst.kp0.raw_scale),
                    ("kp0.raw_lengthscale", dst.kp0.raw_lengthscale),
                    ("kp1.raw_scale", dst.kp1.raw_scale),
                    ("kp1.raw_lengthscale", dst.kp1.raw_lengthscale),
                    ("raw_noise", dst.raw_noise)):
        _copy_into(t, gp[name], name)


def _kind_of(like: Any) -> str:
    if isinstance(like, dict):
        return "vi_prediction"
    if isinstance(like, VIState):
        return "vi"
    return "hensman" if isinstance(like, HensmanState) else "standard"


def restore_into(payload: Dict[str, Any], like: Any) -> Any:
    """Copy a training checkpoint dict into the live training state
    ``like`` (the trainables in place) and return the restored state; for
    the VI prediction set's dict, return the stored arrays as numpy."""
    kind, want = payload["kind"], _kind_of(like)
    if kind != want:
        raise ValueError(f"a {kind!r} checkpoint does not restore a {want} state")
    if kind == "vi_prediction":
        return {k: payload[k].numpy() for k in PREDICTION_KEYS}
    if kind == "vi":
        for name in ("mu", "log_var"):
            _copy_into(getattr(like, name), payload[name], name)
        like.vae.load_state_dict(payload["vae"])
        _restore_gp(like.gp, payload["gp"])
        like.opt_state.load_state_dict(payload["opt"])
        like.rng.set_state(payload["rng"])
        return like
    tr = like.trainables
    tr.vae.load_state_dict(payload["vae"])
    _restore_gp(tr.gp, payload["gp"])
    for name in ("m", "h_factor", "z"):
        _copy_into(getattr(tr, name), payload.get(name), name)
    like.opt_state.load_state_dict(payload["opt"])
    like.rng.set_state(payload["rng"])
    like = like._replace(step=int(payload["step"]))
    if isinstance(like, HensmanState):
        like = like._replace(m_nat=_like_tensor(payload.get("m_nat"), like.m_nat),
                             H_nat=_like_tensor(payload.get("H_nat"), like.H_nat))
    return like


def load_checkpoint(path: str, like: Optional[Any] = None) -> Any:
    """The checkpoint at ``path``: restored into ``like`` when given (see
    :func:`restore_into`), else the checkpoint dict itself."""
    payload = read_checkpoint(path)
    return payload if like is None else restore_into(payload, like)


def try_load_checkpoint(path: str, like: Optional[Any] = None) -> Optional[Any]:
    """:func:`load_checkpoint`, or None when nothing is at ``path`` or it
    cannot be read (with a printed reason): a corrupt checkpoint starts afresh."""
    if not os.path.exists(path):
        return None
    try:
        return load_checkpoint(path, like)
    except Exception as e:  # noqa: BLE001 — any unreadable checkpoint → fresh start
        print(f"Checkpoint load failed ({path}): {e}")
        return None


def vae_state_dict(payload: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """The VAE ``state_dict`` inside any checkpoint dict that holds one."""
    if "vae" not in payload:
        raise ValueError(f"a {payload.get('kind')!r} checkpoint holds no VAE")
    return payload["vae"]


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
lands on the device and in the dtype of the one it replaces. Writes go to a
temporary file renamed over the target, so a crash never leaves half a
checkpoint. The JAX package's pickle and orbax files are not read here:
``utils/convert.py`` carries a JAX state over where JAX is installed.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch
from torch import nn

from lvae_torch.train.state import GPParams, HensmanState
from lvae_torch.train.vi import VIState

PREDICTION_KEYS = ("mu_pred", "log_var_pred")

FORMAT = "lvae_torch"
VERSION = 1


def _cpu(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    return None if t is None else t.detach().to("cpu").clone()


def _cpu_tree(x):
    if isinstance(x, torch.Tensor):
        return _cpu(x)
    if isinstance(x, dict):
        return {k: _cpu_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu_tree(v) for v in x)
    return x  # an optimizer's hyperparameters and step counts


def _gp_dict(gp: GPParams) -> Dict[str, torch.Tensor]:
    return {
        "kp0.raw_scale": _cpu(gp.kp0.raw_scale),
        "kp0.raw_lengthscale": _cpu(gp.kp0.raw_lengthscale),
        "kp1.raw_scale": _cpu(gp.kp1.raw_scale),
        "kp1.raw_lengthscale": _cpu(gp.kp1.raw_lengthscale),
        "raw_noise": _cpu(gp.raw_noise),
    }


def _vae_sd(vae: nn.Module) -> Dict[str, torch.Tensor]:
    return {k: _cpu(v) for k, v in vae.state_dict().items()}


def state_payload(state: Any) -> Dict[str, Any]:
    """The checkpoint dict of ``state``: a bare VAE module (kind ``vae``, a
    pre-training result), a Hensman, standard or VI training state, or the
    VI prediction set's dict of arrays."""
    if isinstance(state, nn.Module):
        return {"kind": "vae", "vae": _vae_sd(state)}
    if isinstance(state, dict):
        return {"kind": "vi_prediction",
                **{k: torch.as_tensor(np.asarray(state[k])).clone() for k in PREDICTION_KEYS}}
    if isinstance(state, VIState):
        return {"kind": "vi", "mu": _cpu(state.mu), "log_var": _cpu(state.log_var),
                "vae": _vae_sd(state.vae), "gp": _gp_dict(state.gp),
                "opt": _cpu_tree(state.opt_state.state_dict()), "rng": state.rng.get_state()}
    tr = state.trainables
    hensman = isinstance(state, HensmanState)
    out: Dict[str, Any] = {
        "kind": "hensman" if hensman else "standard",
        "vae": _vae_sd(tr.vae), "gp": _gp_dict(tr.gp),
        "m": _cpu(tr.m), "h_factor": _cpu(tr.h_factor), "z": _cpu(tr.z),
        "opt": _cpu_tree(state.opt_state.state_dict()),
        "rng": state.rng.get_state(),
        "step": int(state.step),
    }
    if hensman:
        out.update(m_nat=_cpu(state.m_nat), H_nat=_cpu(state.H_nat))
    return out


def save_checkpoint(path: str, state: Any, metadata: Optional[dict] = None) -> str:
    """Write ``state`` (see :func:`state_payload`) to ``path`` atomically."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    payload = state_payload(state)
    payload.update(format=FORMAT, version=VERSION, metadata=dict(metadata or {}))
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path


def read_checkpoint(path: str) -> Dict[str, Any]:
    """The checkpoint dict at ``path``, every tensor on the CPU."""
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
    """:func:`load_checkpoint`, or None when the file is missing or cannot
    be read (with a printed reason): a corrupt checkpoint starts afresh."""
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


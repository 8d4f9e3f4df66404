"""Carry trained weights over from the JAX package (numpy arrays in, tensors out).

Layout conversions (flax → torch), the inverse of the reference-checkpoint
import in the JAX package's ``utils/torch_compat.py``:

  Conv               kernel [kH, kW, I, O]         → weight [O, I, kH, kW]
  ConvTranspose      kernel [kH, kW, I, O], flipped → weight [I, O, kH, kW]
                     (PyTorch's transposed conv correlates with the spatially
                     flipped kernel relative to lax.conv_transpose)
  Dense              kernel [I, O]                 → weight [O, I]

The ConvVAE's ``fc1`` consumes, and ``fc4`` produces, the flattened feature
map, whose order is H-W-C in flax (NHWC) and C-H-W in PyTorch (NCHW): their
input and output axes are permuted accordingly. Nothing here imports JAX:
the caller passes the flax params tree with numpy-convertible leaves.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from lvae_torch.ops.kernels import KernelParams
from lvae_torch.train.state import GPParams

_LINEARS = ("fc1", "fc21", "fc211", "fc221", "fc3", "fc31", "fc4")


def _np(arr) -> np.ndarray:
    return np.asarray(arr, dtype=np.float32)


def vae_state_dict_from_jax(params) -> Dict[str, torch.Tensor]:
    """flax ConvVAE/SimpleVAE params tree → the port's ``state_dict``."""
    p = params["params"]
    sd: Dict[str, np.ndarray] = {}
    for name in _LINEARS:
        sd[f"{name}.weight"] = _np(p[name]["kernel"]).T
        sd[f"{name}.bias"] = _np(p[name]["bias"])
    if "conv1" in p:
        for name in ("conv1", "conv2"):
            sd[f"{name}.weight"] = _np(p[name]["kernel"]).transpose(3, 2, 0, 1)
            sd[f"{name}.bias"] = _np(p[name]["bias"])
        for name in ("deconv1", "deconv2"):
            k = _np(p[name]["kernel"])  # [kH, kW, I, O], flipped
            sd[f"{name}.weight"] = k[::-1, ::-1].transpose(2, 3, 0, 1)
            sd[f"{name}.bias"] = _np(p[name]["bias"])
        feat = sd["fc1.weight"].shape[1] // 32
        f = int(round(feat ** 0.5))
        w = sd["fc1.weight"]  # [300, f·f·32] in H-W-C input order
        sd["fc1.weight"] = w.reshape(-1, f, f, 32).transpose(0, 3, 1, 2).reshape(w.shape[0], -1)
        w = sd["fc4.weight"]  # [f·f·32, 300] rows in H-W-C order
        sd["fc4.weight"] = w.reshape(f, f, 32, -1).transpose(2, 0, 1, 3).reshape(-1, w.shape[1])
        sd["fc4.bias"] = sd["fc4.bias"].reshape(f, f, 32).transpose(2, 0, 1).reshape(-1)
    sd["raw_log_vy"] = _np(p["raw_log_vy"])
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in sd.items()}


def gp_params_from_jax(gp, dtype=torch.float32) -> GPParams:
    """A JAX ``GPParams`` (``kp0``, ``kp1``, ``raw_noise``; numpy-convertible
    leaves) → the port's :class:`GPParams` on the CPU."""

    def t(x) -> torch.Tensor:
        return torch.tensor(np.asarray(x), dtype=dtype)

    def kp(k) -> KernelParams:
        return KernelParams(raw_scale=t(k.raw_scale), raw_lengthscale=t(k.raw_lengthscale))

    return GPParams(kp0=kp(gp.kp0), kp1=kp(gp.kp1), raw_noise=t(gp.raw_noise))

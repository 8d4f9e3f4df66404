"""Chunked dataset encoding and decoding (port of lvae_tpu.evaluation.encode).

A dataset is cut into fixed-size chunks of rows, the tail padded with row 0
(the JAX package's pad rule), and each chunk goes through the model in
``eval()`` mode without autograd; the input is in the parameters' dtype
and the model casts it to its compute dtype. :func:`encode_dataset` and
:func:`decode_latents` are programs (``evaluation/programs.py``) of one
shape ``(n_chunks, chunk)`` each, the chunk loop inside, as JAX's
``lax.scan``: on the card a replay of a captured CUDA graph into a fixed
output, which comes to the host in one pinned copy, as numpy in the
parameters' dtype (a bf16 model's outputs upcast to f32: numpy has no
bfloat16). :func:`vae_forward` is one program too and keeps its tensors on
the device, in the model's compute dtype.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from lvae_torch.evaluation import programs
from lvae_torch.train.graph import finish_host_copy, start_host_copy
from lvae_torch.utils.device import resolve_device


def _on(model: nn.Module, device) -> Tuple[nn.Module, torch.device]:
    dev = resolve_device(device)
    return model.to(dev).eval(), dev


def frame_shape(model: nn.Module) -> tuple:
    """One decoded frame's shape: ``(H, W, 1)`` for the ConvVAE, else
    ``(num_dim,)``."""
    if model.is_conv:
        return (model.image_hw, model.image_hw, 1)
    return (model.num_dim,)


def forward(model: nn.Module, x: torch.Tensor, eps: Optional[torch.Tensor] = None):
    """The VAE forward on ``x``: ``(reconstruction, mu, log_var)``, with
    ``z = mu`` when ``eps`` is None, else ``mu + eps·exp(½ log_var)``."""
    mu, log_var = model.encode(x)
    z = mu if eps is None else mu + eps.to(mu.device, mu.dtype) * torch.exp(0.5 * log_var)
    return model.decode(z), mu, log_var


def chunks(x: torch.Tensor, batch_size: int) -> list:
    """``x`` in ``ceil(N / bs)`` chunks of ``bs = min(batch_size, N)`` rows,
    the last one padded with copies of row 0 (the JAX package's
    ``_chunk_indices`` rule)."""
    n = x.shape[0]
    bs = min(batch_size, n)
    out = [x[i:i + bs] for i in range(0, n - bs + 1, bs)]
    if n % bs:
        tail = x[n // bs * bs:]
        out.append(torch.cat([tail, x[:1].expand((bs - tail.shape[0],) + x.shape[1:])]))
    return out


def vae_forward(model: nn.Module, x: torch.Tensor, eps: Optional[torch.Tensor] = None):
    """The full VAE forward in ``eval()`` mode without autograd, one
    program: ``(reconstruction, mu, log_var)`` of the tensor ``x`` on the
    model's device. ``z = mu`` when ``eps`` is None, else the
    reparameterised sample ``mu + eps·exp(½ log_var)`` with the given noise
    ``[N, L]`` (a host tensor or one on the device)."""
    model.eval()
    dev = model.raw_log_vy.device
    n, latent = x.shape[0], model.latent_dim
    frame = math.prod(frame_shape(model))
    inputs = [x] if eps is None else [x, eps]

    def program(x, eps=None):
        recon, mu, log_var = forward(model, x, eps)
        return torch.cat([recon.reshape(n, frame), mu, log_var], dim=1)

    out_dtype = getattr(model, "compute_dtype", None) or model.raw_log_vy.dtype
    out = programs.run("vae_forward", program, inputs, (n, frame + 2 * latent), out_dtype,
                       dev, model)
    recon, mu, log_var = out.split([frame, latent, latent], dim=1)
    return recon.reshape((n,) + frame_shape(model)), mu, log_var


def encode_dataset(
    model: nn.Module, data, batch_size: int = 1000, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode every sample: ``(mu [N, L], log_var [N, L])``. For an RNN
    encoder the rows must be subject-major, N a multiple of its ``T``.
    ``data`` is a host array, or a tensor (a dataset's, on the device:
    ``programs.dataset_tensor``).

    The model is moved to ``device`` (in place, as ``nn.Module.to`` does)."""
    model, dev = _on(model, device)
    dtype = model.raw_log_vy.dtype
    if not isinstance(data, torch.Tensor):
        data = np.asarray(data)
    n = data.shape[0]
    if n == 0:
        empty = np.zeros((0, model.latent_dim), np.float32)
        return empty, empty.copy()
    t = getattr(model, "T", None)
    if t:
        # a recurrent encoder consumes whole subject sequences: chunks are
        # multiples of T, and the row-0 tail padding forms whole fake
        # subjects that never mix into a real one's recurrence
        if n % t:
            raise ValueError(
                f"RNN encoder needs subject-major data with N divisible by T={t}; got N={n}")
        batch_size = max(t, min(batch_size, n) // t * t)

    def program(x):
        mus, lvs = zip(*(model.encode(c) for c in chunks(x, batch_size)))
        return torch.stack([torch.cat(mus)[:n], torch.cat(lvs)[:n]]).to(dtype)

    out = programs.run("encode", program, [programs.staged(data, dtype, dev)],
                       (2, n, model.latent_dim), dtype, dev, model, (batch_size,))
    mu, lv = finish_host_copy(start_host_copy(out)).numpy()
    return mu, lv


def decode_on_device(model: nn.Module, z: torch.Tensor, batch_size: int = 1000) -> torch.Tensor:
    """Decode latents ``[N, L]`` (N > 0; a host or device tensor) on the
    model's device in fixed-size chunks, one program: frames in the
    parameters' dtype, on the device."""
    model.eval()
    dtype = model.raw_log_vy.dtype
    n = z.shape[0]

    def program(z):
        return torch.cat([model.decode(c) for c in chunks(z.to(dtype), batch_size)])[:n].to(dtype)

    return programs.run("decode", program, [z], (n,) + frame_shape(model), dtype,
                        model.raw_log_vy.device, model, (batch_size,))


def decode_latents(model: nn.Module, z, batch_size: int = 1000, device="cuda") -> np.ndarray:
    """Decode latents ``[N, L]`` (a host array, or a tensor on the device)
    to data space in fixed-size chunks (the same pad/chunk rule as
    :func:`encode_dataset`), one program, its output copied to the host
    once."""
    model, dev = _on(model, device)
    dtype = model.raw_log_vy.dtype
    if not isinstance(z, torch.Tensor):
        z = np.asarray(z)
    if z.shape[0] == 0:
        return np.zeros((0,) + frame_shape(model), torch.empty((), dtype=dtype).numpy().dtype)
    out = decode_on_device(model, programs.staged(z, dtype, dev), batch_size)
    return finish_host_copy(start_host_copy(out)).numpy()

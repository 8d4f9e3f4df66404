"""Chunked dataset encoding and decoding (port of lvae_tpu.evaluation.encode).

A dataset is cut into fixed-size chunks of row indices, the tail padded with
row 0 (the JAX package's pad rule), and each chunk goes through the model in
``eval()`` mode without autograd. Results come back to the host as numpy.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
from torch import nn

from lvae_torch.utils.device import resolve_device


def _chunk_indices(n: int, batch_size: int) -> np.ndarray:
    bs = min(batch_size, n)
    n_chunks = (n + bs - 1) // bs
    pad = n_chunks * bs - n
    idx = np.concatenate([np.arange(n), np.zeros(pad, np.int64)])
    return idx.reshape(n_chunks, bs)


def _on(model: nn.Module, device) -> Tuple[nn.Module, torch.device]:
    dev = resolve_device(device)
    return model.to(dev).eval(), dev


@torch.inference_mode()
def encode_dataset(
    model: nn.Module, data, batch_size: int = 1000, device="cuda"
) -> Tuple[np.ndarray, np.ndarray]:
    """Encode every sample: ``(mu [N, L], log_var [N, L])``.

    The model is moved to ``device`` (in place, as ``nn.Module.to`` does)."""
    model, dev = _on(model, device)
    data = np.asarray(data, np.float32)
    n = data.shape[0]
    if n == 0:
        empty = np.zeros((0, model.latent_dim), np.float32)
        return empty, empty.copy()
    idx = _chunk_indices(n, batch_size)
    x = torch.from_numpy(data).to(dev)
    mus, lvs = [], []
    for chunk in torch.from_numpy(idx).to(dev):
        mu, lv = model.encode(x[chunk])
        mus.append(mu)
        lvs.append(lv)
    mu = torch.cat(mus)[:n].float().cpu().numpy()
    lv = torch.cat(lvs)[:n].float().cpu().numpy()
    return mu, lv


@torch.inference_mode()
def decode_latents(model: nn.Module, z, batch_size: int = 1000, device="cuda") -> np.ndarray:
    """Decode latents ``[N, L]`` to data space in fixed-size chunks."""
    model, dev = _on(model, device)
    z = np.asarray(z, np.float32)
    n = z.shape[0]
    if n == 0:  # one zero row through the decoder fixes the output shape
        out = model.decode(torch.zeros((1, z.shape[1]), dtype=torch.float32, device=dev))
        return out.cpu().numpy()[:0]
    idx = _chunk_indices(n, batch_size)  # the same pad/chunk rule as encode
    zt = torch.from_numpy(z).to(dev)
    outs = [model.decode(zt[chunk]) for chunk in torch.from_numpy(idx).to(dev)]
    return torch.cat(outs)[:n].cpu().numpy()

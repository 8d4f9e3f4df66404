"""Image-sequence generation and its frame grids (port of
lvae_tpu.evaluation.generation).

``recon_complete_gen`` decodes GP-predicted latents of the generation
cohort; ``vae_output`` reconstructs pre-training frames. Each lays its
frames out in the reference's grid, one column per timepoint covariate, and
always saves the grid as ``.npz`` beside the PDF's name (``grid [rows, 20,
H, W]`` with ``filled [rows, 20]``, empty cells 0). The PDF is drawn only
where matplotlib imports; otherwise one line says it was skipped.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from lvae_torch.evaluation import programs
from lvae_torch.evaluation.encode import decode_on_device, vae_forward
from lvae_torch.ops.predict import predict_latent_rows
from lvae_torch.train.graph import finish_host_copy, start_host_copy
from lvae_torch.utils.device import resolve_device

COLUMNS = 20


def _place(grid, filled, row: int, frames, first: int, times) -> None:
    """Frames ``first, first + 1, ...`` into ``row`` at the column of their
    timepoint; a later frame in the same cell covers the earlier one."""
    for i, t in enumerate(times):
        if first + i < frames.shape[0]:
            grid[row, int(t)] = frames[first + i]
            filled[row, int(t)] = True


def recon_grid(x, recon_x, labels, seq_length: int = 16, num_sets: int = 3,
               image_hw=(36, 36)) -> Tuple[np.ndarray, np.ndarray]:
    """Pairs of (data, reconstruction) rows, frames at column = timepoint:
    the pre-training plot's layout."""
    x = np.asarray(x).reshape((-1,) + tuple(image_hw))
    recon_x = np.asarray(recon_x).reshape((-1,) + tuple(image_hw))
    labels = np.asarray(labels)
    grid = np.zeros((2 * num_sets, COLUMNS) + tuple(image_hw), np.float32)
    filled = np.zeros((2 * num_sets, COLUMNS), bool)
    for j in range(num_sets):
        begin, end = seq_length * j, seq_length * (j + 1)
        _place(grid, filled, 2 * j, x, begin, labels[begin:end, 0])
        _place(grid, filled, 2 * j + 1, recon_x, begin, labels[begin:end, 0])
    return grid, filled


def seqrecon_grid(x, recon_x, labels_train, image_hw=(36, 36), num_sets: int = 8,
                  seq_length: int = 20) -> Tuple[np.ndarray, np.ndarray]:
    """The generation grid: one data row and two predicted rows per subject
    set, then a spacer row. Two reference quirks are kept: set ``j``'s data
    row strides by ``seq_length`` while its predicted rows stride by
    ``2·seq_length``, and every row reads its timepoints from
    ``labels_train``."""
    x = np.asarray(x).reshape((-1,) + tuple(image_hw))
    recon_x = np.asarray(recon_x).reshape((-1,) + tuple(image_hw))
    labels_train = np.asarray(labels_train)
    grid = np.zeros((4 * num_sets - 1, COLUMNS) + tuple(image_hw), np.float32)
    filled = np.zeros((4 * num_sets - 1, COLUMNS), bool)
    for j in range(num_sets):
        begin_data, end_data = seq_length * j, seq_length * (j + 1)
        begin_label = seq_length * 2 * j
        mid_label = seq_length * (2 * j + 1)
        end_label = seq_length * 2 * (j + 1)
        _place(grid, filled, 4 * j, x, begin_data, labels_train[begin_data:end_data, 0])
        _place(grid, filled, 4 * j + 1, recon_x, begin_label,
               labels_train[begin_label:mid_label, 0])
        _place(grid, filled, 4 * j + 2, recon_x, mid_label,
               labels_train[mid_label:end_label, 0])
    return grid, filled


def save_grid(pdf_path: str, grid: np.ndarray, filled: np.ndarray,
              figsize=(12, 20)) -> str:
    """Write ``grid``/``filled`` to the ``.npz`` beside ``pdf_path``, and the
    PDF itself where matplotlib imports. Returns the ``.npz`` path."""
    npz = os.path.splitext(pdf_path)[0] + ".npz"
    os.makedirs(os.path.dirname(os.path.abspath(npz)), exist_ok=True)
    np.savez(npz, grid=grid, filled=filled)
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {os.path.basename(pdf_path)} not drawn "
              f"(grid saved to {npz})")
        return npz
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(grid.shape[0], grid.shape[1], squeeze=False)
    for r in range(grid.shape[0]):
        for c in range(grid.shape[1]):
            a = ax[r, c]
            a.set_xticks([])
            a.set_yticks([])
            a.axis("off")
            if filled[r, c]:
                a.imshow(grid[r, c], cmap="gray")
    fig.set_size_inches(*figsize)
    plt.savefig(pdf_path, bbox_inches="tight")
    plt.close("all")
    return npz


@torch.no_grad()
def recon_complete_gen(
    generation_dataset,
    model,
    gp_params,
    noise,
    spec0,
    spec1,
    prediction_x: np.ndarray,
    prediction_mu: np.ndarray,
    z,
    id_covariate: int,
    results_path: str,
    epoch: int = -1,
    eps: float = 1e-6,
    verbose: bool = True,
    device="cuda",
) -> str:
    """Decode the GP-predicted latents of the generation cohort (the
    posterior program hands its latents to the decode program on the
    device; one copy to the host) and save its grid as
    ``recon_complete.npz`` (``recon_complete_best.npz`` for a best-model
    snapshot, ``epoch != -1``), with the PDF where matplotlib is installed.
    Returns the ``.npz`` path."""
    if verbose:
        print(f"Generating images - length of dataset:  {len(generation_dataset)}")
    dev = resolve_device(device)
    dtype = np.asarray(prediction_mu).dtype
    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    gp = gp_params.to(device=dev, dtype=tdtype)
    z_pred = predict_latent_rows(
        spec0, spec1, gp.kp0, gp.kp1, programs.on_device(noise, tdtype, dev),
        np.asarray(prediction_x, dtype), np.asarray(prediction_mu, dtype),
        np.asarray(generation_dataset.labels, dtype), programs.on_device(z, tdtype, dev),
        id_covariate, eps,
    )
    model.to(dev)
    recon = finish_host_copy(start_host_copy(decode_on_device(model, z_pred))).numpy()
    filename = "recon_complete.pdf" if epoch == -1 else "recon_complete_best.pdf"
    data = np.asarray(generation_dataset.data)
    labels = np.asarray(generation_dataset.labels)
    n_sets = max(1, min(8, data.shape[0] // 40))
    grid, filled = seqrecon_grid(data[: n_sets * 20], recon[: n_sets * 40],
                                 labels[: n_sets * 40], num_sets=n_sets)
    return save_grid(os.path.join(results_path, filename), grid, filled)


@torch.no_grad()
def vae_output(
    model, dataset, epoch: int, save_path: str, enc_eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None, num_sets: int = 8, seq_length: int = 20,
    device="cuda",
) -> str:
    """Reconstructions of the first frames during pre-training, saved as
    ``recon_VAE_<epoch>.npz`` (and ``.pdf``). Returns the ``.npz`` path."""
    dev = resolve_device(device)
    model.to(dev)
    n = min(len(dataset), 1000)
    dtype = model.raw_log_vy.dtype
    data = programs.staged(np.asarray(dataset.data)[:n], dtype, dev)
    slab = programs.host_noise([((n, model.latent_dim), dtype, enc_eps)], generator, dev)
    recon, _, _ = vae_forward(model, data, slab.reshape(n, -1))
    lo = min(40, max(0, n - num_sets * seq_length))
    hi = min(n, lo + num_sets * seq_length)
    avail_sets = max(1, (hi - lo) // seq_length)
    recon = recon.to(data.dtype)  # a bf16 model's frames, upcast for numpy
    grid, filled = recon_grid(data.cpu().numpy()[lo:hi], recon.cpu().numpy()[lo:hi],
                              np.asarray(dataset.labels)[lo:hi], seq_length=seq_length,
                              num_sets=avail_sets)
    return save_grid(os.path.join(save_path, f"recon_VAE_{epoch}.pdf"), grid, filled,
                     figsize=(9, 1.5 * avail_sets))

"""Test-cohort evaluation: VAE-reconstruction MSE and GP-prediction MSE
(port of lvae_tpu.evaluation.testing).

Writes the reference's evaluation artefact ``result_error.csv`` = [mean
masked VAE-reconstruction MSE, mean masked GP-prediction MSE] with
``np.savetxt``. The VAE path reconstructs one reparameterised sample in one
program, ``recon_mse`` (forward and masked MSE; on the card a replay of a
captured CUDA graph, read on the host once); its noise ``[N, L]`` is drawn
from a CPU generator (seeded 0 unless one is given) or injected, as in
``evaluation/validate.py``. The GP path predicts the test latents on the
device (the sparse posterior program of ``ops/predict.py``, or the exact
per-dim regression, eager) and hands them to the decode program without a
round trip through the host.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from lvae_torch.evaluation import programs
from lvae_torch.evaluation.encode import decode_on_device, forward
from lvae_torch.models import vae as mv
from lvae_torch.ops import kernels as kx
from lvae_torch.ops import linalg as la
from lvae_torch.ops.linalg import _full_precision
from lvae_torch.ops.predict import predict_latent_rows
from lvae_torch.train.graph import finish_host_copy, start_host_copy
from lvae_torch.utils.device import resolve_device


class TestResult(NamedTuple):
    vae_mse: float
    gp_mse: float


def _masked_mse_mean(model, recon, data, mask) -> float:
    mse_i, _ = mv.vae_loss(model.raw_log_vy.detach(), recon, data, mask)
    return float(torch.mean(mse_i))


def _recon_mse(model, test_dataset, dev, enc_eps, generator):
    """(data, mask, masked MSE of the sampled reconstruction) on ``dev``, in
    the model's dtype: the ``recon_mse`` program, one host read."""
    model.to(dev).eval()
    dtype = model.raw_log_vy.dtype
    data = programs.dataset_tensor(test_dataset.data, dtype, dev)
    mask = programs.dataset_tensor(test_dataset.mask, dtype, dev)
    shape = (data.shape[0], model.latent_dim)
    slab = programs.host_noise([(shape, dtype, enc_eps)], generator, dev)

    def program(data, mask, slab):
        (eps,) = programs.split_noise(slab, [(shape, dtype)])
        recon, _, _ = forward(model, data, eps)
        mse_i, _ = mv.vae_loss(model.raw_log_vy.detach(), recon, data, mask)
        return torch.mean(mse_i).reshape(1)

    mse = programs.run("recon_mse", program, [data, mask, slab], (1,), dtype, dev, model)
    return data, mask, float(finish_host_copy(start_host_copy(mse))[0])


def cap_prediction_rows(prediction_x: np.ndarray, prediction_mu: np.ndarray,
                        max_prediction_rows: int = 6040, seed: int = 0):
    """The reference's subsample of a prediction cohort larger than
    ``max_prediction_rows``: its first 40 rows plus ``max_prediction_rows −
    40`` others drawn with ``numpy.random.default_rng(seed)`` (40 + 6000 =
    6040 by default); a smaller cohort as it is."""
    prediction_x = np.asarray(prediction_x)
    prediction_mu = np.asarray(prediction_mu)
    if prediction_x.shape[0] > max_prediction_rows:
        head = min(40, max_prediction_rows)
        r = np.random.default_rng(seed).choice(
            prediction_x.shape[0] - head, max_prediction_rows - head, replace=False,
        ) + head
        ind = np.concatenate([np.arange(head), r])
        prediction_x = prediction_x[ind]
        prediction_mu = prediction_mu[ind]
    return prediction_x, prediction_mu


def _save(result: TestResult, results_path: Optional[str], save_file: str) -> TestResult:
    if results_path is not None:
        os.makedirs(results_path, exist_ok=True)
        np.savetxt(os.path.join(results_path, save_file),
                   np.asarray([result.vae_mse, result.gp_mse]))
    return result


@torch.no_grad()
def mse_test_gp_approx(
    model,
    gp_params,
    noise,
    spec0,
    spec1,
    test_dataset,
    prediction_x: np.ndarray,
    prediction_mu: np.ndarray,
    z,
    id_covariate: int,
    eps: float = 1e-6,
    results_path: Optional[str] = None,
    save_file: str = "result_error.csv",
    enc_eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    verbose: bool = True,
    device="cuda",
    mesh=None,
) -> TestResult:
    """Sparse-GP test evaluation: (1) the VAE reconstruction's masked MSE;
    (2) the test latents predicted from the prediction cohort's encodings
    through the sparse posterior, decoded, and their masked MSE. With
    ``mesh`` the posterior runs mesh-parallel (every rank of the mesh calls
    this)."""
    if verbose:
        print("Running tests with a test set")
        print(f"Length of test dataset:  {len(test_dataset)}")
    dev = resolve_device(device)
    dtype = np.asarray(prediction_mu).dtype
    data, mask, vae_mse = _recon_mse(model, test_dataset, dev, enc_eps, generator)
    if verbose:
        print(f"Decoder loss: {vae_mse}")
    tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
    gp = gp_params.to(device=dev, dtype=tdtype)
    z_pred = predict_latent_rows(
        spec0, spec1, gp.kp0, gp.kp1, programs.on_device(noise, tdtype, dev),
        np.asarray(prediction_x, dtype), np.asarray(prediction_mu, dtype),
        np.asarray(test_dataset.labels, dtype), programs.on_device(z, tdtype, dev),
        id_covariate, eps, mesh=mesh,
    )
    gp_mse = _masked_mse_mean(model, decode_on_device(model, z_pred), data, mask)
    if verbose:
        print(f"Decoder loss (GP): {gp_mse}")
    return _save(TestResult(vae_mse=vae_mse, gp_mse=gp_mse), results_path, save_file)


@_full_precision
def exact_gp_predict_per_dim(spec_full, gp_params_full, px, tx, noise, mu, eps: float = 0.0):
    """Exact GP regression one latent dim at a time, so the dense ``[N, N]``
    matrices never stack up over the latents; ``eps`` adds diagonal jitter
    on top of the likelihood noise (duplicate covariate rows make K
    rank-deficient). Returns ``[N_test, L]``.

    It runs eagerly on the card too, by rule: one dim at the reference's
    6040-row cap is a ``[6040, 6040]`` f32 factor (about 146 MB) and
    milliseconds of device time, so the work is bound by the device, not by
    the host's launches; JAX's ``lax.map`` over the latents is there to
    bound memory, not dispatch. ``chip_smoke.py`` measures its idle share.
    On the card the kernel matrices take the plain path: a dim's parameters
    are ``[C]``, outside K3's ``[L, C]`` gate (as in the JAX package)."""
    n = px.shape[0]
    eye = torch.eye(n, dtype=px.dtype, device=px.device)
    out = []
    for raw_s, raw_l, noise_l, mu_l in zip(gp_params_full.raw_scale,
                                           gp_params_full.raw_lengthscale, noise, mu.T):
        kp_l = kx.KernelParams(raw_scale=raw_s, raw_lengthscale=raw_l)
        k_l = kx.kernel_matrix(spec_full, kp_l, px, px)
        kc_l = kx.kernel_matrix(spec_full, kp_l, tx, px)
        lk = la.cholesky(k_l + (noise_l + eps) * eye)
        sol = la.cho_solve(lk, mu_l[:, None])
        out.append(kc_l @ sol[:, 0])
    return torch.stack(out, dim=1)


@torch.no_grad()
def mse_test_exact(
    model,
    gp_params_full: kx.KernelParams,
    spec_full: kx.KernelSpec,
    noise,
    test_dataset,
    prediction_x: np.ndarray,
    prediction_mu: np.ndarray,
    eps: float = 1e-6,
    results_path: Optional[str] = None,
    max_prediction_rows: int = 6040,
    seed: int = 0,
    verbose: bool = True,
    save_file: str = "result_error.csv",
    enc_eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    device="cuda",
) -> TestResult:
    """Exact N×N GP test evaluation (the ``type_KL='closed'`` regime): a
    dense kernel over the prediction cohort, per-latent-dim GP regression to
    the test covariates, eager (:func:`exact_gp_predict_per_dim`), then the
    decode program. A prediction cohort larger than ``max_prediction_rows``
    is cut by :func:`cap_prediction_rows`."""
    if verbose:
        print("Running tests with a test set")
    dev = resolve_device(device)
    prediction_x, prediction_mu = cap_prediction_rows(prediction_x, prediction_mu,
                                                      max_prediction_rows, seed)
    data, mask, vae_mse = _recon_mse(model, test_dataset, dev, enc_eps, generator)
    if verbose:
        print(f"Decoder loss: {vae_mse}")
    tdtype = torch.from_numpy(np.zeros(0, prediction_mu.dtype)).dtype
    z_pred = exact_gp_predict_per_dim(
        spec_full, gp_params_full.to(device=dev, dtype=tdtype),
        programs.staged(prediction_x, tdtype, dev),
        programs.dataset_tensor(test_dataset.labels, tdtype, dev),
        programs.on_device(noise, tdtype, dev), programs.staged(prediction_mu, tdtype, dev),
        eps=eps,
    )
    gp_mse = _masked_mse_mean(model, decode_on_device(model, z_pred), data, mask)
    if verbose:
        print(f"Decoder loss (GP): {gp_mse}")
    return _save(TestResult(vae_mse=vae_mse, gp_mse=gp_mse), results_path, save_file)


@torch.no_grad()
def vae_test(model, test_dataset, enc_eps: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None, verbose: bool = True,
             device="cuda") -> float:
    """VAE-only test MSE."""
    if verbose:
        print(f"Length of test dataset:  {len(test_dataset)}")
    _, _, m = _recon_mse(model, test_dataset, resolve_device(device), enc_eps, generator)
    if verbose:
        print(f"Decoder loss: {m}")
    return m


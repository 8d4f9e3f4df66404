"""Everything a run feeds the program and the reference, made from the seed.

The cohort has the Health MNIST layout: covariates ``[time_age,
disease_time, subject, gender, disease, location]`` per frame (disease_time
0 for a healthy subject), ``T`` consecutive frames a subject, frames uniform
in [0, 1] and a pixel mask with a stated share unobserved. The covariates
are drawn with numpy (a copy of ``chip_smoke.make_cohort``'s rule); the
frames, the mask and every weight are drawn on the run's device with one
``torch.Generator`` in a few large calls. The same seed gives the same
inputs on the same device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from perfbench.reference import model as rm

COVARIATES = 6


def covariates(rng: np.random.Generator, subject_ids, t: int) -> np.ndarray:
    """``[len(subject_ids)·t, 6]`` float32 covariates, subject-major."""
    time_points = np.arange(t, dtype=np.float64) - (t // 2 - 1)
    rows = []
    for s in subject_ids:
        sick, gender, loc = (int(v) for v in rng.integers(0, 2, 3))
        for i in range(t):
            rows.append([i, time_points[i] if sick else 0.0, s, gender, sick, loc])
    return np.asarray(rows, np.float32).reshape(-1, COVARIATES)


class Maker:
    """The seed's draws, in a fixed order: numpy for covariates and the
    inducing points, a ``torch.Generator`` on ``device`` for the rest."""

    def __init__(self, seed: int, device):
        self.rng = np.random.default_rng(seed)
        self.device = torch.device(device)
        self.gen = torch.Generator(device=self.device).manual_seed(seed)

    def uniform(self, shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.gen, device=self.device)

    def normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self.gen, device=self.device)

    def cohort(self, cfg: dict, subject_ids, pixel_missing: float) -> dict:
        """Host arrays ``frames [n, hw, hw, 1]``, ``labels [n, 6]``,
        ``pixmask [n, hw²]`` for the subjects."""
        hw = math.isqrt(cfg["num_dim"])
        labels = covariates(self.rng, subject_ids, cfg["T"])
        n = labels.shape[0]
        frames = self.uniform((n, hw, hw, 1))
        pixmask = (self.uniform((n, hw * hw)) >= pixel_missing).float()
        return {"frames": frames.cpu().numpy(), "labels": labels,
                "pixmask": pixmask.cpu().numpy()}

    def inducing(self, labels: np.ndarray, m: int) -> np.ndarray:
        """``m`` distinct cohort rows' covariates."""
        return labels[self.rng.choice(labels.shape[0], size=m, replace=False)].copy()

    def state(self, cfg: dict, comps: tuple) -> dict:
        """The starting state on the device, f32: every ConvVAE weight and
        bias U(±√(6/fan-in)) (fan-in: the weight's first slice; He's uniform
        rule, so that the activations keep their scale through the ReLUs
        and the decoded frames depend on the latents, as a trained
        network's do; PyTorch's default U(±1/√fan-in) decodes every latent
        to nearly the same frame), the observation
        log-variance at ``vy_init``; the kernel scales and lengthscales
        log-uniform within a factor e^±½ of their defaults (log 2 and
        2.5); the noise at 1; and with natural gradients
        m ~ N(0, 1), H = h hᵀ + 0.1·I with h ~ N(0, 1)/10."""
        hw = math.isqrt(cfg["num_dim"])
        n_lat = cfg["latent_dim"]
        shapes = [(k, s) for k, s in rm.conv_vae_shapes(n_lat, hw) if k != "raw_log_vy"]
        flat = self.uniform((sum(math.prod(s) for _, s in shapes),)) * 2.0 - 1.0
        out, at = {}, 0
        fan = {}
        for k, s in shapes:
            layer = k.rsplit(".", 1)[0]
            if k.endswith("weight"):
                fan[layer] = math.prod(s[1:])
            n = math.prod(s)
            out["vae." + k] = flat[at:at + n].reshape(s) * math.sqrt(6.0 / fan[layer])
            at += n
        out["vae.raw_log_vy"] = torch.full(
            (hw * hw,), math.log(cfg["vy_init"] - math.exp(rm.MIN_LOG_VY)), device=self.device)
        c0, c1 = (len(c) for c in comps)
        u = self.uniform((4, n_lat, max(c0, c1))) - 0.5
        out["gp.kp0.raw_scale"] = math.log(math.log(2.0)) + u[0, :, :c0]
        out["gp.kp0.raw_lengthscale"] = math.log(2.5) + u[1, :, :c0]
        out["gp.kp1.raw_scale"] = math.log(math.log(2.0)) + u[2, :, :c1]
        out["gp.kp1.raw_lengthscale"] = math.log(2.5) + u[3, :, :c1]
        out["gp.raw_noise"] = torch.zeros(n_lat, device=self.device)
        if cfg.get("natural_gradient"):
            m_ind = cfg["M"]
            out["m"] = self.normal((n_lat, m_ind, 1))
            h = self.normal((n_lat, m_ind, m_ind)).double() / 10.0
            eye = torch.eye(m_ind, dtype=h.dtype, device=self.device)
            out["H"] = (h @ h.mT + 0.1 * eye).float()
        return {k: v.contiguous() for k, v in out.items()}

"""A GPPVAE step's operations by the plain reference's algorithm
(:mod:`perfbench.reference.gppvae`), counted as :mod:`perfbench.counts`
counts: the no-grad encode of the cohort's P·T frames, P replays of T
frames each through the encoder and the decoder with their backward, and
the DUBO at ``[L, P, T]`` with its backward (twice its forward)."""

from __future__ import annotations

import math

from perfbench.counts import _spd_inverse, vae_flops


def dubo_flops(n_lat: int, p: int, t: int, m: int) -> float:
    """The DUBO's forward: K0zz's factor and inverse, each subject's
    ``B = K1 + σ²I`` factor and inverse, ``B⁻¹ K0xz``, ``K0zx B⁻¹ K0xz`` and
    ``K0zx B⁻¹ D B⁻¹ K0xz``, W's factor and inverse, the quadratic form
    through ``B⁻¹μ``, ``K0zx B⁻¹μ`` and W⁻¹, and the three traces."""
    per_latent = (2 * _spd_inverse(m)  # K0zz and W
                  + p * _spd_inverse(t)  # the B chain
                  + 2 * p * t * t * m  # B⁻¹ K0xz
                  + 2 * 2 * p * t * m * m  # K0zx B⁻¹ K0xz and K0zx B⁻¹ D B⁻¹ K0xz
                  + 2 * p * t * t + 2 * p * t * m + 2 * m * m + 2 * m  # the quadratic form
                  + 2 * p * t * t + 2 * 2 * m * m)  # tr(B⁻¹ K0), tr(S K0zz⁻¹), tr(W⁻¹ G)
    return n_lat * per_latent


def step_flops(cfg: dict) -> float:
    n_lat, p, t, m = cfg["latent_dim"], cfg["P"], cfg["T"], cfg["M"]
    hw = math.isqrt(cfg["num_dim"])
    n = p * t
    encode = vae_flops(n_lat, hw, n, 0, False)
    replays = p * vae_flops(n_lat, hw, t, t, True)
    return encode + replays + 3 * dubo_flops(n_lat, p, t, m)

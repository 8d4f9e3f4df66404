"""Work counts from shapes: each kernel's least time, and a step's floating
point operations for the model-FLOP utilisation.

The peaks are NVIDIA's for one H100 SXM at its 700 W limit: 3.35 TB/s of
HBM3 and 67 TFLOP/s in f32 outside the tensor cores (the program keeps TF32
off). The three bounds are copies of ``chip_smoke.py``'s ``b_chain_bound``,
``chol_inv_bound`` and ``kernel_matrix_bound``: each input byte read once,
each output byte written once, and the operations the algorithm needs (an
``exp`` one operation); the bound is the larger of the two times.

The operation counts follow the plain reference's algorithm. A convolution
or matrix product is 2·m·n·k; a Cholesky factor n³/3; the inverse of an SPD
matrix from its factor 2n³/3; elementwise work (kernel evaluations,
activations, the losses) is not counted. A training step's backward pass is
counted as twice the forward of every layer and product it differentiates,
except the first convolution, whose input needs no gradient (once).
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def _bound_ms(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS_PER_S) * 1e3


def chol_inv_bound_ms(shape) -> float:
    """K2, (L, A⁻¹) of an f32 stack ``[..., n, n]``: read A, write L and A⁻¹;
    about n³ operations a matrix."""
    n, batch = shape[-1], math.prod(shape[:-2])
    return _bound_ms(3 * batch * n * n * 4, batch * n ** 3)


def b_chain_bound_ms(n_lat: int, n_subj: int, t: int, q: int, c0: int, c1: int) -> float:
    """K1, the per-subject chain of ``B = K1 + σ²I`` ``[L, S, T, T]``: read the
    parameters, σ², covariates and mask, write B⁻¹ and two scalars a block;
    T³ operations a block, 8 a component and entry for K0 and K1, 2 an entry
    for the trace."""
    nbytes = 4 * (n_lat * n_subj * (t * t + 2) + n_subj * t * (q + 1)
                  + n_lat * (2 * c0 + 2 * c1 + 1))
    ops = n_lat * n_subj * (t ** 3 + (8 * (c0 + c1) + 2) * t * t)
    return _bound_ms(nbytes, ops)


def kernel_matrix_bound_ms(n_lat: int, n1: int, n2: int, q: int, c: int, n_rbf: int) -> float:
    """K3, ``K [L, N1, N2]``: read covariates and parameters, write K; an
    ``exp`` and four operations an entry for each squared-exponential
    component, two for each other one."""
    nbytes = 4 * (n_lat * n1 * n2 + (n1 + n2) * q + 2 * n_lat * c)
    ops = n_lat * n1 * n2 * (5 * n_rbf + 2 * (c - n_rbf))
    return _bound_ms(nbytes, ops)


def conv_vae_layers(latent_dim: int, hw: int) -> list:
    """``(layer, forward operations a frame)`` of the ConvVAE, encoder then
    decoder."""
    f = hw // 4
    flat = 32 * f * f
    return [
        ("conv1", 2 * hw * hw * 16 * 1 * 9),
        ("conv2", 2 * (hw // 2) ** 2 * 32 * 16 * 9),
        ("fc1", 2 * flat * 300),
        ("fc21", 2 * 300 * 30),
        ("fc211", 2 * 30 * latent_dim),
        ("fc221", 2 * 30 * latent_dim),
        ("fc3", 2 * latent_dim * 30),
        ("fc31", 2 * 30 * 300),
        ("fc4", 2 * 300 * flat),
        # a transposed convolution: each input position times C_in, C_out, k²
        ("deconv1", 2 * f * f * 32 * 16 * 16),
        ("deconv2", 2 * (2 * f) ** 2 * 16 * 1 * 16),
    ]


ENCODER = ("conv1", "conv2", "fc1", "fc21", "fc211", "fc221")


def vae_flops(latent_dim: int, hw: int, encode_frames: int, decode_frames: int,
              train: bool) -> float:
    """The network's operations on ``encode_frames`` frames through the
    encoder and ``decode_frames`` through the decoder, with the backward
    pass when ``train``."""
    total = 0.0
    for name, ops in conv_vae_layers(latent_dim, hw):
        frames = encode_frames if name in ENCODER else decode_frames
        mult = 1 + (0 if not train else 1 if name == "conv1" else 2)
        total += mult * ops * frames
    return total


def _spd_inverse(n: int) -> float:
    return n ** 3 / 3 + 2 * n ** 3 / 3


def hensman_step_flops(cfg: dict) -> float:
    """One Hensman step: the network on S·T frames, the minibatch KL and
    its backward, the natural-gradient step."""
    n_lat, s, t, m = cfg["latent_dim"], cfg["subjects_per_batch"], cfg["T"], cfg["M"]
    hw = math.isqrt(cfg["num_dim"])
    # forward products and factorisations the KL differentiates
    kl = n_lat * (2 * _spd_inverse(m)  # K0zz and H
                  + s * _spd_inverse(t)  # the B chain
                  + 2 * s * t * t * m  # B⁻¹ K0xz
                  + 2 * s * t * m * m  # K0zx B⁻¹ K0xz
                  + 2 * m * m + 2 * s * t * m + 2 * s * t * t  # the residual's quadratic form
                  + 4 * m ** 3)  # K0zz⁻¹ H K0zz⁻¹
    natural = n_lat * (4 * m ** 3  # K0zz⁻¹ S K0zz⁻¹
                       + 2 * s * t * t + 2 * s * t * m  # K0zx B⁻¹ μ
                       + 2 * _spd_inverse(m)  # the new H and its check
                       + 6 * m * m)
    return vae_flops(n_lat, hw, s * t, s * t, True) + 3 * kl + natural


def closed_step_flops(cfg: dict) -> float:
    """One full-batch closed-KL step: the network on N = P·T frames, the
    N×N KL of each latent (factor, inverse, quadratic form) and its
    backward."""
    n_lat, n = cfg["latent_dim"], cfg["P"] * cfg["T"]
    hw = math.isqrt(cfg["num_dim"])
    kl = n_lat * (_spd_inverse(n) + 2 * n * n)
    return vae_flops(n_lat, hw, n, n, True) + 3 * kl

"""The Health MNIST ConvVAE in plain torch, on a dict of weight tensors.

Encoder: conv 1→16 (3×3, pad 1), ReLU, 2×2 max-pool, conv 16→32, ReLU,
max-pool, dense 32·(hw/4)²→300→30, ReLU after each, then two dense 30→L heads
(mean, log-variance). Decoder: dense L→30→300→32·(hw/4)², ReLU after each,
transposed conv 32→16 (4×4, stride 2, pad 1), ReLU, transposed conv 16→1,
sigmoid. Images are ``[N, hw, hw, 1]``; the flattened feature map is in
channel-height-width order. Dropout is 0 in every configuration here.
"""

from __future__ import annotations

import math

import torch
from torch.nn import functional as F

MIN_LOG_VY = -8.0


def conv_vae_shapes(latent_dim: int, hw: int) -> list:
    """``(name, shape)`` of every weight, in the order the benchmark draws
    them; ``raw_log_vy`` is the per-pixel observation log-variance."""
    f = hw // 4
    flat = 32 * f * f
    return [
        ("conv1.weight", (16, 1, 3, 3)), ("conv1.bias", (16,)),
        ("conv2.weight", (32, 16, 3, 3)), ("conv2.bias", (32,)),
        ("fc1.weight", (300, flat)), ("fc1.bias", (300,)),
        ("fc21.weight", (30, 300)), ("fc21.bias", (30,)),
        ("fc211.weight", (latent_dim, 30)), ("fc211.bias", (latent_dim,)),
        ("fc221.weight", (latent_dim, 30)), ("fc221.bias", (latent_dim,)),
        ("fc3.weight", (30, latent_dim)), ("fc3.bias", (30,)),
        ("fc31.weight", (300, 30)), ("fc31.bias", (300,)),
        ("fc4.weight", (flat, 300)), ("fc4.bias", (flat,)),
        ("deconv1.weight", (32, 16, 4, 4)), ("deconv1.bias", (16,)),
        ("deconv2.weight", (16, 1, 4, 4)), ("deconv2.bias", (1,)),
        ("raw_log_vy", (hw * hw,)),
    ]


def encode(w: dict, x: torch.Tensor):
    """Images ``[N, hw, hw, 1]`` → (mean, log-variance), each ``[N, L]``."""
    h = x.permute(0, 3, 1, 2)
    h = F.max_pool2d(F.relu(F.conv2d(h, w["conv1.weight"], w["conv1.bias"], padding=1)), 2)
    h = F.max_pool2d(F.relu(F.conv2d(h, w["conv2.weight"], w["conv2.bias"], padding=1)), 2)
    h = h.reshape(h.shape[0], -1)
    h = F.relu(F.linear(h, w["fc1.weight"], w["fc1.bias"]))
    h = F.relu(F.linear(h, w["fc21.weight"], w["fc21.bias"]))
    return (F.linear(h, w["fc211.weight"], w["fc211.bias"]),
            F.linear(h, w["fc221.weight"], w["fc221.bias"]))


def decode(w: dict, z: torch.Tensor) -> torch.Tensor:
    """Latents ``[N, L]`` → images ``[N, hw, hw, 1]`` in (0, 1)."""
    h = F.relu(F.linear(z, w["fc3.weight"], w["fc3.bias"]))
    h = F.relu(F.linear(h, w["fc31.weight"], w["fc31.bias"]))
    h = F.relu(F.linear(h, w["fc4.weight"], w["fc4.bias"]))
    f = math.isqrt(h.shape[1] // 32)
    h = h.reshape(h.shape[0], 32, f, f)
    h = F.relu(F.conv_transpose2d(h, w["deconv1.weight"], w["deconv1.bias"], stride=2,
                                  padding=1))
    h = F.conv_transpose2d(h, w["deconv2.weight"], w["deconv2.bias"], stride=2, padding=1)
    return torch.sigmoid(h).permute(0, 2, 3, 1)


def recon_losses(raw_log_vy: torch.Tensor, recon: torch.Tensor, x: torch.Tensor,
                 pixmask: torch.Tensor):
    """Per-frame (masked MSE, Gaussian NLL) as the reference implementation
    takes them: the MSE over the observed pixels (at least one), the NLL's
    constant ½(log 2π + raw_log_vy) added for every pixel."""
    n, d = recon.shape[0], raw_log_vy.shape[0]
    se = (recon.reshape(n, d) - x.reshape(n, d)) ** 2 * pixmask.reshape(n, d)
    mse = se.sum(1) / pixmask.reshape(n, d).sum(1).clamp(min=1.0)
    nll = se / (2.0 * torch.exp(raw_log_vy)) + 0.5 * (math.log(2.0 * math.pi) + raw_log_vy)
    return mse, nll.sum(1)

"""VAE encoder/decoder families (port of lvae_tpu.models.vae).

* :class:`ConvVAE` — for 36×36 single-channel images: conv16→pool→conv32→
  pool→FC 2592→300→30→latent, mirrored decoder with two stride-2 transposed
  convolutions and a sigmoid output.
* :class:`SimpleVAE` — MLP num_dim→300→30→latent and mirror.
* ``models/rnn.RNNVAE`` — a bidirectional LSTM/GRU encoder over each
  subject's sequence and an MLP decoder (``type_nnet='rnn'``).

Both carry a learnable per-pixel observation noise ``raw_log_vy``, a
softplus-floored log-variance with floor ``exp(-8)``.

Layout: the public methods take and return images as NHWC ``[N, H, W, 1]``,
the JAX package's layout; inside, the convolutions run NCHW. The flattened
feature map after the conv stack is in C-H-W order (the PyTorch reference
models' order); ``utils/convert.py`` permutes the JAX weights to it.
Channel-wise spatial dropout is ``Dropout2d``, off in ``eval()``.
:func:`vae_loss` is the masked reconstruction loss of training.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from lvae_torch.ops.linalg import full_precision

MIN_LOG_VY = -8.0


def _vy_init_raw(vy_init: float, num_dim: int, dtype: torch.dtype) -> torch.Tensor:
    """raw = log(vy_init - exp(min_log_vy))."""
    return torch.full((num_dim,), math.log(vy_init - math.exp(MIN_LOG_VY)), dtype=dtype)


def floored_log_vy(raw_log_vy: torch.Tensor) -> torch.Tensor:
    """``min + softplus(raw - min)`` — the floored log observation variance."""
    x = raw_log_vy - MIN_LOG_VY
    return MIN_LOG_VY + torch.logaddexp(x, torch.zeros_like(x))


class ConvVAE(nn.Module):
    """Convolutional VAE for single-channel ``image_hw``×``image_hw`` images
    (``image_hw`` divisible by 4: two 2× pools)."""

    is_conv = True

    def __init__(
        self,
        latent_dim: int,
        num_dim: int = 36 * 36,
        vy_init: float = 1.0,
        p_input: float = 0.2,
        p: float = 0.5,
        image_hw: int = 36,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        if image_hw % 4:
            raise ValueError(f"image_hw must be divisible by 4, got {image_hw}")
        self.latent_dim = latent_dim
        self.num_dim = num_dim
        self.p_input = p_input  # stored for config parity; unused, as in the reference
        self.image_hw = image_hw
        f = image_hw // 4
        self.feat_hw = f
        kw = {"dtype": dtype}
        self.conv1 = nn.Conv2d(1, 16, 3, padding=1, **kw)
        self.conv2 = nn.Conv2d(16, 32, 3, padding=1, **kw)
        self.fc1 = nn.Linear(32 * f * f, 300, **kw)
        self.fc21 = nn.Linear(300, 30, **kw)
        self.fc211 = nn.Linear(30, latent_dim, **kw)
        self.fc221 = nn.Linear(30, latent_dim, **kw)
        self.fc3 = nn.Linear(latent_dim, 30, **kw)
        self.fc31 = nn.Linear(30, 300, **kw)
        self.fc4 = nn.Linear(300, 32 * f * f, **kw)
        self.deconv1 = nn.ConvTranspose2d(32, 16, 4, stride=2, padding=1, **kw)
        self.deconv2 = nn.ConvTranspose2d(16, 1, 4, stride=2, padding=1, **kw)
        self.drop2d = nn.Dropout2d(p)
        self.drop = nn.Dropout(p)
        self.raw_log_vy = nn.Parameter(_vy_init_raw(vy_init, num_dim, dtype))

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """images ``[N, H, W, 1]`` → (mu, log_var), each ``[N, L]``."""
        with full_precision():
            h = x.permute(0, 3, 1, 2)
            h = self.drop2d(F.max_pool2d(F.relu(self.conv1(h)), 2))
            h = self.drop2d(F.max_pool2d(F.relu(self.conv2(h)), 2))
            h = h.reshape(h.shape[0], -1)  # C-H-W order
            h = self.drop(F.relu(self.fc1(h)))
            h = self.drop(F.relu(self.fc21(h)))
            return self.fc211(h), self.fc221(h)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latents ``[N, L]`` → images ``[N, H, W, 1]``."""
        with full_precision():
            h = self.drop(F.relu(self.fc3(z)))
            h = self.drop(F.relu(self.fc31(h)))
            h = F.relu(self.fc4(h))
            h = self.drop2d(h.reshape(h.shape[0], 32, self.feat_hw, self.feat_hw))
            h = self.drop2d(F.relu(self.deconv1(h)))
            return torch.sigmoid(self.deconv2(h)).permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        """(reconstruction, mu, log_var); ``z = mu`` unless a generator is
        given, then a reparameterised sample."""
        mu, log_var = self.encode(x)
        z = mu if generator is None else sample_latent(mu, log_var, generator)
        return self.decode(z), mu, log_var


class SimpleVAE(nn.Module):
    """MLP VAE for flat data ``[N, num_dim]``."""

    is_conv = False

    def __init__(
        self, latent_dim: int, num_dim: int, vy_init: float = 1.0,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.latent_dim = latent_dim
        self.num_dim = num_dim
        kw = {"dtype": dtype}
        self.fc1 = nn.Linear(num_dim, 300, **kw)
        self.fc21 = nn.Linear(300, 30, **kw)
        self.fc211 = nn.Linear(30, latent_dim, **kw)
        self.fc221 = nn.Linear(30, latent_dim, **kw)
        self.fc3 = nn.Linear(latent_dim, 30, **kw)
        self.fc31 = nn.Linear(30, 300, **kw)
        self.fc4 = nn.Linear(300, num_dim, **kw)
        self.raw_log_vy = nn.Parameter(_vy_init_raw(vy_init, num_dim, dtype))

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        with full_precision():
            h = F.relu(self.fc1(x.reshape(x.shape[0], -1)))
            h = F.relu(self.fc21(h))
            return self.fc211(h), self.fc221(h)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        with full_precision():
            return torch.sigmoid(self.fc4(F.relu(self.fc31(F.relu(self.fc3(z))))))

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        mu, log_var = self.encode(x)
        z = mu if generator is None else sample_latent(mu, log_var, generator)
        return self.decode(z), mu, log_var


def sample_latent(
    mu: torch.Tensor, log_var: torch.Tensor, generator: torch.Generator
) -> torch.Tensor:
    """Reparameterised sample ``mu + eps·exp(½ log_var)``; ``generator``
    must live on ``mu``'s device."""
    eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype, device=mu.device)
    return mu + eps * torch.exp(0.5 * log_var)


def vae_loss(
    raw_log_vy: torch.Tensor,
    recon_x: torch.Tensor,
    x: torch.Tensor,
    mask: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked reconstruction losses per sample: (mse ``[N]``, nll ``[N]``).

    Two quirks of the reference are kept: the MSE is normalised by the
    number of *observed* pixels (clamped to at least 1), and the NLL adds the
    Gaussian constant ``½(log 2π + raw_log_vy)`` for every pixel, masked or
    not, with the *unfloored* raw log-variance."""
    n = recon_x.shape[0]
    num_dim = raw_log_vy.shape[0]
    tx = x.reshape(n, num_dim)
    rx = recon_x.reshape(n, num_dim).to(tx.dtype)
    mk = mask.reshape(n, num_dim).to(tx.dtype)
    se = (rx - tx) ** 2 * mk
    mask_sum = torch.clamp(torch.sum(mk, dim=1), min=1.0)
    mse = torch.sum(se, dim=1) / mask_sum
    raw = raw_log_vy.to(tx.dtype)
    nll = se / (2.0 * torch.exp(raw)) + 0.5 * (math.log(2.0 * math.pi) + raw)
    return mse, torch.sum(nll, dim=1)


def vy_from_params(model: nn.Module) -> torch.Tensor:
    """Observation variance ``vy = exp(floored_log_vy(raw_log_vy))``."""
    return torch.exp(floored_log_vy(model.raw_log_vy))


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Redraw every linear and convolution layer from ``generator`` with
    PyTorch's default scheme, U(±1/√fan_in) for weight and bias, and every
    recurrent layer's tensors with U(±1/√hidden) (an RNN's biases that
    flax's cells lack stay zero, ``models/rnn.pinned_bias_mask``)."""
    from lvae_torch.models.rnn import pinned_bias_mask

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (nn.Linear, nn.Conv2d, nn.ConvTranspose2d)):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                mod.weight.uniform_(-bound, bound, generator=generator)
                mod.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(mod, (nn.LSTM, nn.GRU)):
                bound = 1.0 / math.sqrt(mod.hidden_size)
                pinned = pinned_bias_mask(model.type_rnn, mod.hidden_size)
                for name, w in mod.named_parameters():
                    w.uniform_(-bound, bound, generator=generator)
                    if name in pinned:
                        w.mul_(pinned[name].to(w.dtype))
    return model


def make_vae(
    type_nnet: str,
    latent_dim: int,
    num_dim: int,
    vy_init: float = 1.0,
    dropout: float = 0.5,
    dropout_input: float = 0.2,
    generator: Optional[torch.Generator] = None,
    dtype: torch.dtype = torch.float32,
    T: Optional[int] = None,
    hidden_dim: int = 64,
    type_rnn: str = "lstm",
) -> nn.Module:
    """Model selection as the reference's flags name it; with ``generator``
    the weights are drawn from it (see :func:`init_weights`). ``dtype`` is
    the parameters' type whatever torch's default dtype is. ``T``,
    ``hidden_dim`` and ``type_rnn`` shape the RNN encoder, which needs
    ``T``."""
    if type_nnet == "conv":
        hw = int(round(num_dim ** 0.5))
        if hw * hw != num_dim:
            raise ValueError(f"conv model needs square images, got {num_dim}")
        model = ConvVAE(
            latent_dim=latent_dim, num_dim=num_dim, vy_init=vy_init,
            p=dropout, p_input=dropout_input, image_hw=hw, dtype=dtype,
        )
    elif type_nnet == "simple":
        model = SimpleVAE(latent_dim=latent_dim, num_dim=num_dim, vy_init=vy_init, dtype=dtype)
    elif type_nnet == "rnn":
        from lvae_torch.models.rnn import RNNVAE

        if not T or T <= 0:
            raise ValueError("type_nnet='rnn' requires T")
        model = RNNVAE(latent_dim=latent_dim, num_dim=num_dim, T=T, hidden_dim=hidden_dim,
                       type_rnn=type_rnn, vy_init=vy_init, dtype=dtype)
    else:
        raise ValueError(
            f"Unknown type_nnet {type_nnet!r} (expected 'conv', 'simple' or 'rnn')"
        )
    if generator is not None:
        init_weights(model, generator)
    return model

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

Compute dtype: a model's ``compute_dtype`` (a plain attribute, which
``nn.Module.to`` leaves alone) is the type its layers compute in; None
means the parameters' own. Under ``torch.bfloat16`` every convolution and
dense layer casts its input, weight and bias to bf16 at the call, as
flax's layers with ``dtype=bfloat16`` do (:func:`layer`), so ReLU, pooling,
dropout and the sigmoid run on bf16 values and ``mu``, ``log_var`` and the
reconstruction come back in bf16, while the parameters (``raw_log_vy``
with them) and the optimizer's moments stay f32. The casts are part of
the autograd graph and, in a captured step, of the graph: a replay after
an optimizer step reads the new weights. :func:`vae_loss` upcasts to the
target's dtype, and the callers upcast the moments before the GP algebra,
which never sees bf16. :func:`auto_model_dtype` resolves the pipeline's
``model_dtype=''``.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from lvae_torch.ops.linalg import full_precision

MIN_LOG_VY = -8.0


def bf16_switch_from_env(name: str) -> Optional[bool]:
    """``$name`` → a bf16 switch: ``1/true/on`` True, ``0/false/off``
    False, unset or empty None (the rule decides); anything else raises
    ``ValueError``, as the JAX package parses ``LVAE_MODEL_BF16`` and
    ``LVAE_TABLE_BF16``."""
    raw = os.environ.get(name, "")
    v = raw.strip().lower()
    if v in ("1", "true", "on"):
        return True
    if v in ("0", "false", "off"):
        return False
    if v:
        raise ValueError(f"{name}={raw!r}: expected 0/1")
    return None


# bf16 VAE compute for the pipeline's model_dtype='': None lets
# auto_model_dtype decide, True/False force it. $LVAE_MODEL_BF16 sets it.
use_bf16_model: Optional[bool] = bf16_switch_from_env("LVAE_MODEL_BF16")


def auto_model_dtype(base_dtype: torch.dtype = torch.float32) -> torch.dtype:
    """The VAE compute dtype when the config names none: bf16 when
    :data:`use_bf16_model` forces it and the base dtype is f32, else the
    base dtype. The JAX package's rule also picks bf16 for a cohort of at
    least 10,000 frames on a TPU backend; that clause never holds on a GPU,
    and no rule of the card's own has been measured, so without the switch
    the answer is the base dtype, as the JAX package's off a TPU."""
    if use_bf16_model and base_dtype == torch.float32:
        return torch.bfloat16
    return base_dtype


def layer(mod: nn.Module, h: torch.Tensor, dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``mod(h)`` for an ``nn.Linear``, ``nn.Conv2d`` or
    ``nn.ConvTranspose2d`` computed in ``dtype``: the input, weight and bias
    cast at the call (the parameters keep their type; the gradients reach
    them through the casts). ``dtype`` None runs the module as it is."""
    if dtype is None:
        return mod(h)
    h, w, b = h.to(dtype), mod.weight.to(dtype), mod.bias.to(dtype)
    if isinstance(mod, nn.Linear):
        return F.linear(h, w, b)
    if isinstance(mod, nn.ConvTranspose2d):
        return F.conv_transpose2d(h, w, b, mod.stride, mod.padding, mod.output_padding,
                                  mod.groups, mod.dilation)
    return mod._conv_forward(h, w, b)


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
        compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if image_hw % 4:
            raise ValueError(f"image_hw must be divisible by 4, got {image_hw}")
        self.latent_dim = latent_dim
        self.num_dim = num_dim
        self.p_input = p_input  # stored for config parity; unused, as in the reference
        self.image_hw = image_hw
        self.compute_dtype = compute_dtype
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
        cd = self.compute_dtype
        with full_precision():
            h = x.permute(0, 3, 1, 2)
            h = self.drop2d(F.max_pool2d(F.relu(layer(self.conv1, h, cd)), 2))
            h = self.drop2d(F.max_pool2d(F.relu(layer(self.conv2, h, cd)), 2))
            h = h.reshape(h.shape[0], -1)  # C-H-W order
            h = self.drop(F.relu(layer(self.fc1, h, cd)))
            h = self.drop(F.relu(layer(self.fc21, h, cd)))
            return layer(self.fc211, h, cd), layer(self.fc221, h, cd)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """latents ``[N, L]`` → images ``[N, H, W, 1]``."""
        cd = self.compute_dtype
        with full_precision():
            h = self.drop(F.relu(layer(self.fc3, z, cd)))
            h = self.drop(F.relu(layer(self.fc31, h, cd)))
            h = F.relu(layer(self.fc4, h, cd))
            h = self.drop2d(h.reshape(h.shape[0], 32, self.feat_hw, self.feat_hw))
            h = self.drop2d(F.relu(layer(self.deconv1, h, cd)))
            return torch.sigmoid(layer(self.deconv2, h, cd)).permute(0, 2, 3, 1)

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
        dtype: torch.dtype = torch.float32, compute_dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.latent_dim = latent_dim
        self.num_dim = num_dim
        self.compute_dtype = compute_dtype
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
        cd = self.compute_dtype
        with full_precision():
            h = F.relu(layer(self.fc1, x.reshape(x.shape[0], -1), cd))
            h = F.relu(layer(self.fc21, h, cd))
            return layer(self.fc211, h, cd), layer(self.fc221, h, cd)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return mlp_decode(self, z)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        mu, log_var = self.encode(x)
        z = mu if generator is None else sample_latent(mu, log_var, generator)
        return self.decode(z), mu, log_var


def mlp_decode(model: nn.Module, z: torch.Tensor) -> torch.Tensor:
    """The MLP decoder latent → 30 → 300 → num_dim with a sigmoid
    (``fc3``, ``fc31``, ``fc4`` of ``model``) in its compute dtype."""
    cd = model.compute_dtype
    with full_precision():
        h = F.relu(layer(model.fc31, F.relu(layer(model.fc3, z, cd)), cd))
        return torch.sigmoid(layer(model.fc4, h, cd))


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
    compute_dtype: Optional[torch.dtype] = None,
) -> nn.Module:
    """Model selection as the reference's flags name it; with ``generator``
    the weights are drawn from it (see :func:`init_weights`). ``dtype`` is
    the parameters' type whatever torch's default dtype is, and
    ``compute_dtype`` the layers' (None: the parameters'). ``T``,
    ``hidden_dim`` and ``type_rnn`` shape the RNN encoder, which needs
    ``T``."""
    if type_nnet == "conv":
        hw = int(round(num_dim ** 0.5))
        if hw * hw != num_dim:
            raise ValueError(f"conv model needs square images, got {num_dim}")
        model = ConvVAE(
            latent_dim=latent_dim, num_dim=num_dim, vy_init=vy_init,
            p=dropout, p_input=dropout_input, image_hw=hw, dtype=dtype,
            compute_dtype=compute_dtype,
        )
    elif type_nnet == "simple":
        model = SimpleVAE(latent_dim=latent_dim, num_dim=num_dim, vy_init=vy_init, dtype=dtype,
                          compute_dtype=compute_dtype)
    elif type_nnet == "rnn":
        from lvae_torch.models.rnn import RNNVAE

        if not T or T <= 0:
            raise ValueError("type_nnet='rnn' requires T")
        model = RNNVAE(latent_dim=latent_dim, num_dim=num_dim, T=T, hidden_dim=hidden_dim,
                       type_rnn=type_rnn, vy_init=vy_init, dtype=dtype,
                       compute_dtype=compute_dtype)
    else:
        raise ValueError(
            f"Unknown type_nnet {type_nnet!r} (expected 'conv', 'simple' or 'rnn')"
        )
    if generator is not None:
        init_weights(model, generator)
    return model

"""Training steps of the reference, and the numbers that compare a run with
it.

A training step: the VAE's loss on a batch of subjects plus the weighted GP
KL, its gradient by autograd, one Adam step (β = (0.9, 0.999), ε = 1e-8
outside the square root, bias-corrected) on the network and the GP
hyperparameters, and in the Hensman regime one natural-gradient step on
(m, H) from the same forward pass.

The draws of each step are worked out again from the seed: the program's
documented convention is one CPU ``torch.Generator`` seeded with the seed,
from which each Hensman epoch takes a permutation of the subjects and then
one standard-normal ``[S·T, L]`` draw a batch, and each full-batch epoch one
``[N, L]`` draw.
"""

from __future__ import annotations

import contextlib
import statistics
from typing import Dict, List, NamedTuple

import torch

from perfbench.reference import gp as rg
from perfbench.reference import model as rm

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8
# a leaf whose reference gradient norm is under this share of the median
# leaf's moves by rounding alone under Adam and is left out of the change
NOUGHT_GRADIENT = 1e-3


@contextlib.contextmanager
def precision(tf32: bool):
    """f32 matmuls and convolutions with TF32 off, or (the control) on."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


class Trace(NamedTuple):
    """Three steps of a run: each step's loss and its reconstruction term,
    each leaf's gradient at the first step, each leaf's change over the
    three steps."""

    losses: List[float]
    recons: List[float]
    first_grad: Dict[str, torch.Tensor]
    change: Dict[str, torch.Tensor]


def hensman_draws(seed: int, p: int, s: int, t: int, n_lat: int, steps: int, dtype,
                  skip_epochs: int = 0):
    """The first ``steps`` batches of the epoch after ``skip_epochs`` whole
    epochs (a permutation and one draw for each of ``ceil(p / s)`` batches
    each): (subject rows, noise)."""
    gen = torch.Generator().manual_seed(seed)
    for _ in range(skip_epochs):
        torch.randperm(p, generator=gen)
        for _ in range(-(-p // s)):
            torch.empty((s * t, n_lat), dtype=dtype).normal_(generator=gen)
    perm = torch.randperm(p, generator=gen)
    out = []
    for i in range(steps):
        eps = torch.empty((s * t, n_lat), dtype=dtype).normal_(generator=gen)
        out.append((perm[i * s:(i + 1) * s], eps))
    return out


def closed_draws(seed: int, n: int, n_lat: int, steps: int, dtype, skip_epochs: int = 0):
    """The noise of the ``steps`` full-batch steps after ``skip_epochs``."""
    gen = torch.Generator().manual_seed(seed)
    draws = [torch.empty((n, n_lat), dtype=dtype).normal_(generator=gen)
             for _ in range(skip_epochs + steps)]
    return draws[skip_epochs:]


def _adam(params: dict, grads: dict, state: dict, step: int, lr: float) -> None:
    b1, b2 = ADAM_BETAS
    with torch.no_grad():
        for k, p in params.items():
            g = grads[k]
            m, v = state.setdefault(k, (torch.zeros_like(p), torch.zeros_like(p)))
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            state[k] = (m, v)
            p -= lr * (m / (1 - b1 ** step)) / (torch.sqrt(v / (1 - b2 ** step)) + ADAM_EPS)


def _leaves(init: dict, device, dtype) -> dict:
    return {k: v.detach().to(device, dtype).clone().requires_grad_(True) for k, v in init.items()}


def _noise(cfg: dict, params: dict):
    raw = params["gp.raw_noise"]
    return torch.ones_like(raw) if cfg["constrain_scales"] else rg.positive(raw)


def _parts(params: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in params.items() if k.startswith(prefix)}


def hensman_steps(cfg: dict, data: dict, init: dict, seed: int, steps: int = 3,
                  tf32: bool = False, half_batch: bool = False, device="cpu",
                  dtype=torch.float32, skip_epochs: int = 0) -> Trace:
    """``steps`` Hensman steps from ``init`` (``vae.*``, ``gp.*`` leaves and
    ``m``, ``H``) on the cohort ``data`` (frames, labels, pixmask, z; subject
    blocks of ``cfg["T"]`` consecutive rows), on the draws of the epoch
    after ``skip_epochs``. ``half_batch`` is a planted fault: half of each
    batch's subjects are left out and the loss is the mean over the rest."""
    comps0, comps1 = rg.split_components(cfg)
    p, t, s, n_lat = cfg["P"], cfg["T"], cfg["subjects_per_batch"], cfg["latent_dim"]
    frames, labels, pixmask, z = (torch.as_tensor(data[k]).to(device, dtype)
                                  for k in ("frames", "labels", "pixmask", "z"))
    params = _leaves({k: v for k, v in init.items() if k not in ("m", "H")}, device, dtype)
    m = init["m"].to(device, dtype).clone()
    h = init["H"].to(device, dtype).clone()
    adam: dict = {}
    losses, recons, first_grad = [], [], {}
    with precision(tf32):
        draws = hensman_draws(seed, p, s, t, n_lat, steps, dtype, skip_epochs)
        for i, (rows, eps) in enumerate(draws):
            eps = eps.to(device)
            if half_batch:
                rows, eps = rows[: s // 2], eps[: (s // 2) * t]
            flat = (rows.to(device)[:, None] * t + torch.arange(t, device=device)).reshape(-1)
            w = _parts(params, "vae.")
            x = frames[flat]
            mu, lv = rm.encode(w, x)
            mse, _ = rm.recon_losses(w["raw_log_vy"], rm.decode(w, mu + eps * torch.exp(0.5 * lv)),
                                     x, pixmask[flat])
            sb = rows.shape[0]
            kl, ng_parts = rg.hensman_kl(
                comps0, comps1, _parts(params, "gp."), _noise(cfg, params),
                m, h, labels[flat].reshape(sb, t, -1), z, mu.reshape(sb, t, n_lat),
                lv.reshape(sb, t, n_lat), p, p * t, cfg["eps"])
            recon = mse.sum() * (p / sb)
            net = recon + cfg["weight"] * kl / n_lat
            grads = dict(zip(params, torch.autograd.grad(net, list(params.values()),
                                                         allow_unused=True)))
            grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in grads.items()}
            if i == 0:
                first_grad = {k: g.detach() for k, g in grads.items()}
            losses.append(float(net.detach()))
            recons.append(float(recon.detach()))
            _adam(params, grads, adam, i + 1, cfg["learning_rate"])
            m, h = rg.natural_gradient_step(m, h, ng_parts, cfg["natural_gradient_lr"])
    change = {k: (params[k].detach() - init[k].to(device, dtype)) for k in params}
    change["m"] = m - init["m"].to(device, dtype)
    change["H"] = h - init["H"].to(device, dtype)
    return Trace(losses, recons, first_grad, change)


def closed_steps(cfg: dict, data: dict, init: dict, seed: int, steps: int = 3,
                 tf32: bool = False, half_batch: bool = False, device="cpu",
                 dtype=torch.float32, skip_epochs: int = 0) -> Trace:
    """``steps`` full-batch steps of the closed-KL regime from ``init``
    (``vae.*``, ``gp.*``) on the whole cohort ``data``, on the draws after
    ``skip_epochs``; ``half_batch`` is the planted fault of
    :func:`hensman_steps`, over subjects."""
    comps0, comps1 = rg.split_components(cfg)
    p, t, n_lat = cfg["P"], cfg["T"], cfg["latent_dim"]
    n = p * t
    frames, labels, pixmask = (torch.as_tensor(data[k]).to(device, dtype)
                               for k in ("frames", "labels", "pixmask"))
    keep = n // 2 if half_batch else n
    params = _leaves(init, device, dtype)
    adam: dict = {}
    losses, recons, first_grad = [], [], {}
    with precision(tf32):
        for i, eps in enumerate(closed_draws(seed, n, n_lat, steps, dtype, skip_epochs)):
            eps = eps.to(device)[:keep]
            w = _parts(params, "vae.")
            x = frames[:keep]
            mu, lv = rm.encode(w, x)
            mse, _ = rm.recon_losses(w["raw_log_vy"], rm.decode(w, mu + eps * torch.exp(0.5 * lv)),
                                     x, pixmask[:keep])
            kl = rg.closed_kl(comps0 + comps1, _parts(params, "gp."), _noise(cfg, params),
                              labels[:keep], mu, lv)
            recon = mse.sum() * (n / keep)
            net = recon + cfg["weight"] * kl / n_lat * (n / keep)
            grads = dict(zip(params, torch.autograd.grad(net, list(params.values()),
                                                         allow_unused=True)))
            grads = {k: torch.zeros_like(params[k]) if g is None else g for k, g in grads.items()}
            if i == 0:
                first_grad = {k: g.detach() for k, g in grads.items()}
            losses.append(float(net.detach()))
            recons.append(float(recon.detach()))
            _adam(params, grads, adam, i + 1, cfg["learning_rate"])
            del grads, kl, net
    change = {k: (params[k].detach() - init[k].to(device, dtype)) for k in params}
    return Trace(losses, recons, first_grad, change)


def train_gaps(run: Trace, ref: Trace) -> Dict[str, float]:
    """The numbers that judge a training run against the reference:

    * ``loss``: the largest relative gap of a step's loss;
    * ``recon``: the relative gap of the first step's reconstruction term,
      which the network alone computes from the starting weights: the
      KL's float32 rounding, magnified by the inducing covariance's
      condition number (about 1e5 under the jitter floor), reaches the
      later steps' terms through Adam's first, sign-like step, but not
      this one;
    * ``grad``: the worst leaf's gap between the norms of its first
      gradient, over the larger of the reference leaf's norm and the
      median leaf's;
    * ``change``: the same of each leaf's change over the steps, leaving out
      the leaves whose reference gradient is nought to rounding (under
      :data:`NOUGHT_GRADIENT` of the median leaf's)."""
    def rel(got, want) -> float:
        return max(abs(a - b) / abs(b) for a, b in zip(got, want))

    def worst(got: dict, want: dict, keys) -> float:
        norms = {k: float(want[k].double().norm()) for k in keys}
        med = statistics.median(norms.values())
        return max(abs(float(got[k].double().norm()) - norms[k]) / max(norms[k], med)
                   for k in keys)

    g_norms = {k: float(g.double().norm()) for k, g in ref.first_grad.items()}
    g_med = statistics.median(g_norms.values())
    moving = [k for k in ref.change
              if k not in g_norms or g_norms[k] >= NOUGHT_GRADIENT * g_med]
    return {"loss": rel(run.losses, ref.losses), "recon": rel(run.recons[:1], ref.recons[:1]),
            "grad": worst(run.first_grad, ref.first_grad, list(ref.first_grad)),
            "change": worst(run.change, ref.change, moving)}

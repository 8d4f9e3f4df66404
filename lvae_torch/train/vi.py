"""Amortisation-free variational inference (port of lvae_tpu.train.vi).

Phase 1 optimises free per-row variational parameters (mu, log_var) of the
training cohort, the decoder with its observation noise and the GP
hyperparameters under one Adam, against the decoder's reconstruction loss
plus the DUBO (the sparse GP bound on the variational moments) over the
whole cohort every step. Phase 2 freezes all of that and optimises an
unseen cohort's (mu_pred, log_var_pred) against the joint DUBO of
``[prediction rows; trained rows]``: latent-space inference for new
sequences without the encoder.

Rows are kept in subject-major order (``blocks.index``), so the cohort's
moments reshape to ``[P, T, L]`` blocks; phase 1 needs a fixed-T cohort.
On the card each phase-1 step runs kernel K1 on the cohort's B chain and K2
on K0zz; phase 2 builds its GP operators once.

Both phases run the epoch program of ``train/loop.py`` (the JAX package's
``epochs_fn`` and ``pred_steps``), one step an epoch, its noise drawn from a
CPU ``torch.Generator`` (or injected); phase 2 as a program of its own
(:class:`_Prediction`) with its own graph. On a mesh
(``parallel/mesh.ShardedVITrainer`` sets ``view``) a phase-1 step decodes
the rank's subjects and bounds the rank's latents, and the gradients are
summed over the ranks before Adam.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import nn

from lvae_torch.data.blocks import SubjectBlocks, build_subject_blocks
from lvae_torch.evaluation.encode import encode_dataset
from lvae_torch.models import vae as mv
from lvae_torch.ops import elbo as eb
from lvae_torch.ops import kernels as kx
from lvae_torch.train import state as st
from lvae_torch.train.graph import StepGraphs
from lvae_torch.train.loop import EpochProgram, Fill
from lvae_torch.utils.device import resolve_device


class VIConfig(NamedTuple):
    spec0: kx.KernelSpec
    spec1: kx.KernelSpec
    latent_dim: int
    weight: float
    loss_function: str  # 'mse' | 'nll'
    constrain_scales: bool
    eps: float


class VIState(NamedTuple):
    mu: torch.Tensor  # [N, L] free variational means, subject-major rows
    log_var: torch.Tensor  # [N, L]
    vae: nn.Module  # the decoder is trained with them
    gp: st.GPParams
    opt_state: torch.optim.Optimizer  # Adam over (mu, log_var, vae, gp)
    rng: torch.Generator  # on the CPU


class _Phase1(NamedTuple):
    net: torch.Tensor
    recon: torch.Tensor
    nll: torch.Tensor
    gp: torch.Tensor

    def stacked(self) -> torch.Tensor:
        return torch.stack(list(self)).detach()


def _noise(gp: st.GPParams, cfg: VIConfig) -> torch.Tensor:
    if cfg.constrain_scales:
        return torch.ones_like(gp.raw_noise)
    return kx.constrain(gp.raw_noise)


class _Prediction(EpochProgram):
    """Phase 2's steps as an epoch program: ``step(e)``, one Adam step an
    epoch on the unseen cohort's moments for the noise ``e [N_pred, L]``,
    drawn by ``draw``; its metrics go to ``history``."""

    _out_shape = (3,)
    LOG = ("Iter {epoch}/{epochs} - Total Loss: {m[net]:.3f}  - GP Loss: {m[gp]:.3f}"
           "  - Recon Loss: {m[recon]:.3f}")

    def __init__(self, trainer: "VITrainer", step: Callable, shape: tuple, draw: Fill,
                 history: List[dict]):
        self.device, self.dtype, self.view = trainer.device, trainer.dtype, trainer.view
        self._step, self._draw, self.history = step, draw, history
        self._specs = [(tuple(shape), trainer.dtype)]
        self._graphs = StepGraphs()

    def _epoch_specs(self) -> List[Tuple[tuple, torch.dtype]]:
        return self._specs

    def _advance(self) -> None:
        pass  # no step count

    def _reduce(self, host: torch.Tensor, n: int) -> List[dict]:
        return [dict(zip(("net", "recon", "gp"), row)) for row in host.tolist()]


class VITrainer(EpochProgram):
    """The two-phase VI trainer on one device.

    ``model`` is a port VAE carrying its weights (pre-trained or fresh);
    ``dataset`` any object with numpy ``data``, ``labels`` and ``mask``;
    ``blocks`` its ``SubjectBlocks`` (every subject T rows); ``z [M, Q]``
    the inducing points; ``gp_params`` the initial GP hyperparameters. The
    initial (mu, log_var) are the model's encodings of the cohort. The
    optimizer is ``torch.optim.Adam`` with optax's defaults, as the JAX
    package uses ``optax.adam`` here. ``device`` is ``"cuda"`` unless the
    caller asks for the CPU.
    """

    LOG = ("Iter {epoch}/{epochs} - Loss: {m[net]:.3f}  - GP loss: {m[gp]:.3f}"
           "  - NLL Loss: {m[nll]:.3f}  - Recon Loss: {m[recon]:.3f}")

    def __init__(
        self,
        model: nn.Module,
        cfg: VIConfig,
        dataset,
        blocks: SubjectBlocks,
        z: np.ndarray,
        gp_params: st.GPParams,
        learning_rate: float = 1e-3,
        seed: int = 0,
        dtype=torch.float32,
        device="cuda",
    ):
        if not np.asarray(blocks.mask).all():
            raise ValueError("the VI regime expects a fixed-T cohort (every subject T rows)")
        self.device = resolve_device(device)
        self.model = model.to(device=self.device, dtype=dtype)
        self.cfg = cfg
        self.dtype = dtype
        self.labels = np.asarray(dataset.labels)
        self.blocks = blocks
        self.order = np.asarray(blocks.index).reshape(-1)

        def dev(a) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        self.z_ind = dev(z)
        self.data_ordered = dev(np.asarray(dataset.data)[self.order])
        self.pixmask_ordered = dev(np.asarray(dataset.mask)[self.order])
        self.xb = dev(self.labels[self.order]).reshape(blocks.num_subjects, blocks.t_max, -1)
        self.block_mask = dev(blocks.mask)

        mu0, lv0 = encode_dataset(self.model, dataset.data, device=self.device)
        mu = dev(mu0[self.order]).requires_grad_(True)
        log_var = dev(lv0[self.order]).requires_grad_(True)
        leaves = [x.detach().to(device=self.device, dtype=dtype, copy=True)
                  for x in gp_params.tensors()]
        gp = st.GPParams(kx.KernelParams(*leaves[0:2]), kx.KernelParams(*leaves[2:4]), leaves[4])
        params = [mu, log_var, *self.model.parameters(), *gp.tensors()]
        for p in params:
            p.requires_grad_(True)
        self.state = VIState(
            mu=mu, log_var=log_var, vae=self.model, gp=gp,
            opt_state=st.make_optimizer(params, learning_rate, kind="adam"),
            rng=torch.Generator().manual_seed(seed),
        )
        self.history: List[dict] = []
        self.pred_history: List[dict] = []

    # ------------------------------------------------------------- phase 1
    def loss(self, state: VIState, eps: torch.Tensor):
        """Phase 1's net loss and its terms ``(net, recon, nll, gp)`` for the
        reparameterisation noise ``eps [N, L]``, differentiable in the
        state's tensors. The decoder runs without dropout. On a rank's shard
        (``self.view``) they are the rank's shares."""
        cfg, view = self.cfg, self.view
        p, t = self.block_mask.shape
        rows, frames, lat = view.rows, view.frames(t), view.lat
        mu, log_var = state.mu[frames], state.log_var[frames]
        state.vae.eval()
        if view.weight("data"):
            zs = mu + eps[frames].to(mu.device, mu.dtype) * torch.exp(0.5 * log_var)
            recon = state.vae.decode(zs)
            mse_i, nll_i = mv.vae_loss(state.vae.raw_log_vy, recon, self.data_ordered[frames],
                                       self.pixmask_ordered[frames])
            recon_loss, nll_loss = torch.sum(mse_i), torch.sum(nll_i)
        else:  # another latent rank of these subjects counts their reconstruction
            recon_loss = nll_loss = mu.new_zeros(())
        gp = state.gp.latents(lat)
        p_rank = mu.shape[0] // t
        ops = eb.gp_block_operators(cfg.spec0, cfg.spec1, gp.kp0, gp.kp1, _noise(gp, cfg),
                                    self.xb[rows], self.z_ind, self.block_mask[rows], cfg.eps,
                                    view=view)
        gp_loss = view.weight("latent") * torch.sum(eb.dubo(
            ops, mu.reshape(p_rank, t, cfg.latent_dim)[..., lat],
            log_var.reshape(p_rank, t, cfg.latent_dim)[..., lat], view)) / cfg.latent_dim
        if cfg.loss_function == "mse":
            net = recon_loss + cfg.weight * gp_loss
        else:
            net = nll_loss + gp_loss
        return net, recon_loss, nll_loss, gp_loss

    def _step(self, eps: torch.Tensor) -> torch.Tensor:
        """The step function on device buffers: one Adam step of phase 1
        for the noise ``eps [N, L]``, in place; returns the device metrics
        ``[net, recon, nll, gp]`` (on a mesh, summed over the ranks). Safe
        to capture (``train/graph.py``): the zero gradients of unreached
        tensors are made inside it."""
        state = self._state
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        net, recon, nll, gp = self.loss(state, eps)
        net.backward()
        self.view.sum_grads(st.zero_missing_grads(
            p for group in opt.param_groups for p in group["params"]))
        opt.step()
        return self.view.world_metrics(_Phase1(net, recon, nll, gp)).stacked()

    def train_step(self, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One eager Adam step of phase 1; ``eps [N, L]`` is drawn from the
        state's generator when not given. Returns the device metrics
        ``[net, recon, nll, gp]`` (on a mesh, summed over the ranks)."""
        if eps is None:
            eps = torch.randn(self._state.mu.shape, generator=self._state.rng, dtype=self.dtype)
        return self._step(eps.to(self.device, self.dtype))

    def _advance(self) -> None:
        pass  # the VI state counts no steps

    def _epoch_specs(self) -> List[Tuple[tuple, torch.dtype]]:
        return [(tuple(self._state.mu.shape), self.dtype)]

    def _reduce(self, host: torch.Tensor, n: int) -> List[dict]:
        return [dict(zip(("net", "recon", "nll", "gp"), row)) for row in host.tolist()]

    # ------------------------------------------------------------- phase 2
    def _joint_labels(self, prediction_dataset) -> np.ndarray:
        """``[prediction rows; trained rows in subject order]``, the joint
        cohort's row layout."""
        return np.concatenate(
            [np.asarray(prediction_dataset.labels), self.labels[self.order]], 0)

    def joint_cohort(self, prediction_dataset, mu_pred):
        """(labels, mu) of the jointly inferred cohort, row-aligned with
        :meth:`optimize_prediction_set`'s construction: the conditioning set
        of GP prediction and generation."""
        labels = self._joint_labels(prediction_dataset)
        mu = np.concatenate([np.asarray(mu_pred), self.state.mu.detach().cpu().numpy()], 0)
        return labels, mu

    def optimize_prediction_set(
        self, prediction_dataset, epochs: int = 1000, learning_rate: float = 1e-3,
        log_every: int = 100, seed: int = 1, chunk: int = 100,
        eps: Optional[torch.Tensor] = None,
    ):
        """Phase 2: ``epochs`` Adam steps on (mu_pred, log_var_pred) of the
        unseen cohort against the joint DUBO; returns them as numpy.
        ``eps [epochs, N_pred, L]`` replaces the noise drawn from a CPU
        generator seeded from ``seed``. The steps run in ``chunk``-step
        chunks, their metrics read one chunk late (``pred_steps``'
        schedule). The joint cohort may be ragged: its padded slots gather row 0
        and the mask gives them zero value and zero gradient."""
        cfg, dtype, dev = self.cfg, self.dtype, self.device
        vae = self._state.vae
        mu0, lv0 = encode_dataset(vae, prediction_dataset.data, device=dev)
        joint_labels = self._joint_labels(prediction_dataset)
        jblocks = build_subject_blocks(joint_labels, id_covariate=self._id_cov())
        p, t = jblocks.mask.shape
        index = np.asarray(jblocks.index).reshape(-1)
        jindex = torch.as_tensor(index, device=dev)
        xb = torch.as_tensor(joint_labels[index], dtype=dtype, device=dev).reshape(p, t, -1)
        block_mask = torch.as_tensor(jblocks.mask, dtype=dtype, device=dev)
        data_pred = torch.as_tensor(np.asarray(prediction_dataset.data), dtype=dtype, device=dev)
        pixmask_pred = torch.as_tensor(np.asarray(prediction_dataset.mask), dtype=dtype,
                                       device=dev)
        mu_pred = torch.as_tensor(mu0, dtype=dtype, device=dev).requires_grad_(True)
        lv_pred = torch.as_tensor(lv0, dtype=dtype, device=dev).requires_grad_(True)
        opt = st.make_optimizer([mu_pred, lv_pred], learning_rate, kind="adam")
        gp = self._state.gp
        mu_train, lv_train = self._state.mu.detach(), self._state.log_var.detach()
        raw_log_vy = vae.raw_log_vy.detach()
        vae.eval()
        # the operators depend only on frozen quantities: built once
        with torch.no_grad():
            ops = eb.gp_block_operators(cfg.spec0, cfg.spec1, gp.kp0, gp.kp1, _noise(gp, cfg),
                                        xb, self.z_ind, block_mask, cfg.eps)

        def step(e):
            """One Adam step on the noise ``e``, in place; safe to capture."""
            zs = mu_pred + e * torch.exp(0.5 * lv_pred)
            mse_i, nll_i = mv.vae_loss(raw_log_vy, vae.decode(zs), data_pred, pixmask_pred)
            recon_loss, nll_loss = torch.sum(mse_i), torch.sum(nll_i)
            mu_b = torch.cat([mu_pred, mu_train])[jindex].reshape(p, t, cfg.latent_dim)
            lv_b = torch.cat([lv_pred, lv_train])[jindex].reshape(p, t, cfg.latent_dim)
            gp_loss = torch.sum(eb.dubo(ops, mu_b, lv_b)) / cfg.latent_dim
            if cfg.loss_function == "mse":
                net = recon_loss + cfg.weight * gp_loss
            else:
                net = nll_loss + gp_loss
            # the gradients of the two optimised tensors only: the frozen
            # decoder's weights get none (nor a graph's buffers of phase 1)
            mu_pred.grad, lv_pred.grad = torch.autograd.grad(net, (mu_pred, lv_pred))
            opt.step()
            return torch.stack([net, recon_loss, gp_loss]).detach()

        gen = torch.Generator().manual_seed(seed)
        given = None if eps is None else iter(eps)

        def draw(e, inputs):
            if given is None:
                inputs[0].normal_(generator=gen)  # torch.randn's draw
            else:
                inputs[0].copy_(torch.as_tensor(next(given)))

        _Prediction(self, step, mu_pred.shape, draw, self.pred_history).fit(
            epochs, log_every, chunk=chunk)
        return mu_pred.detach().cpu().numpy(), lv_pred.detach().cpu().numpy()

    def _id_cov(self) -> int:
        # the id covariate is kernel1's first categorical column
        for comp in self.cfg.spec1.components:
            if comp.eq_cols:
                return comp.eq_cols[0]
        raise ValueError("kernel1 has no id covariate component")

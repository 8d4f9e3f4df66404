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
The reparameterisation noise of both phases is drawn from a CPU
``torch.Generator`` (or injected), so a run on the card and one on the CPU
consume the same numbers. On the card each phase-1 step runs kernel K1 on
the cohort's B chain and K2 on K0zz; phase 2 builds its GP operators once.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from lvae_torch.data.blocks import SubjectBlocks, build_subject_blocks
from lvae_torch.evaluation.encode import encode_dataset
from lvae_torch.models import vae as mv
from lvae_torch.ops import elbo as eb
from lvae_torch.ops import kernels as kx
from lvae_torch.train import state as st
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


def _noise(gp: st.GPParams, cfg: VIConfig) -> torch.Tensor:
    if cfg.constrain_scales:
        return torch.ones_like(gp.raw_noise)
    return kx.constrain(gp.raw_noise)


class VITrainer:
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
        state's tensors. The decoder runs without dropout."""
        cfg = self.cfg
        mu, log_var = state.mu, state.log_var
        state.vae.eval()
        zs = mu + eps.to(mu.device, mu.dtype) * torch.exp(0.5 * log_var)
        recon = state.vae.decode(zs)
        mse_i, nll_i = mv.vae_loss(state.vae.raw_log_vy, recon, self.data_ordered,
                                   self.pixmask_ordered)
        recon_loss, nll_loss = torch.sum(mse_i), torch.sum(nll_i)
        gp = state.gp
        p, t = self.block_mask.shape
        ops = eb.gp_block_operators(cfg.spec0, cfg.spec1, gp.kp0, gp.kp1, _noise(gp, cfg),
                                    self.xb, self.z_ind, self.block_mask, cfg.eps)
        gp_loss = torch.sum(eb.dubo(ops, mu.reshape(p, t, cfg.latent_dim),
                                    log_var.reshape(p, t, cfg.latent_dim))) / cfg.latent_dim
        if cfg.loss_function == "mse":
            net = recon_loss + cfg.weight * gp_loss
        else:
            net = nll_loss + gp_loss
        return net, recon_loss, nll_loss, gp_loss

    def train_step(self, eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One Adam step of phase 1; ``eps [N, L]`` is drawn from the state's
        generator when not given. Returns the device metrics
        ``[net, recon, nll, gp]``."""
        state = self.state
        if eps is None:
            eps = torch.randn(state.mu.shape, generator=state.rng, dtype=state.mu.dtype)
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        net, recon, nll, gp = self.loss(state, eps)
        net.backward()
        for group in opt.param_groups:
            for p in group["params"]:
                # a tensor the loss does not reach (raw_noise under
                # constrain_scales) gets a zero gradient, as in optax
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        opt.step()
        return torch.stack([net, recon, nll, gp]).detach()

    def fit(self, epochs: int, log_every: int = 100, chunk: int = 100) -> List[dict]:
        """``epochs`` steps of phase 1 (one step is an epoch: the whole
        cohort); metrics reach the host once a chunk."""
        done = 0
        while done < epochs:
            n = min(max(chunk, 1), epochs - done)
            ms = torch.stack([self.train_step() for _ in range(n)]).tolist()
            for i, (net, recon, nll, gp) in enumerate(ms):
                epoch = done + i + 1
                self.history.append(dict(net=net, recon=recon, nll=nll, gp=gp))
                if log_every and epoch % log_every == 0:
                    print("Iter %d/%d - Loss: %.3f  - GP loss: %.3f  - NLL Loss: %.3f"
                          "  - Recon Loss: %.3f" % (epoch, epochs, net, gp, nll, recon),
                          flush=True)
            done += n
        return self.history

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
        generator seeded from ``seed``. The joint cohort may be ragged: its
        padded slots gather row 0 and the mask gives them zero value and
        zero gradient."""
        cfg, dtype, dev = self.cfg, self.dtype, self.device
        vae = self.state.vae
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
        gp = self.state.gp
        mu_train, lv_train = self.state.mu.detach(), self.state.log_var.detach()
        raw_log_vy = vae.raw_log_vy.detach()
        vae.eval()
        # the operators depend only on frozen quantities: built once
        with torch.no_grad():
            ops = eb.gp_block_operators(cfg.spec0, cfg.spec1, gp.kp0, gp.kp1, _noise(gp, cfg),
                                        xb, self.z_ind, block_mask, cfg.eps)
        gen = torch.Generator().manual_seed(seed)

        def step(e):
            opt.zero_grad(set_to_none=True)
            zs = mu_pred + e.to(dev, dtype) * torch.exp(0.5 * lv_pred)
            mse_i, nll_i = mv.vae_loss(raw_log_vy, vae.decode(zs), data_pred, pixmask_pred)
            recon_loss, nll_loss = torch.sum(mse_i), torch.sum(nll_i)
            mu_b = torch.cat([mu_pred, mu_train])[jindex].reshape(p, t, cfg.latent_dim)
            lv_b = torch.cat([lv_pred, lv_train])[jindex].reshape(p, t, cfg.latent_dim)
            gp_loss = torch.sum(eb.dubo(ops, mu_b, lv_b)) / cfg.latent_dim
            if cfg.loss_function == "mse":
                net = recon_loss + cfg.weight * gp_loss
            else:
                net = nll_loss + gp_loss
            net.backward()
            opt.step()
            return torch.stack([net, recon_loss, gp_loss]).detach()

        done = 0
        while done < epochs:
            n = min(max(chunk, 1), epochs - done)
            ms = []
            for i in range(n):
                e = (torch.randn(mu_pred.shape, generator=gen, dtype=dtype) if eps is None
                     else torch.as_tensor(eps[done + i]))
                ms.append(step(e))
            for i, (net, recon, gp_l) in enumerate(torch.stack(ms).tolist()):
                epoch = done + i + 1
                self.pred_history.append(dict(net=net, recon=recon, gp=gp_l))
                if log_every and epoch % log_every == 0:
                    print("Iter %d/%d - Total Loss: %.3f  - GP Loss: %.3f  - Recon Loss: %.3f"
                          % (epoch, epochs, net, gp_l, recon), flush=True)
            done += n
        return mu_pred.detach().cpu().numpy(), lv_pred.detach().cpu().numpy()

    def _id_cov(self) -> int:
        # the id covariate is kernel1's first categorical column
        for comp in self.cfg.spec1.components:
            if comp.eq_cols:
                return comp.eq_cols[0]
        raise ValueError("kernel1 has no id covariate component")

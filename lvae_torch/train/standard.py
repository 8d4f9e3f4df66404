"""Standard (full-batch) training and the GPPVAE pseudo-minibatch regime
(port of lvae_tpu.train.standard).

One step is one epoch over the whole cohort: the VAE and its masked
reconstruction loss, one of three KL computations per latent dim, and one
optimizer step.

* ``closed`` — the exact N×N KL against the full additive prior
  (:func:`~lvae_torch.ops.elbo.kl_closed`); the split kernels are joined and
  ``K [L, N, N]`` is built by ``ops/kernels.kernel_matrix``, which is kernel
  K3 on the card for N ≥ 512.
* ``GPapprox`` — the inducing-point bound on latent samples (``gp_elbo``).
* ``GPapprox_closed`` — the deviance upper bound on the moments (``dubo``).

With ``pseudo_minibatch`` an epoch is instead the five-phase GPPVAE
gradient (:func:`gppvae_grads`): a no-grad encode of the cohort, the GP loss
on the cached encodings, its gradients w.r.t. them and the kernel
parameters, a per-subject encoder replay that splices those cotangents in,
and the optimizer step. With a deterministic encoder it equals the
full-batch gradient.

The trainer runs the epoch program (the JAX package's ``epochs_fn``): a
chunk's reparameterisation noise and GP-sample noise are drawn from a CPU
``torch.Generator`` seeded from ``seed``, on the host, in the steps' own
order, into one pinned slab copied to the device once (so a run on the card
and one on the CPU consume the same numbers); every epoch of the chunk
runs, and the chunk's metrics reach the host once, one chunk late unless
``fit`` has a callback or ``overlap`` is False. The step is one function on
fixed buffers that updates its tensors in place. On the card it is captured
once as a CUDA graph (``train/graph.CapturedStep``) and replayed every
epoch: the closed step with K3, its backward and the N×N factorisation
(K5 under the fused optimizer), the sparse and GPPVAE steps with K1 and K2,
the GPPVAE step whole, its per-subject replay loop included. Assigning
``trainer.state`` drops the graph. Both loss functions take the noise as
tensors.

On a mesh (``parallel/mesh.ShardedStandardTrainer`` sets ``view``) a rank
encodes its subjects' frames and computes the GP bound of its latents: the
sparse bounds sum their subject terms over the data axis first, and the
closed KL gathers the whole cohort's moments (kernel K3 then builds the
rank's ``[L', N, N]`` prior). The gradients are summed over the ranks
before the optimizer step; there, as on the CPU, every step runs eagerly
(the view's collectives cannot be captured).
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from lvae_torch.models import vae as mv
from lvae_torch.ops import elbo as eb
from lvae_torch.ops import kernels as kx
from lvae_torch.ops.shard import LOCAL, Local
from lvae_torch.train import state as st
from lvae_torch.train.graph import (
    StepGraphs, finish_host_copy, record_phases, route_key, run_chunks, run_staged,
    start_host_copy,
)
from lvae_torch.utils.device import resolve_device
from lvae_torch.utils.metrics import phase, phase_at_grads, phase_end, span

SPARSE_KL = ("GPapprox", "GPapprox_closed")


class StandardConfig(NamedTuple):
    spec0: kx.KernelSpec
    spec1: Optional[kx.KernelSpec]
    latent_dim: int
    P_tot: int
    T: int
    weight: float
    loss_function: str  # 'mse' | 'nll'
    type_KL: str  # 'closed' | 'GPapprox' | 'GPapprox_closed'
    num_samples: int
    constrain_scales: bool
    eps: float
    dropout: bool
    vy_fixed: bool = False


class StandardState(NamedTuple):
    trainables: st.Trainables  # m and h_factor unused (None)
    opt_state: torch.optim.Optimizer
    rng: torch.Generator  # on the CPU: the card and the CPU draw alike
    step: int


class StandardMetrics(NamedTuple):
    net: torch.Tensor
    recon: torch.Tensor
    nll: torch.Tensor
    gp: torch.Tensor


def _noises(cfg: StandardConfig, like: torch.Tensor, eps, gp_eps):
    """(encoder noise ``[P·T, L]`` in ``like``'s dtype and device, GP
    samples ``[num_samples, P, T, L]`` or None): the noise is given, never
    drawn here."""
    if eps is None or (cfg.type_KL == "GPapprox" and gp_eps is None):
        raise ValueError("the noise must be given: eps, and gp_eps under GPapprox")
    return eps.to(like.device, like.dtype), gp_eps


def _sparse_gp_loss(cfg: StandardConfig, kp0: kx.KernelParams, kp1: kx.KernelParams,
                    noise: torch.Tensor, labels: torch.Tensor, z: torch.Tensor,
                    block_mask: torch.Tensor, mu: torch.Tensor, log_var: torch.Tensor,
                    gp_eps: Optional[torch.Tensor], view: Local = LOCAL) -> torch.Tensor:
    """The GPapprox (mean over samples of −Σ gp_elbo) or GPapprox_closed
    (Σ dubo) loss of the moments ``[P·T, L]`` of the subjects ``labels``
    and ``block_mask`` hold (``gp_eps [num_samples, P, T, L]``)."""
    p, t = block_mask.shape
    latent = mu.shape[-1]
    xb = labels.reshape(p, t, -1)
    mu_b = mu.reshape(p, t, latent)
    lv_b = log_var.reshape(p, t, latent)
    ops = eb.gp_block_operators(cfg.spec0, cfg.spec1, kp0, kp1, noise, xb, z,
                                mask=block_mask, eps=cfg.eps, view=view)
    if cfg.type_KL == "GPapprox_closed":
        return torch.sum(eb.dubo(ops, mu_b, lv_b, view))
    std = torch.exp(0.5 * lv_b)
    samples = [-torch.sum(eb.gp_elbo(ops, mu_b + e * std, view))
               for e in gp_eps.to(mu.device, mu.dtype)]
    return torch.stack(samples).mean()


def _recon_losses(model, cfg: StandardConfig, x, pixmask, mu, log_var, eps):
    """Per-frame (mse, nll) of the reconstruction of a sample ``mu + eps·σ``,
    drawn in the dtype of the model's moments ``mu``/``log_var``."""
    recon = model.decode(mu + eps.to(mu.dtype) * torch.exp(0.5 * log_var))
    raw_log_vy = model.raw_log_vy.detach() if cfg.vy_fixed else model.raw_log_vy
    return mv.vae_loss(raw_log_vy, recon, x, pixmask)


def _report(cfg: StandardConfig, recon, nll, gp_loss):
    """(net, reported GP term): MSE weighs the GP loss per latent dim."""
    if cfg.loss_function == "mse":
        gp_rep = gp_loss / cfg.latent_dim
        return recon + cfg.weight * gp_rep, gp_rep
    return nll + gp_loss, gp_loss


def full_batch_loss(
    model,
    cfg: StandardConfig,
    trainables: st.Trainables,
    tdata: st.TrainData,
    block_mask: torch.Tensor,  # [P, T]
    eps: Optional[torch.Tensor] = None,
    gp_eps: Optional[torch.Tensor] = None,
    view: Local = LOCAL,
):
    """One full-batch loss, differentiable in the trainables; returns
    ``(net, StandardMetrics)``. ``eps [N, L]`` is the encoder's
    reparameterisation noise and ``gp_eps [num_samples, P, T, L]`` the
    GPapprox samples' noise (read only under GPapprox). On a rank's shard
    (``view``) every argument is whole, the rank computes with its subjects
    and latents, and the loss and metrics are the rank's shares."""
    p, t = block_mask.shape
    rows, frames, lat = view.rows, view.frames(t), view.lat
    model.train(cfg.dropout)
    mu_m, lv_m = model.encode(tdata.data[frames])
    # the GP algebra never sees a bf16 model's moments
    mu, log_var = mu_m.to(tdata.labels.dtype), lv_m.to(tdata.labels.dtype)
    eps, gp_eps = _noises(cfg, mu, eps, gp_eps)
    if view.weight("data"):
        mse_i, nll_i = _recon_losses(model, cfg, tdata.data[frames], tdata.pixmask[frames], mu_m,
                                     lv_m, eps[frames])
        # row validity keeps alignment padding out of the sums: the NLL adds
        # its Gaussian constant for every pixel whatever the pixel mask
        row_valid = block_mask[rows].reshape(-1).to(mse_i.dtype)
        recon_loss = torch.sum(mse_i * row_valid)
        nll_loss = torch.sum(nll_i * row_valid)
    else:  # another latent rank of these subjects counts their reconstruction
        recon_loss = nll_loss = mu.new_zeros(())

    phase("gp_forward")
    gp = trainables.gp.latents(lat)
    noise = torch.ones_like(gp.raw_noise) if cfg.constrain_scales else kx.constrain(gp.raw_noise)
    kp0, kp1 = gp.kp0, gp.kp1
    if cfg.type_KL == "closed":
        # the full additive prior, joined from the split kernels; ghost rows
        # (block_mask 0) get an identity row and column and zero moments, so
        # each adds exactly 0 to the KL. The N×N prior couples every
        # subject: a rank takes the whole cohort's moments of its latents
        spec_full, kp_full = kx.join_specs(cfg.spec0, cfg.spec1, kp0, kp1)
        def whole(x):  # [P'·T, L] of this rank's subjects → [P·T, L']
            return view.gather_rows(x.reshape(-1, t, x.shape[-1]), p).reshape(p * t, -1)[:, lat]

        mu_all, lv_all = whole(mu), whole(log_var)
        # the GP part's backward ends when each of its inputs has its gradient
        phase_at_grads([mu_all, lv_all, *kp0, *kp1, noise], "vae_backward")
        valid = block_mask.reshape(-1).to(mu.dtype)
        k_full = kx.kernel_matrix(spec_full, kp_full, tdata.labels, tdata.labels)
        k_full = k_full * (valid[:, None] * valid[None, :])
        diag_add = valid * noise[:, None] + (1.0 - valid)  # [L, N]
        k_prior = k_full + torch.diag_embed(diag_add)
        gp_loss = torch.sum(eb.kl_closed(k_prior, mu_all.t() * valid, lv_all.t() * valid))
    elif cfg.type_KL in SPARSE_KL:
        mu_lat, lv_lat = mu[:, lat], log_var[:, lat]
        phase_at_grads([mu_lat, lv_lat, *kp0, *kp1, noise], "vae_backward")
        gp_loss = _sparse_gp_loss(
            cfg, kp0, kp1, noise, tdata.labels[frames], tdata.z, block_mask[rows], mu_lat,
            lv_lat, None if gp_eps is None else gp_eps[:, rows, :, lat], view)
    else:
        raise ValueError(f"Unsupported type_KL {cfg.type_KL!r}")
    gp_loss = view.weight("latent") * gp_loss

    net, gp_rep = _report(cfg, recon_loss, nll_loss, gp_loss)
    return net, StandardMetrics(net=net.detach(), recon=recon_loss.detach(),
                                nll=nll_loss.detach(), gp=gp_rep.detach())


def gppvae_grads(
    model,
    cfg: StandardConfig,
    trainables: st.Trainables,
    tdata: st.TrainData,
    block_mask: torch.Tensor,
    eps: Optional[torch.Tensor] = None,
    gp_eps: Optional[torch.Tensor] = None,
) -> StandardMetrics:
    """The five-phase GPPVAE pseudo-minibatch gradient, added into the
    trainables' ``.grad`` as ``backward`` would; returns the metrics.

    1. encode the cohort without gradients;
    2. the GP loss on detached ``full_mu``/``full_lv`` leaves (the likelihood
       noise detached: it gets no gradient in this regime);
    3. its gradients w.r.t. those leaves and the kernel parameters;
    4. per subject (a batch of T frames), replay the encoder and take
       ``backward([primal, mu, log_var], [1, mu_ct, lv_ct])``, which adds the
       reconstruction gradient and the spliced GP cotangents;
    5. the optimizer step, which is the caller's.

    ``eps [N, L]`` is the replay's reparameterisation noise and ``gp_eps``
    the GPapprox samples' noise."""
    if cfg.type_KL not in SPARSE_KL:
        raise ValueError(f"mini_batch supports GPapprox(_closed), got {cfg.type_KL!r}")
    p, t = block_mask.shape
    latent = cfg.latent_dim
    model.train(cfg.dropout)

    # phase 1
    with torch.no_grad():
        full_mu, full_lv = (m.to(tdata.labels.dtype) for m in model.encode(tdata.data))
    eps, gp_eps = _noises(cfg, full_mu, eps, gp_eps)

    # phases 2 and 3
    gp = trainables.gp
    noise = (torch.ones_like(gp.raw_noise) if cfg.constrain_scales
             else kx.constrain(gp.raw_noise.detach()))
    mu_leaf = full_mu.detach().requires_grad_(True)
    lv_leaf = full_lv.detach().requires_grad_(True)
    gp_raw = _sparse_gp_loss(cfg, gp.kp0, gp.kp1, noise, tdata.labels, tdata.z, block_mask,
                             mu_leaf, lv_leaf, gp_eps)
    # MSE weighs the loss before differentiation, so the cotangents carry
    # weight / latent_dim
    scaled = cfg.weight * gp_raw / latent if cfg.loss_function == "mse" else gp_raw
    kp_leaves = [*gp.kp0, *gp.kp1]
    mu_ct, lv_ct, *kp_grads = torch.autograd.grad(
        scaled, [mu_leaf, lv_leaf, *kp_leaves], allow_unused=True)
    for leaf, grad in zip(kp_leaves, kp_grads):
        if grad is not None:
            leaf.grad = grad if leaf.grad is None else leaf.grad + grad

    # phase 4
    shape = (p, t)
    data_b = tdata.data.reshape(shape + tdata.data.shape[1:])
    pix_b = tdata.pixmask.reshape(shape + tdata.pixmask.shape[1:])
    eps_b = eps.reshape(p, t, latent)
    mu_ct_b = mu_ct.reshape(p, t, latent)
    lv_ct_b = lv_ct.reshape(p, t, latent)
    recon_sum = torch.zeros((), dtype=full_mu.dtype, device=full_mu.device)
    nll_sum = torch.zeros_like(recon_sum)
    for i in range(p):
        mu_i, lv_i = model.encode(data_b[i])
        mse_i, nll_i = _recon_losses(model, cfg, data_b[i], pix_b[i], mu_i, lv_i, eps_b[i])
        recon_l, nll_l = torch.sum(mse_i), torch.sum(nll_i)
        primal = recon_l if cfg.loss_function == "mse" else nll_l
        # the cotangents are in the GP dtype: so are the moments they splice into
        mu_i, lv_i = mu_i.to(mu_ct_b.dtype), lv_i.to(mu_ct_b.dtype)
        torch.autograd.backward([primal, mu_i, lv_i],
                                [torch.ones_like(primal), mu_ct_b[i], lv_ct_b[i]])
        recon_sum = recon_sum + recon_l.detach()
        nll_sum = nll_sum + nll_l.detach()

    net, gp_rep = _report(cfg, recon_sum, nll_sum, gp_raw.detach())
    return StandardMetrics(net=net, recon=recon_sum, nll=nll_sum, gp=gp_rep)


def _zero_missing_grads(trainables: st.Trainables) -> None:
    # a trainable the loss does not reach (raw_noise under constrain_scales
    # or in the GPPVAE regime) gets a zero gradient, as in optax: its Adam
    # moments and step count advance with the others
    for p in trainables.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


class StandardTrainer:
    """Epochs of full-batch (or, with ``pseudo_minibatch``, five-phase
    GPPVAE) training on one device.

    ``model`` is a port VAE carrying its initial weights; ``dataset`` any
    object with numpy ``data [N, ...]``, ``labels [N, Q]`` and
    ``mask [N, D]``; ``blocks`` its ``data/blocks.SubjectBlocks``, which must
    be fixed-T; ``z [M, Q]`` the inducing points (unused by ``closed``). The
    GP hyperparameters are initialised as the JAX package does and the
    generator seeded from ``seed``; the optimizer is ``make_optimizer``'s
    default (``$LVAE_OPT``, else Adam). ``device`` is ``"cuda"`` unless the
    caller asks for the CPU.
    """

    def __init__(
        self,
        model,
        cfg: StandardConfig,
        dataset,
        blocks,
        z: Optional[np.ndarray],
        learning_rate: float = 1e-3,
        seed: int = 0,
        dtype=torch.float32,
        pseudo_minibatch: bool = False,
        device="cuda",
    ):
        self.device = resolve_device(device)
        if cfg.spec1 is None:
            cfg = cfg._replace(spec1=kx.KernelSpec(components=()))
        if pseudo_minibatch and cfg.type_KL not in SPARSE_KL:
            raise ValueError(f"mini_batch supports GPapprox(_closed), got {cfg.type_KL!r}")
        if not blocks.mask.all():
            raise ValueError("standard regimes require fixed-T cohorts (varying_T needs "
                             "hensman)")
        self.cfg = cfg
        self.pseudo_minibatch = pseudo_minibatch
        self.model = model.to(device=self.device, dtype=dtype)
        self.dtype = dtype
        self.order = blocks.index.reshape(-1)  # subject-major

        def dev(a):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

        self.block_mask = dev(blocks.mask)
        labels = np.asarray(dataset.labels)
        self.tdata = st.TrainData(
            data=dev(np.asarray(dataset.data)[self.order]),
            labels=dev(labels[self.order]),
            pixmask=dev(np.asarray(dataset.mask)[self.order]),
            z=dev(z if z is not None else np.zeros((1, labels.shape[1]))),
        )
        gp = st.init_gp_params(cfg.spec0, cfg.spec1, cfg.latent_dim,
                               constrain_scales=cfg.constrain_scales, dtype=dtype,
                               device=self.device)
        trainables = st.Trainables(vae=self.model, gp=gp, m=None, h_factor=None)
        for p in trainables.parameters():
            p.requires_grad_(True)
        self.state = StandardState(
            trainables=trainables,
            opt_state=st.make_optimizer(trainables.parameters(), learning_rate),
            rng=torch.Generator().manual_seed(seed),
            step=0,
        )
        self.view: Local = LOCAL  # a rank's shard on a mesh (parallel/mesh.py)
        self.history: list = []

    # ---------------------------------------------------------------- state
    @property
    def state(self) -> StandardState:
        return self._state

    @state.setter
    def state(self, value: StandardState) -> None:
        """A new state drops the captured step: a graph reads and writes the
        tensors it was captured on, so the next chunk captures again."""
        self._state = value
        self._graphs = StepGraphs()

    # ------------------------------------------------------------- one step
    def _step(self, eps: torch.Tensor, gp_eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The step function on device buffers: one full-batch epoch (or the
        five GPPVAE phases) and one optimizer step for the encoder noise
        ``eps [N, L]`` and, under GPapprox, the samples' noise ``gp_eps
        [num_samples, P, T, L]``, in place; under ``constrain_scales`` the
        likelihood noise is pinned back to 1 after the full-batch step
        (the GPPVAE regime gives it no gradient and leaves it). Returns the
        device metrics ``[net, recon, nll, gp]`` (on a mesh, summed over the
        ranks). Safe to capture (``train/graph.py``): it draws nothing."""
        cfg, view, state = self.cfg, self.view, self._state
        trainables, opt = state.trainables, state.opt_state
        opt.zero_grad(set_to_none=True)
        if self.pseudo_minibatch:
            if view is not LOCAL:
                raise ValueError("the GPPVAE regime runs in one process")
            metrics = gppvae_grads(self.model, cfg, trainables, self.tdata, self.block_mask,
                                   eps=eps, gp_eps=gp_eps)
        else:
            phase("vae_forward")
            net, metrics = full_batch_loss(self.model, cfg, trainables, self.tdata,
                                           self.block_mask, eps=eps, gp_eps=gp_eps, view=view)
            phase("gp_backward")
            net.backward()
            phase("update")
        _zero_missing_grads(trainables)
        view.sum_grads(list(trainables.parameters()))
        opt.step()
        if cfg.constrain_scales and not self.pseudo_minibatch:
            with torch.no_grad():
                trainables.gp.raw_noise.fill_(float(kx.unconstrain(1.0)))
        out = torch.stack(list(view.world_metrics(metrics)))
        phase_end()
        return out

    def _run_step(self, noise: Sequence[torch.Tensor], out: torch.Tensor) -> None:
        """Step the noise ``noise`` (``eps``, and ``gp_eps`` under GPapprox)
        into the metrics row ``out [4]``: on the card the captured step
        (captured at the first step after a new state and at route or
        backend switches; the capture's warm-up is this step), on the CPU
        and on a mesh view (whose collectives cannot be captured) the eager
        one."""
        self._graphs.run(route_key(), self._step, noise, out,
                         eager=self.device.type != "cuda" or self.view is not LOCAL)
        self._state = self._state._replace(step=self._state.step + 1)

    # --------------------------------------------------------------- epochs
    def _noise_specs(self) -> List[Tuple[tuple, torch.dtype]]:
        """An epoch's noise, in the order a step draws it: the encoder's
        ``[N, L]``, then under GPapprox the samples' ``[num_samples, P, T, L]``."""
        p, t = self.block_mask.shape
        lat = self.cfg.latent_dim
        specs = [((p * t, lat), self.dtype)]
        if self.cfg.type_KL == "GPapprox":
            specs.append(((self.cfg.num_samples, p, t, lat), self.dtype))
        return specs

    def _dispatch(self, n: int, fill: Callable[[int, List[torch.Tensor]], None]):
        """Run ``n`` epochs without waiting for the device: ``fill(i,
        rows)`` writes epoch ``i``'s noise into its host rows
        (:meth:`_noise_specs`), staged and copied to the device at once
        (``graph.run_staged``). Returns the ``[n, 4]`` metrics' host copy
        in flight."""
        out = torch.empty((n, 4), dtype=self.dtype, device=self.device)
        run_staged(n, self._noise_specs(), fill, lambda i, noise: self._run_step(noise, out[i]),
                   self.device)
        return start_host_copy(out)

    def _dispatch_epochs(self, n: int):
        """An ``n``-epoch chunk, its noise drawn from the state's generator
        in the steps' order."""
        gen = self._state.rng

        def fill(i, rows):
            for row in rows:
                row.normal_(generator=gen)  # torch.randn's draw

        return self._dispatch(n, fill)

    def _materialize_metrics(self, chunk, n: int) -> List[StandardMetrics]:
        """Wait for a dispatched chunk's metrics; returns them as host floats
        (appended to ``history``). With tracing on the captured step's
        phase times are sampled after the wait."""
        with span("lvae.train.read"):
            out = [StandardMetrics(*row) for row in finish_host_copy(chunk).tolist()]
            record_phases(self._graphs)
            self.history.extend(out)
        return out

    def run_epochs(self, n: int) -> List[StandardMetrics]:
        """Run ``n`` epochs as one chunk; returns their metrics."""
        return self._materialize_metrics(self._dispatch_epochs(n), n)

    def run_epoch(self, eps: Optional[torch.Tensor] = None,
                  gp_eps: Optional[torch.Tensor] = None) -> StandardMetrics:
        """One epoch (one step), a chunk of one; returns its metrics as host
        floats. ``eps`` and ``gp_eps`` replace the drawn noise (the other,
        where one is not given, is drawn)."""
        gen = self._state.rng

        def fill(i, rows):
            for row, given in zip(rows, (eps, gp_eps)):
                if given is None:
                    row.normal_(generator=gen)  # torch.randn's draw
                else:
                    row.copy_(torch.as_tensor(given))

        return self._materialize_metrics(self._dispatch(1, fill), 1)[0]

    def _log_chunk(self, ms, done: int, epochs: int, log_every: int):
        for i, m in enumerate(ms):
            epoch = done + i + 1
            if log_every and epoch % log_every == 0:
                print(
                    "Iter %d/%d - Loss: %.3f  - GP loss: %.3f  - NLL Loss: %.3f"
                    "  - Recon Loss: %.3f"
                    % (epoch, epochs, m.net, m.gp, m.nll, m.recon),
                    flush=True,
                )

    def fit(self, epochs: int, log_every: int = 1, callback=None, chunk: int = 25,
            overlap: Optional[bool] = None):
        """Train ``epochs`` epochs in ``chunk``-epoch chunks, calling
        ``callback(trainer, done, last metrics)`` after every chunk. A
        callback that returns ``"rollback"`` has restored an earlier state:
        the chunk's epochs are then run again, so the run trains as many
        epochs as it reports. Without a callback (and unless ``overlap`` is
        False) chunk k+1 is dispatched before chunk k's metrics are read:
        the same values, printed in the same order."""
        lag = callback is None and overlap is not False

        def read(done: int, n: int, chunk_):
            ms = self._materialize_metrics(chunk_, n) if lag else chunk_
            with span("lvae.train.callback"):
                self._log_chunk(ms, done, epochs, log_every)
                return None if callback is None else callback(self, done + n, ms[-1])

        # without the lag each chunk runs through run_epochs and is read at once
        run_chunks(epochs, chunk, self._dispatch_epochs if lag else self.run_epochs, read, lag)
        return self.history

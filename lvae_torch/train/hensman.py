"""Hensman/SVI training with natural gradients (port of lvae_tpu.train.hensman).

One step: a subject batch through the VAE and its masked reconstruction
loss, the GP operators (kernel K1 builds the per-subject B chain on the
card), the minibatch KL bound, one Adam step on the trainables and one
natural-gradient step on (m, H).

The epoch program (the JAX package's ``make_epochs_fn``): ``run_epochs(n)``
draws a chunk's permutations and noise on the host, copies them to the
device once, runs every step of the chunk and reads the chunk's metrics
once (``_dispatch_epochs``, then ``_materialize_metrics``); ``fit`` without
a callback dispatches chunk k+1 before it reads chunk k. The step is one
function on fixed buffers that updates the state in place. On the card it
is captured once per batch shape ``[S, T_bucket]`` (and route switch) as a
CUDA graph (``train/graph.CapturedStep``) and replayed for every batch; on
the CPU, and on a mesh view, whose collectives cannot be captured, it runs
eagerly. Assigning ``trainer.state`` drops the graphs, so that the next
chunk captures again on the new state's tensors.

* Fixed-T and ragged cohorts share one path through padded blocks and
  validity masks; ghost subjects pad the final batch, contribute exactly
  zero, and the true subject count drives the ``P_tot / P_batch`` scaling.
* A model computing in bf16 (``models/vae.py``'s ``compute_dtype``) takes
  its sample in bf16, as the JAX model draws it; the moments are upcast to
  the GP dtype before the GP algebra and the loss target with them, and
  under ``use_bf16_table`` the frame table itself is stored in bf16.
* Randomness (the subject permutation of each epoch and bucket, and the
  reparameterisation noise of each step) is drawn from a CPU
  ``torch.Generator`` seeded from ``seed`` and moved to the device, so a run
  on the card and one on the CPU consume the same numbers.
* On a mesh (``parallel/mesh.ShardedHensmanTrainer`` sets ``view``) a rank
  takes its subjects of each batch (ghost rows pad the batch to the data
  axis) and its latents: it counts its share of each term, the gradients
  are summed over the ranks before Adam, the natural gradients' subject
  sums over the data axis, and (m, H) are updated per latent shard and
  reassembled. Every rank draws the whole batch order and noise from the
  same generator and slices out its own.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from lvae_torch.data import blocks as bk
from lvae_torch.models import vae as mv
from lvae_torch.ops import elbo as eb
from lvae_torch.ops import kernels as kx
from lvae_torch.ops.shard import LOCAL, Local
from lvae_torch.train import state as st
from lvae_torch.train.graph import (
    StepGraphs, epochs_per_slab, finish_host_copy, record_phases, route_key, run_chunks,
    start_host_copy,
)
from lvae_torch.utils.device import resolve_device
from lvae_torch.utils.metrics import phase, phase_at_grads, phase_end, span


# The bf16 frame table: under a bf16 model over an f32 GP dtype the frame
# and pixel-mask tables may be stored in bf16 (the model casts its input to
# bf16 anyway; a batch's gather moves half the bytes). The loss target is
# upcast in batch_loss, so the one change in numbers is the target rounded
# to bf16; labels and z stay in the GP dtype. True switches it on; None
# (the JAX package's default is off) and False leave it off.
# $LVAE_TABLE_BF16 sets it.
use_bf16_table: Optional[bool] = mv.bf16_switch_from_env("LVAE_TABLE_BF16")


def _bf16_table_active(model, dtype) -> bool:
    """Whether a trainer of ``model`` in the GP ``dtype`` stores its frame
    table in bf16."""
    return (bool(use_bf16_table) and dtype == torch.float32
            and getattr(model, "compute_dtype", None) == torch.bfloat16)


class HensmanConfig(NamedTuple):
    """Static configuration of the step."""

    spec0: kx.KernelSpec
    spec1: kx.KernelSpec
    latent_dim: int
    P_tot: int
    N_tot: int
    weight: float
    loss_function: str  # 'mse' | 'nll'
    natural_gradient: bool
    natural_gradient_lr: float
    constrain_scales: bool
    eps: float
    dropout: bool  # dropout in the training forward passes
    vy_fixed: bool = False  # freeze the observation noise
    learn_inducing: bool = False  # optimise the inducing points


class StepMetrics(NamedTuple):
    net: torch.Tensor
    recon: torch.Tensor
    nll: torch.Tensor
    kld: torch.Tensor


class BlockTable(NamedTuple):
    """Padded subject-block table on the run's device (P padded to a multiple
    of the batch size; ghost rows carry a zero mask)."""

    index: torch.Tensor  # [P_pad, T] int64
    mask: torch.Tensor  # [P_pad, T]
    num_real: int  # true subject count P


def build_block_table(blocks: bk.SubjectBlocks, subjects_per_batch: int,
                      dtype=torch.float32, device="cpu") -> BlockTable:
    """Pad the host block table to a batch multiple and move it to ``device``."""
    p = blocks.num_subjects
    s = subjects_per_batch
    p_pad = (p + s - 1) // s * s
    index = np.zeros((p_pad, blocks.t_max), np.int64)
    mask = np.zeros((p_pad, blocks.t_max), np.float32)
    index[:p] = blocks.index
    mask[:p] = blocks.mask
    return BlockTable(
        index=torch.as_tensor(index, device=device),
        mask=torch.as_tensor(mask, dtype=dtype, device=device),
        num_real=p,
    )


def _noise_from(gp: st.GPParams, cfg: HensmanConfig) -> torch.Tensor:
    if cfg.constrain_scales:
        # likelihood noise pinned to 1; raw_noise never reaches the loss, so
        # its gradient is zero and Adam leaves it at its init
        return torch.ones_like(gp.raw_noise)
    return kx.constrain(gp.raw_noise)


def batch_loss(
    model,
    cfg: HensmanConfig,
    trainables: st.Trainables,
    m_nat: Optional[torch.Tensor],
    H_nat: Optional[torch.Tensor],
    tdata: st.TrainData,
    idx: torch.Tensor,  # [S, T] rows of tdata
    bmask: torch.Tensor,  # [S, T]
    p_batch: torch.Tensor,  # scalar: real subjects in the batch
    eps: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    view: Local = LOCAL,
) -> Tuple[torch.Tensor, Tuple[StepMetrics, Optional[eb.NaturalGradients]]]:
    """Net loss of one subject batch, differentiable in the trainables.

    ``eps [S·T, L]`` is the reparameterisation noise; when it is None it is
    drawn from ``generator`` (a CPU generator) and moved to the device.
    Returns ``(net, (metrics, natural gradients or None))``.

    On a rank's shard (``view``) ``idx``, ``bmask`` and ``eps`` hold the
    rank's subjects, ``trainables``, ``m_nat`` and ``H_nat`` the rank's
    latents (``view.latent_shard`` of the state), and ``p_batch`` counts
    the whole batch's real subjects. The
    loss and the metrics are then the rank's shares: the reconstruction
    terms on the first latent rank of each data rank, the KL terms as
    ``minibatch_kld`` counts them; the natural gradients are the rank's
    latents'.
    """
    s, t = idx.shape
    flat = idx.reshape(-1)
    x = tdata.data[flat]
    labels = tdata.labels[flat]
    gp_dtype = labels.dtype
    # a bf16 frame table feeds the model as it is; the loss target and the
    # mask are upcast to the GP dtype (labels always carry it)
    pixmask = tdata.pixmask[flat].to(gp_dtype)
    valid = bmask.reshape(-1)

    model.train(cfg.dropout)
    mu_m, lv_m = model.encode(x)
    if eps is None:
        if generator is None:
            raise ValueError("batch_loss needs eps or a generator to draw it from")
        eps = torch.randn(mu_m.shape, generator=generator, dtype=gp_dtype)
    if view.weight("data"):
        # the sample in the model's compute dtype, as the JAX model draws it
        z_lat = mu_m + eps.to(mu_m.device, mu_m.dtype) * torch.exp(0.5 * lv_m)
        recon = model.decode(z_lat)
        raw_log_vy = model.raw_log_vy.detach() if cfg.vy_fixed else model.raw_log_vy
        mse_i, nll_i = mv.vae_loss(raw_log_vy, recon, x.to(gp_dtype), pixmask)
        recon_loss = torch.sum(mse_i * valid)
        nll_loss = torch.sum(nll_i * valid)
    else:  # another latent rank of these subjects counts their reconstruction
        recon_loss = nll_loss = mu_m.new_zeros((), dtype=gp_dtype)
    # the GP algebra never sees a bf16 model's moments
    mu, log_var = mu_m.to(gp_dtype), lv_m.to(gp_dtype)

    phase("gp_forward")
    lat = view.lat
    gp = trainables.gp
    noise = _noise_from(gp, cfg)
    z_pts = trainables.z if (cfg.learn_inducing and trainables.z is not None) else tdata.z
    xb = (labels * valid[:, None]).reshape(s, t, -1)
    mu_b = mu.reshape(s, t, cfg.latent_dim)[..., lat]
    lv_b = log_var.reshape(s, t, cfg.latent_dim)[..., lat]
    if cfg.natural_gradient:
        m_var, psd_h = m_nat, H_nat
    else:
        m_var = trainables.m
        psd_h = st.psd_from_factor(trainables.h_factor)
    # the GP part's backward ends when each of its inputs has its gradient
    phase_at_grads([mu_b, lv_b, *gp.kp0, *gp.kp1, noise, z_pts, m_var, psd_h], "vae_backward")

    # K0zz and H factor in one stacked call
    ops = eb.gp_block_operators(
        cfg.spec0, cfg.spec1, gp.kp0, gp.kp1, noise, xb, z_pts,
        mask=bmask, eps=cfg.eps, extra_spd=psd_h, view=view,
    )
    kld, ng = eb.minibatch_kld(
        ops, m_var, psd_h, mu_b, lv_b,
        P_tot=cfg.P_tot, P_batch=p_batch, N_tot=cfg.N_tot,
        natural_gradient=cfg.natural_gradient,
        H_factor=(ops.extra_chol, ops.extra_inv), view=view,
    )

    scale = cfg.P_tot / p_batch.to(recon_loss.dtype)
    recon_loss = recon_loss * scale
    nll_loss = nll_loss * scale
    if cfg.loss_function == "nll":
        net = nll_loss + kld
        kld_rep = kld
    else:
        kld_rep = kld / cfg.latent_dim
        net = recon_loss + cfg.weight * kld_rep
    metrics = StepMetrics(
        net=net.detach(), recon=recon_loss.detach(), nll=nll_loss.detach(),
        kld=kld_rep.detach(),
    )
    return net, (metrics, ng)


class HensmanTrainer:
    """Epochs of Hensman training on one device.

    ``model`` is a port VAE (``models/vae.make_vae``) carrying its initial
    weights; ``dataset`` any object with numpy ``data [N, ...]``,
    ``labels [N, Q]`` and ``mask [N, D]``; ``blocks`` its
    ``data/blocks.SubjectBlocks``; ``z [M, Q]`` the inducing points. The GP
    hyperparameters and (m, H) are initialised as the JAX package does, from
    ``seed``. ``device`` is ``"cuda"`` unless the caller asks for the CPU.
    """

    def __init__(
        self,
        model,
        cfg: HensmanConfig,
        dataset,
        blocks: bk.SubjectBlocks,
        z: np.ndarray,
        subjects_per_batch: int,
        learning_rate: float = 1e-3,
        seed: int = 0,
        dtype=torch.float32,
        t_buckets: int = 1,
        device="cuda",
    ):
        t_model = int(getattr(model, "T", 0) or 0)
        lens = np.unique(np.asarray(blocks.t_lens))
        if t_model and (lens.size != 1 or int(lens[0]) != t_model):
            # the recurrence has no validity mask: a short subject's padded
            # slots would carry row 0's frames into its real timesteps
            raise ValueError(
                f"RNN encoder (T={t_model}) requires a fixed-T cohort with exactly T rows per "
                f"subject; got subject lengths {sorted(set(lens.tolist()))}. Use the MLP/conv "
                "encoders for ragged (varying_T) cohorts.")
        self.device = resolve_device(device)
        self.model = model.to(device=self.device, dtype=dtype)
        self.cfg = cfg
        self.blocks = blocks
        self.subjects_per_batch = subjects_per_batch
        self.learning_rate = learning_rate
        self.dtype = dtype
        bucket_blocks = bk.bucket_subject_blocks(blocks, t_buckets) if t_buckets > 1 else [blocks]
        self.tables = tuple(
            build_block_table(b, subjects_per_batch, dtype, self.device) for b in bucket_blocks
        )

        def dev(a, as_dtype=dtype):
            return torch.as_tensor(np.asarray(a), dtype=as_dtype, device=self.device)

        table = torch.bfloat16 if _bf16_table_active(self.model, dtype) else dtype
        self.tdata = st.TrainData(
            data=dev(dataset.data, table), labels=dev(dataset.labels),
            pixmask=dev(dataset.mask, table), z=dev(z),
        )

        gp = st.init_gp_params(
            cfg.spec0, cfg.spec1, cfg.latent_dim,
            constrain_scales=cfg.constrain_scales, dtype=dtype, device=self.device,
        )
        m0, h0 = st.init_variational(
            cfg.latent_dim, z.shape[0], cfg.natural_gradient, seed, dtype, self.device
        )
        z_train = self.tdata.z.clone() if cfg.learn_inducing else None
        if cfg.natural_gradient:
            trainables = st.Trainables(vae=self.model, gp=gp, m=None, h_factor=None, z=z_train)
            m_nat, H_nat = m0, h0
        else:
            trainables = st.Trainables(vae=self.model, gp=gp, m=m0, h_factor=h0, z=z_train)
            m_nat = H_nat = None
        for p in trainables.parameters():
            p.requires_grad_(True)
        self.state = st.HensmanState(
            trainables=trainables,
            m_nat=m_nat,
            H_nat=H_nat,
            opt_state=st.make_optimizer(trainables.parameters(), learning_rate),
            rng=torch.Generator().manual_seed(seed),
            step=0,
        )
        self.history: List[StepMetrics] = []
        # the last chunk's steps: their metrics and whether each kept its
        # natural-gradient update (the guard's decision)
        self.last_steps: List[Tuple[StepMetrics, bool]] = []
        self.view: Local = LOCAL  # a rank's shard on a mesh (parallel/mesh.py)

    # ---------------------------------------------------------------- state
    @property
    def state(self) -> st.HensmanState:
        return self._state

    @state.setter
    def state(self, value: st.HensmanState) -> None:
        """A new state drops the captured steps: a graph reads and writes the
        tensors it was captured on, so the next chunk captures again."""
        self._state = value
        self._graphs = StepGraphs()

    # ------------------------------------------------------------- one step
    def _step(self, table: BlockTable, rows: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
        """The step function on device buffers: batch ``rows [S]`` of
        ``table`` with noise ``eps [S·T, L]``. Adam on the trainables, then
        the natural-gradient update of (m, H), both in place; returns
        ``[net, recon, nll, kld, kept]`` on the device, ``kept`` 1 where
        the guard kept the natural-gradient update (on a mesh, the metrics
        summed over the ranks). Safe to capture (``train/graph.py``)."""
        state, view, cfg = self._state, self.view, self.cfg
        phase("vae_forward")
        b_idx = table.index[rows]
        b_mask = table.mask[rows]
        p_batch = torch.sum(rows < table.num_real).to(b_mask.dtype)
        if view is not LOCAL:
            # the whole batch's noise, as one process draws it, then this
            # rank's subjects of everything
            s, t = b_idx.shape
            eps = view.take_subjects(eps.reshape(s, t, -1)).reshape(-1, cfg.latent_dim)
            b_idx, b_mask = view.take_subjects(b_idx), view.take_subjects(b_mask)
        opt = state.opt_state
        opt.zero_grad(set_to_none=True)
        shard = view.latent_shard(state)  # views: gradients reach the whole trainables
        net, (metrics, ng) = batch_loss(
            self.model, cfg, shard.trainables, shard.m_nat, shard.H_nat,
            self.tdata, b_idx, b_mask, p_batch, eps=eps, view=view,
        )
        phase("gp_backward")
        net.backward()
        phase("update")
        params = list(state.trainables.parameters())
        for p in params:
            # a trainable the loss does not reach (raw_noise under
            # constrain_scales) gets a zero gradient, as in optax: its Adam
            # moments and step count advance with the others
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        view.sum_grads(params)
        opt.step()
        kept = torch.ones((), dtype=net.dtype, device=net.device)
        if cfg.natural_gradient:
            m_new, h_new, ok = eb.natural_gradient_proposal(
                shard.m_nat, shard.H_nat, ng, cfg.natural_gradient_lr, view)
            n_lat = cfg.latent_dim
            m_new = view.gather_latents(torch.where(ok, m_new, shard.m_nat), n_lat)
            h_new = view.gather_latents(torch.where(ok, h_new, shard.H_nat), n_lat)
            state.m_nat.copy_(m_new)
            state.H_nat.copy_(h_new)
            kept = ok.to(net.dtype)
        out = torch.stack([*view.world_metrics(metrics), kept])
        phase_end()
        return out

    def train_step(self, table: BlockTable, order_rows: torch.Tensor,
                   eps: Optional[torch.Tensor] = None) -> StepMetrics:
        """One eager step on the batch of table rows ``order_rows [S]``
        (rows at or past ``table.num_real`` are ghosts): Adam on the
        trainables, then the natural-gradient update of (m, H), in place.
        ``eps [S·T, L]`` is drawn from the state's generator when not given.
        Returns device metrics (on a mesh, summed over the ranks: one
        process's numbers)."""
        if eps is None:
            shape = (order_rows.shape[0] * table.index.shape[1], self.cfg.latent_dim)
            eps = torch.randn(shape, generator=self._state.rng, dtype=self.dtype)
        out = self._step(table, order_rows.to(self.device), eps.to(self.device, self.dtype))
        self._advance()
        return StepMetrics(*out[:4])

    def _advance(self) -> None:
        """Count a step taken (its tensors were updated in place)."""
        state = self._state
        if self.cfg.learn_inducing and state.trainables.z is not None:
            # keep the serving/eval view (tdata.z) on the learned points
            self.tdata = self.tdata._replace(z=state.trainables.z.detach())
        self._state = state._replace(step=state.step + 1)

    def _run_step(self, b: int, rows: torch.Tensor, eps: torch.Tensor,
                  out: torch.Tensor) -> None:
        """Step ``rows``/``eps`` of bucket ``b`` into the metrics row
        ``out [5]``: on the card the captured step (captured at the first
        batch of its shape and route switches, which runs as the warm-up),
        on the CPU and on a mesh view the eager one."""
        table = self.tables[b]
        self._graphs.run((b, *route_key()),
                         lambda r, e: self._step(table, r, e), (rows, eps), out,
                         eager=self.device.type != "cuda" or self.view is not LOCAL)
        self._advance()

    # --------------------------------------------------------------- epochs
    @property
    def steps_per_epoch(self) -> int:
        return sum(t.index.shape[0] // self.subjects_per_batch for t in self.tables)

    def _epoch_order(self, table: BlockTable) -> torch.Tensor:
        """This epoch's batches of table rows ``[n_batches, S]``: a
        permutation of the real subjects from the state's generator, then
        the ghost rows."""
        p_pad = table.index.shape[0]
        perm = torch.randperm(table.num_real, generator=self._state.rng)
        perm = torch.cat([perm, torch.arange(table.num_real, p_pad)])
        return perm.reshape(p_pad // self.subjects_per_batch, self.subjects_per_batch)

    def _draws(self, n: int, orders=None) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """A chunk's draws per bucket on the device: the batch rows
        ``[n, n_batches, S]`` and the noise ``[n, n_batches, S·T, L]``. They
        come from the state's generator in the order the steps would draw
        them one by one: per epoch and bucket the permutation, then one
        ``randn`` a step. ``orders[e][b]`` replaces a drawn permutation.
        They are filled in a fresh pinned slab on the host and copied to the
        card at once (the allocator keeps a pinned block until its copy is
        done, so a slab in flight is never refilled)."""
        gen, s, n_lat = self._state.rng, self.subjects_per_batch, self.cfg.latent_dim
        pin = self.device.type == "cuda"
        slabs = []
        for table in self.tables:
            nb, t = table.index.shape[0] // s, table.index.shape[1]
            slabs.append((torch.empty((n, nb, s), dtype=torch.int64, pin_memory=pin),
                          torch.empty((n, nb, s * t, n_lat), dtype=self.dtype, pin_memory=pin)))
        for e in range(n):
            for b, (table, (rows, eps)) in enumerate(zip(self.tables, slabs)):
                rows[e] = (self._epoch_order(table) if orders is None
                           else torch.as_tensor(orders[e][b]))
                for i in range(rows.shape[1]):
                    eps[e, i].normal_(generator=gen)  # torch.randn's draw
        return [(rows.to(self.device, non_blocking=True), eps.to(self.device, non_blocking=True))
                for rows, eps in slabs]

    def _dispatch_epochs(self, n: int, orders=None):
        """Run an ``n``-epoch chunk without waiting for the device; returns
        its per-step metrics ``[n, steps, 5]`` and, on the card, their host
        copy in flight and the event that marks it done. The chunk's draws
        go to the device in one copy, or in parts of whole epochs where
        they exceed ``graph.SLAB_BYTES``."""
        out = torch.empty((n, self.steps_per_epoch, 5), dtype=self.dtype, device=self.device)
        item = self.tdata.labels.element_size()
        epoch_bytes = sum(t.index.shape[0] * (t.index.shape[1] * self.cfg.latent_dim * item + 8)
                          for t in self.tables)
        part = epochs_per_slab(epoch_bytes)
        for start in range(0, n, part):
            m = min(part, n - start)
            with span("lvae.train.draws"):
                draws = self._draws(m, None if orders is None else orders[start:start + m])
            with span("lvae.train.dispatch"):
                for e in range(m):
                    k = 0
                    for b, (rows, eps) in enumerate(draws):
                        for i in range(rows.shape[1]):
                            self._run_step(b, rows[e, i], eps[e, i], out[start + e, k])
                            k += 1
        return start_host_copy(out)

    def _materialize_metrics(self, chunk, n: int) -> List[StepMetrics]:
        """Wait for a dispatched chunk's metrics; returns each epoch's mean
        over its steps as host floats (appended to ``history``); its steps'
        metrics and guard decisions become ``last_steps``. With tracing on
        the captured step's phase times are sampled after the wait."""
        with span("lvae.train.read"):
            host = finish_host_copy(chunk)
            record_phases(self._graphs)
            out = []
            for e in range(n):
                m = StepMetrics(*host[e, :, :4].mean(0).tolist())
                self.history.append(m)
                out.append(m)
            self.last_steps = [(StepMetrics(*row[:4]), row[4] > 0)
                               for row in host.reshape(-1, 5).tolist()]
        return out

    def run_epochs(self, n: int) -> List[StepMetrics]:
        """Run ``n`` epochs as one chunk; returns their metrics."""
        return self._materialize_metrics(self._dispatch_epochs(n), n)

    def run_epoch(self, order: Optional[Sequence] = None) -> StepMetrics:
        """One epoch over every bucket; returns the epoch's mean metrics as
        host floats. ``order`` (one ``[n_batches, S]`` array of table rows per
        bucket) replaces the drawn permutations."""
        chunk = self._dispatch_epochs(1, None if order is None else [order])
        return self._materialize_metrics(chunk, 1)[0]

    def _log_chunk(self, ms, done: int, epochs: int, log_every: int):
        for i, m in enumerate(ms):
            epoch = done + i + 1
            if log_every and (epoch % log_every == 0):
                print(
                    "Iter %d/%d - Loss: %.3f  - GP loss: %.3f"
                    "  - NLL Loss: %.3f  - Recon Loss: %.3f"
                    % (epoch, epochs, m.net, m.kld, m.nll, m.recon),
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

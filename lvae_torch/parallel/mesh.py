"""Subject- and latent-parallel training and serving over a process mesh
(port of lvae_tpu.parallel.mesh).

The JAX package places arrays on a 2-D ``Mesh('data', 'latent')`` and lets
GSPMD partition one program. The port runs one process per rank of a mesh
of the same axes, over ``torch.distributed``:

* **data** — subjects. A rank encodes its subjects' frames and builds their
  ``[L', S', T, T]`` block stacks (kernel K1 at the rank's shape); the KL
  terms that sum over subjects are summed over the axis.
* **latent** — the L independent GPs. A rank builds K0zz, factors it with
  H (kernel K2) and updates (m, H) for its latents only.

Every rank holds the whole state (the VAE, the GP hyperparameters, (m, H),
the optimizer and the CPU generator), as a replica; the state is small
beside the frames. A rank computes its share of the loss
(:class:`RankView`: each term counted on exactly one rank), the gradients
are summed over the world, and every rank takes the same optimizer step,
so the replicas stay equal and every rank reports what one process
reports. Where L does not divide the latent axis or the cohort the data
axis, that axis is replicated (with a warning) or padded with ghost
subjects, as in JAX. A checkpoint is the whole state: a run saved at one
world size resumes at another.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch
import torch.distributed as dist

from lvae_torch.ops import kernels as kx
from lvae_torch.ops.shard import Local
from lvae_torch.parallel import collectives as col
from lvae_torch.parallel.distributed import rank_device
from lvae_torch.train import state as st

AXES = ("data", "latent")


class Mesh:
    """A ``(data, latent)`` grid of ranks: world rank ``r`` sits at data
    index ``r // latent`` and latent index ``r % latent``. ``groups`` holds
    the process group of this rank's data column and latent row (None for
    an axis of one rank); ``world_group`` is None without a process group."""

    axis_names = AXES

    def __init__(self, data: int, latent: int, rank: int, device: torch.device,
                 world_group, groups: dict):
        self.shape = {"data": data, "latent": latent}
        self.size = data * latent
        self.rank = rank
        self.coords = {"data": rank // latent, "latent": rank % latent}
        self.device = device
        self.world_group = world_group
        self.groups = groups

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape['data']}, latent={self.shape['latent']}, "
                f"rank={self.rank}, device={self.device})")

    @property
    def writer(self) -> bool:
        """Whether this rank writes the run's files (rank 0)."""
        return self.rank == 0

    def view(self, n_subjects: int, n_latents: int, what: str = "RankView") -> "RankView":
        return RankView(self, n_subjects, n_latents, what)

    def barrier(self) -> None:
        col.barrier(self.world_group, self.device)

    def broadcast_(self, tensors, src: int = 0) -> None:
        """Every rank's tensors become rank ``src``'s, in place."""
        col.broadcast_(tensors, self.world_group, src)

    def agree(self, value: float) -> float:
        """Rank 0's ``value`` on every rank (a decision all ranks follow)."""
        if self.world_group is None:
            return value
        t = torch.tensor([float(value)], dtype=torch.float64, device=self.device)
        self.broadcast_([t])
        return float(t[0])


def make_mesh(data: int = 1, latent: int = 1, device=None) -> Mesh:
    """A ``(data, latent)`` mesh over the process group. ``data · latent``
    must equal the world size (1 without a process group, when the trivial
    1 × 1 mesh needs none). ``device`` (``cuda`` by default) is resolved
    per rank (``distributed.rank_device``)."""
    n = data * latent
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        raise ValueError(f"a data={data} x latent={latent} mesh needs {n} processes; the world "
                         f"size is {world} (start the ranks with torchrun or "
                         "parallel.initialize_distributed)")
    dev = rank_device(device or "cuda")
    if not dist.is_initialized():
        return Mesh(data, latent, 0, dev, None, {"data": None, "latent": None})
    rank = dist.get_rank()
    groups = {"data": None, "latent": None}
    # every rank creates every group, in one order
    for di in range(data):
        members = [di * latent + li for li in range(latent)]
        g = dist.new_group(members) if latent > 1 else None
        if rank in members and g is not None:
            groups["latent"] = g
    for li in range(latent):
        members = [di * latent + li for di in range(data)]
        g = dist.new_group(members) if data > 1 else None
        if rank in members and g is not None:
            groups["data"] = g
    return Mesh(data, latent, rank, dev, dist.group.WORLD, groups)


def _block(index: int, parts: int, n: int) -> slice:
    k = n // parts
    return slice(index * k, (index + 1) * k)


def _axis_slice(n: int, mesh: Mesh, axis: str):
    """``(this rank's slice of an axis of length n, whether it is sharded)``:
    sharded when the mesh axis has several ranks and divides ``n``, else
    whole on every rank (the JAX rule, ``lvae_tpu/parallel/mesh.py:75-85``)."""
    parts = mesh.shape[axis]
    if parts > 1 and n % parts == 0:
        return _block(mesh.coords[axis], parts, n), True
    return slice(None), False


def _split(n: int, mesh: Mesh, axis: str, what: str):
    """:func:`_axis_slice`, with a warning where the mesh axis asked for
    parallelism and gets none, so a user asking for it learns they did not
    get it."""
    part, sharded = _axis_slice(n, mesh, axis)
    if not sharded and mesh.shape[axis] > 1:
        warnings.warn(f"{what}: {n} does not divide the {mesh.shape[axis]}-way '{axis}' mesh "
                      f"axis; replicating (no '{axis}' parallelism here)", stacklevel=3)
    return part, sharded


class RankView(Local):
    """One rank's view of a computation over ``n_subjects`` subjects and
    ``n_latents`` latent dims (:mod:`lvae_torch.ops.shard`).

    An axis is sharded when the mesh has more than one rank on it and the
    count divides it; else every rank of the axis holds all of it (a
    replica, with a warning naming ``what``) and only its first rank counts
    the terms summed over it. Sums over a sharded axis are collectives.
    """

    def __init__(self, mesh: Mesh, n_subjects: int, n_latents: int, what: str = "RankView"):
        self.mesh = mesh
        self.n_subjects = n_subjects
        self.n_latents = n_latents
        self.rows, data = _split(n_subjects, mesh, "data", f"{what} (subjects)")
        self.lat, latent = _split(n_latents, mesh, "latent", f"{what} (latent dims)")
        self.sharded = {"data": data, "latent": latent}

    def _group(self, axis: str):
        return self.mesh.groups[axis] if self.sharded[axis] else None

    def data_sums(self, *ts):
        return tuple(col.all_sums(ts, self._group("data")))

    def latent_mean(self, total, count):
        group = self._group("latent")
        if group is None:
            return total / count
        stats = col.all_sum(torch.stack([total, total.new_tensor(float(count))]), group)
        return stats[0] / stats[1]

    def all_latents(self, ok):
        group = self._group("latent")
        if group is None:
            return ok
        refused = col.all_sum((~ok).to(torch.float32).reshape(1), group)
        return (refused == 0).reshape(ok.shape)

    def gather_rows(self, t, n, dim=0):
        return col.gather(t, n, self.rows.start or 0, dim, self._group("data"))

    def gather_latents(self, t, n, dim=0):
        return col.gather(t, n, self.lat.start or 0, dim, self._group("latent"))

    def frames(self, t):
        if not self.sharded["data"]:
            return slice(None)
        return slice(self.rows.start * t, self.rows.stop * t)

    def take_subjects(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a ``[S, ...]`` batch tensor, padded with
        zero (ghost) rows to ``n_subjects`` first."""
        pad = self.n_subjects - x.shape[0]
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        return x[self.rows]

    def weight(self, *axes):
        for axis in AXES:
            counted_anywhere = axis in axes and self.sharded[axis]
            if not counted_anywhere and self.mesh.coords[axis] != 0:
                return 0.0
        return 1.0

    def world_metrics(self, metrics):
        if self.mesh.world_group is None:
            return metrics
        total = col.all_sum(torch.stack([m.detach() for m in metrics]), self.mesh.world_group)
        return type(metrics)(*total.unbind())

    def sum_grads(self, params):
        col.sum_into([p.grad for p in params], self.mesh.world_group)

    def latent_shard(self, state):
        return shard_hensman_state(state, self.mesh, self.n_latents)


# ------------------------------------------------------------------ layouts
def _shard_latent_leaf(x, mesh: Mesh, latent_dim: int):
    """A rank's latent slice of an ``[L, ...]`` tensor when L divides the
    latent axis; else the tensor itself (a replica)."""
    if isinstance(x, torch.Tensor) and x.ndim >= 1 and x.shape[0] == latent_dim:
        return x[_axis_slice(latent_dim, mesh, "latent")[0]]
    return x


def shard_train_data(tdata: st.TrainData, mesh: Mesh) -> st.TrainData:
    """The dataset on the rank's device, whole on every rank (batches are
    gathered from it by row index)."""
    return st.TrainData(*(t.to(mesh.device) for t in tdata))


def shard_hensman_state(state: st.HensmanState, mesh: Mesh, latent_dim: int) -> st.HensmanState:
    """The rank's shard of a Hensman state: the latent slices of its
    ``[L, ...]`` leaves (the GP hyperparameters, (m, H) or (m, H's factor)),
    as views of the whole state's tensors, so gradients reach the whole
    trainables; the VAE, the inducing points, the optimizer and the
    generator as they are. ``HensmanTrainer.train_step`` takes each step's
    shard through it (``RankView.latent_shard``)."""
    tr = state.trainables

    def leaf(x):
        return _shard_latent_leaf(x, mesh, latent_dim)

    gp = st.GPParams(kx.KernelParams(*map(leaf, tr.gp.kp0)),
                     kx.KernelParams(*map(leaf, tr.gp.kp1)), leaf(tr.gp.raw_noise))
    trainables = tr._replace(gp=gp, m=leaf(tr.m), h_factor=leaf(tr.h_factor))
    return state._replace(trainables=trainables, m_nat=leaf(state.m_nat),
                          H_nat=leaf(state.H_nat))


# ------------------------------------------------------------------ trainers
class _ShardedTrainer:
    """Shared facade of the sharded trainers.

    Attribute reads and writes pass to the inner trainer (a write landing
    in the wrapper would shadow the name while the trainer's methods read
    the stale inner value); ``state =`` places the new state on the rank's
    device (checkpoint resume, pre-trained VAE loads and auto-recovery all
    write through it); ``fit`` hands THIS wrapper to callbacks. The inner
    trainer computes on the rank's shard through its ``view``.
    """

    _OWN_ATTRS = ("inner", "mesh")

    def __init__(self, trainer, mesh: Mesh):
        if torch.device(trainer.device) != mesh.device:
            raise ValueError(f"the trainer runs on {trainer.device}, the mesh rank on "
                             f"{mesh.device}")
        self.inner = trainer
        self.mesh = mesh

    def __getattr__(self, name):
        if name == "inner":  # not set yet during __init__
            raise AttributeError(name)
        return getattr(self.inner, name)

    def __setattr__(self, name, value):
        if name in self._OWN_ATTRS or isinstance(getattr(type(self), name, None), property):
            super().__setattr__(name, value)
        else:
            setattr(self.inner, name, value)

    def _place(self, value):
        return value

    @property
    def state(self):
        return self.inner.state

    @state.setter
    def state(self, value):
        self.inner.state = self._place(value)

    def run_epoch(self, *args, **kwargs):
        return self.inner.run_epoch(*args, **kwargs)

    def run_epochs(self, n: int):
        return self.inner.run_epochs(n)

    def fit(self, epochs: int, log_every: int = 1, callback=None, chunk=None, overlap=None):
        cb = None if callback is None else (lambda _inner, epoch, m: callback(self, epoch, m))
        kwargs = {} if chunk is None else {"chunk": chunk}
        return self.inner.fit(epochs, log_every, cb, overlap=overlap, **kwargs)


class ShardedHensmanTrainer(_ShardedTrainer):
    """A ``train/hensman.HensmanTrainer`` whose steps run on a mesh.

    Each batch's subjects split over 'data' (ghost subjects pad a batch
    that does not divide the axis) and the latents over 'latent': a rank
    launches K1 on its ``[L/l, S/d, T, T]`` chain and K2 on its stacked
    ``[K0zz; H]`` latents and its ``ih_new``, and every rank reports one
    process's numbers. The dataset and block tables stay whole on every
    rank.

    The inner trainer's epoch program runs its steps eagerly here: the
    view's collectives (``sum_grads``, ``data_sums``, the metrics' sum) go
    through ``torch.distributed``, which a CUDA graph cannot capture, so a
    mesh view never captures its step (one process on the card does).
    """

    def __init__(self, trainer, mesh: Mesh):
        super().__init__(trainer, mesh)
        s, n_data = trainer.subjects_per_batch, mesh.shape["data"]
        s_pad = -(-s // n_data) * n_data
        if s_pad != s:
            print(f"ShardedHensmanTrainer: padding each batch of {s} subjects with "
                  f"{s_pad - s} ghost subject(s) to align the {n_data}-way data axis (ghosts "
                  "are fully masked; all losses unchanged)")
        trainer.tdata = shard_train_data(trainer.tdata, mesh)
        trainer.view = mesh.view(s_pad, trainer.cfg.latent_dim, "ShardedHensmanTrainer")

    def _place(self, value):
        def dev(t):
            return None if t is None else t.to(self.mesh.device)

        return value._replace(m_nat=dev(value.m_nat), H_nat=dev(value.H_nat))


class ShardedStandardTrainer(_ShardedTrainer):
    """A ``train/standard.StandardTrainer`` whose full-batch steps run on a
    mesh.

    The cohort's subjects split over 'data' in whole subjects (fully masked
    ghost subjects are appended where P does not divide the axis, and a
    message names them), the latents over 'latent'. The sparse modes sum
    their subject terms over 'data'; the closed mode gathers the whole
    cohort's moments over 'data' and builds the rank's ``[L/l, N, N]``
    prior (kernel K3). The GPPVAE pseudo-minibatch regime is refused: it
    runs in one process, its replay of the cohort one batched pass. The
    inner trainer's epoch program runs its steps eagerly here, as
    ``ShardedHensmanTrainer``'s.
    """

    def __init__(self, trainer, mesh: Mesh):
        if getattr(trainer, "pseudo_minibatch", False):
            raise ValueError(
                "mini_batch=True (GPPVAE) is a memory-bounding regime; use "
                "the plain sharded full-batch path instead"
            )
        super().__init__(trainer, mesh)
        p_subjects, t_len = trainer.block_mask.shape
        n_data = mesh.shape["data"]
        ghosts = (-p_subjects) % n_data
        if ghosts:
            # ghosts contribute exactly zero to every term: the block masks
            # zero them in the GP bounds (the closed KL gives them unit
            # prior rows) and their row validity zeroes the recon and NLL
            print(
                f"ShardedStandardTrainer: padding P={p_subjects} with "
                f"{ghosts} ghost subject(s) to align the {n_data}-way data "
                "axis (ghosts are fully masked; all losses unchanged)"
            )
            trainer.tdata, trainer.block_mask = pad_ghost_subjects(
                trainer.tdata, trainer.block_mask, ghosts)
        trainer.view = mesh.view(p_subjects + ghosts, trainer.cfg.latent_dim,
                                 "ShardedStandardTrainer")


def pad_ghost_subjects(tdata: st.TrainData, block_mask: torch.Tensor, ghosts: int):
    """``(tdata, block_mask)`` with ``ghosts`` zero subjects appended: zero
    frames, covariates, pixel masks and block masks."""
    t_len = block_mask.shape[1]

    def pad_rows(x):
        return torch.cat([x, x.new_zeros((ghosts * t_len,) + tuple(x.shape[1:]))])

    tdata = tdata._replace(data=pad_rows(tdata.data), labels=pad_rows(tdata.labels),
                           pixmask=pad_rows(tdata.pixmask))
    return tdata, torch.cat([block_mask, block_mask.new_zeros((ghosts, t_len))])


class ShardedVITrainer(_ShardedTrainer):
    """A ``train/vi.VITrainer`` whose phase-1 steps run on a mesh.

    The cohort's subjects (and their free moments ``mu/log_var [N, L]``)
    split over 'data' when P divides the axis, else every rank holds them
    all, with a warning; the GP latents split over 'latent'. Phase 2
    (prediction-set optimisation) runs whole on every rank, and every rank
    returns rank 0's result.
    """

    def __init__(self, trainer, mesh: Mesh):
        super().__init__(trainer, mesh)
        trainer.view = mesh.view(trainer.block_mask.shape[0], trainer.cfg.latent_dim,
                                 "ShardedVITrainer")

    def optimize_prediction_set(self, *args, **kwargs):
        mu_pred, lv_pred = self.inner.optimize_prediction_set(*args, **kwargs)
        both = torch.as_tensor(np.stack([mu_pred, lv_pred]), device=self.mesh.device)
        self.mesh.broadcast_([both])
        both = both.cpu().numpy()
        return both[0], both[1]


# ------------------------------------------------------------------- serving
@torch.no_grad()
def sharded_gp_predict(spec0, spec1, kp0, kp1, noise, inputs, z, mesh: Mesh, eps: float = 1e-6):
    """Mesh-parallel :func:`~lvae_torch.ops.predict.gp_predict`; every rank
    returns the whole ``[Pq, Tq, L]`` posterior.

    The training cohort's subjects split over 'data' (the fold's subject
    sums are summed over the axis; the per-query aligned block is gathered
    from the rank that holds it), the query subjects over 'data', the
    kernel hyperparameters, the noise and the posterior over 'latent' (each
    GP's posterior is independent). An axis that does not divide the mesh
    is replicated, with a warning. Inducing points are whole everywhere.
    The ranks' blocks come back through a sum of zero-filled buffers.
    """
    from lvae_torch.ops.predict import PredictInputs, gp_predict

    n_lat = noise.shape[0]
    view = mesh.view(inputs.xb.shape[0], n_lat, "sharded_gp_predict")
    q_rows, q_sharded = _split(inputs.Xb.shape[0], mesh, "data", "sharded_gp_predict (queries)")
    lat = view.lat
    local = PredictInputs(xb=inputs.xb, mask=inputs.mask, mu_b=inputs.mu_b[..., lat],
                          Xb=inputs.Xb[q_rows], Xmask=inputs.Xmask[q_rows],
                          align=inputs.align[q_rows])
    zb = gp_predict(spec0, spec1, kp0.latents(lat), kp1.latents(lat), noise[lat], local, z, eps,
                    view)
    if mesh.world_group is None:
        return zb
    whole = zb.new_zeros(tuple(inputs.Xb.shape[:2]) + (n_lat,))
    counted = ((q_sharded or mesh.coords["data"] == 0)
               and (view.sharded["latent"] or mesh.coords["latent"] == 0))
    if counted:
        whole[q_rows, :, lat] = zb
    return col.all_sum(whole, mesh.world_group)

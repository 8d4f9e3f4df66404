"""Serving-side inference API (port of lvae_tpu.inference).

Packages a trained L-VAE into a predictor for three capabilities:

* :meth:`LVAEPredictor.impute` — reconstruct missing pixels of observed
  frames;
* :meth:`LVAEPredictor.predict_trajectory` — given observed frames of a
  subject (even one never seen in training), predict its frames at
  arbitrary query covariates;
* :meth:`LVAEPredictor.encode` / :meth:`decode` — raw latent access.

:meth:`LVAEPredictor.aot_compile` builds a :class:`CompiledServing` bundle
with a fixed batch shape and a pre-folded GP basis: the counterpart of the
JAX package's ahead-of-time compiled executables are, on the card, its
programs captured once as CUDA graphs at their fixed shapes and replayed
per request (``train/graph.StepGraphs``), and the basis fold and its
extension run as GP programs keyed on the specs and the cohort's shape
(``ops/predict.fold_basis``, ``extend_basis``), which a later bundle of the
same shapes replays; on the CPU they run eagerly.
Everything runs on ``device``, ``cuda`` unless the caller passes ``"cpu"``;
arrays cross the API as host numpy.
"""

from __future__ import annotations

import copy
import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch import nn

from lvae_torch.data.blocks import build_subject_blocks
from lvae_torch.evaluation.encode import decode_latents, encode_dataset
from lvae_torch.evaluation.programs import dataset_tensor
from lvae_torch.ops import kernels as kx
from lvae_torch.ops.predict import (
    PredictBasis,
    extend_basis,
    fold_basis,
    gp_predict_extend_batch,
    predict_latents,
)
from lvae_torch.train.graph import StepGraphs, steps_eagerly
from lvae_torch.train.state import GPParams
from lvae_torch.utils.device import resolve_device


def _f32(x, device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


@dataclass
class LVAEPredictor:
    """A frozen, trained L-VAE ready for serving.

    ``noise`` is the constrained per-latent GP noise σ² ``[L]``; ``z`` the
    inducing points ``[M, Q]``; ``basis_labels [N, Q]`` / ``basis_mu [N, L]``
    the training cohort's covariates and encoded latent means, the GP
    regression basis. On construction the model and the GP tensors move to
    ``device`` as float32, and the model is put in ``eval()`` mode; a model
    with a bf16 ``compute_dtype`` keeps it, and its answers reach the host
    as float32.
    """

    model: nn.Module
    gp_params: GPParams
    noise: torch.Tensor
    spec0: kx.KernelSpec
    spec1: kx.KernelSpec
    z: torch.Tensor
    id_covariate: int
    basis_labels: np.ndarray
    basis_mu: np.ndarray
    eps: float = 1e-6
    device: object = "cuda"
    mesh: object = None  # a parallel.mesh.Mesh: the GP posterior runs mesh-parallel

    # ------------------------------------------------------------- factories
    @classmethod
    def from_pipeline(cls, pipeline) -> "LVAEPredictor":
        """Package a trained :class:`~lvae_torch.pipeline.LVAEPipeline`: a
        copy of its VAE and GP parameters (later training does not change
        the predictor), the inducing points, and the training cohort
        encoded as the regression basis, on the pipeline's device."""
        model, gp_params, noise = pipeline.current_params()
        model = copy.deepcopy(model)
        data = dataset_tensor(pipeline.dataset.data, model.raw_log_vy.dtype, pipeline.device)
        mu, _ = encode_dataset(model, data, device=pipeline.device)
        with torch.no_grad():
            gp = gp_params.to(copy=True)
        return cls(
            model=model, gp_params=gp, noise=noise.clone(), spec0=pipeline.spec0,
            spec1=pipeline.spec1, z=pipeline.trainer.tdata.z.detach().clone(),
            id_covariate=pipeline.cfg.id_covariate,
            basis_labels=np.asarray(pipeline.dataset.labels), basis_mu=mu,
            eps=pipeline.cfg.eps, device=pipeline.device,
            # a sharded pipeline's mesh carries over to the GP posterior
            mesh=getattr(pipeline, "mesh", None),
        )

    @classmethod
    def from_checkpoint(cls, path: str, pipeline_cfg, dataset=None,
                        device="cuda") -> "LVAEPredictor":
        """Rebuild from a pipeline checkpoint (``model_final.ckpt``,
        ``model_best.ckpt``, ...) with its config and, optionally, the
        training cohort (else the config's files are read)."""
        from lvae_torch.pipeline import LVAEPipeline
        from lvae_torch.utils.checkpoint import try_load_checkpoint

        pipeline = LVAEPipeline(pipeline_cfg, {"train": dataset} if dataset is not None else None,
                                device=device)
        trainer = pipeline.build_trainer()
        state = try_load_checkpoint(path, like=trainer.state)
        if state is None:
            raise FileNotFoundError(f"could not load checkpoint {path!r} (see log above)")
        trainer.state = state
        return cls.from_pipeline(pipeline)

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.model = self.model.to(device=self.device, dtype=torch.float32).eval()
        self.gp_params = self.gp_params.to(device=self.device, dtype=torch.float32)
        self.noise = _f32(self.noise, self.device)
        self.z = _f32(self.z, self.device)
        self.basis_labels = np.asarray(self.basis_labels)
        # a float64 pipeline's encodings join the float32 posterior
        self.basis_mu = np.asarray(self.basis_mu, np.float32)

    # ------------------------------------------------------------ primitives
    def encode(self, data) -> np.ndarray:
        """Data → latent means [N, L]."""
        mu, _ = encode_dataset(self.model, np.asarray(data), device=self.device)
        return mu

    def decode(self, latents) -> np.ndarray:
        """Latents [N, L] → data space."""
        return decode_latents(self.model, np.asarray(latents), device=self.device)

    # ---------------------------------------------------------- capabilities
    def impute(self, data, mask=None) -> np.ndarray:
        """Reconstruct frames; where ``mask`` marks pixels observed, keep the
        observation and fill only the missing entries with the model."""
        data = np.asarray(data)
        recon = self.decode(self.encode(data))
        if mask is None:
            return recon
        mask = np.asarray(mask, np.float32).reshape(recon.shape)
        return data * mask + recon * (1.0 - mask)

    def predict_latent_trajectory(
        self, observed_data, observed_labels, query_labels
    ) -> np.ndarray:
        """GP posterior latents at ``query_labels`` [Nq, Q] → [Nq, L].

        ``observed_*`` extend the regression basis — typically a new
        subject's observed timepoints; queries for that subject ride its id
        kernel, queries for unseen subjects get the population mean. Every
        call refolds the whole cohort (the full recompute).
        """
        obs_mu = self.encode(observed_data)
        basis_labels = np.concatenate(
            [np.asarray(observed_labels), self.basis_labels], axis=0
        )
        basis_mu = np.concatenate([obs_mu, self.basis_mu], axis=0)
        return predict_latents(
            self.spec0, self.spec1, self.gp_params.kp0, self.gp_params.kp1,
            self.noise, basis_labels, basis_mu,
            np.asarray(query_labels), self.z, self.id_covariate, self.eps, mesh=self.mesh,
        )

    def predict_trajectory(
        self, observed_data, observed_labels, query_labels
    ) -> np.ndarray:
        """Predicted frames at the query covariates (decode of the above)."""
        z_pred = self.predict_latent_trajectory(
            observed_data, observed_labels, query_labels
        )
        return self.decode(z_pred)

    def aot_compile(
        self,
        batch_size: int = 256,
        t_obs: Optional[int] = None,
        n_query: Optional[int] = None,
        k_subjects: int = 1,
    ) -> "CompiledServing":
        """Build the fixed-shape serving bundle (see :class:`CompiledServing`).

        With ``t_obs``/``n_query`` set, the cohort's GP operators are folded
        once and each trajectory request runs encode → low-rank GP
        extension → decode for ``k_subjects`` new subjects.
        """
        return CompiledServing(
            self, batch_size, t_obs=t_obs, n_query=n_query, k_subjects=k_subjects
        )


class CompiledServing:
    """Fixed-shape serving bundle.

    Requests of any length are served in chunks of ``batch_size`` rows (for
    an RNN encoder rounded down to a multiple of its ``T``, at least T) with
    tail padding, so every model call sees one batch shape; the trajectory
    path holds the folded cohort basis ``(H, c)`` on the device and serves
    each request of ``k_subjects`` new subjects without refolding the
    cohort.

    Its programs (``encode``, ``decode`` and ``recon`` at the batch shape,
    and with ``t_obs``/``n_query`` the trajectory program encode → GP
    extension → decode at ``[k_subjects, t_obs]``) are captured on the card
    at construction as CUDA graphs over fixed input buffers, in one memory
    pool, and each request replays them; on the CPU they run eagerly. A
    graph reads the addresses it was captured with, so the basis lives in
    fixed buffers of this bundle that :meth:`refresh_basis` overwrites.

    One caller at a time may use a bundle and its siblings
    (:meth:`for_k_subjects`): they share the batch programs' fixed input
    and output buffers, and each answer is copied out of them before the
    next replay overwrites them.
    """

    def __init__(
        self,
        predictor: LVAEPredictor,
        batch_size: int,
        t_obs: Optional[int] = None,
        n_query: Optional[int] = None,
        k_subjects: int = 1,
    ):
        self.batch_size = int(batch_size)
        self.predictor = predictor
        model = predictor.model
        # a recurrent encoder consumes whole subject sequences: the batch is
        # a multiple of T (zero tail padding then forms whole fake subjects)
        self.seq_len = int(getattr(model, "T", 0) or 0)
        if self.seq_len:
            self.batch_size = max(self.seq_len, self.batch_size // self.seq_len * self.seq_len)
            if t_obs is not None and n_query is not None and t_obs != self.seq_len:
                # a request is one subject's observed frames; the encoder
                # must see them as one recurrence
                raise ValueError(
                    f"RNN trajectory serving requires t_obs == T={self.seq_len} (one whole "
                    f"subject sequence); got t_obs={t_obs}")
        if model.is_conv:
            hw = model.image_hw
            self._in_shape = (self.batch_size, hw, hw, 1)
        else:
            self._in_shape = (self.batch_size, model.num_dim)
        self.t_obs, self.n_query = t_obs, n_query
        self.k_subjects = int(k_subjects)
        self._basis: Optional[PredictBasis] = None
        self._graphs = StepGraphs(
            torch.cuda.graph_pool_handle() if self.device.type == "cuda" else None,
            inference=True)
        latent = predictor.basis_mu.shape[1]
        self._capture("encode", self._in_shape)
        self._capture("decode", (self.batch_size, latent))
        self._capture("recon", self._in_shape)
        if t_obs is not None and n_query is not None:
            self._fold_basis()
            self._capture_trajectory()

    @property
    def device(self) -> torch.device:
        return self.predictor.device

    # -------------------------------------------------------------- programs
    def _program(self, name: str):
        """The program ``name`` as a function of its inputs, which it moves
        to the device (a no-op on the captured programs' fixed inputs); its
        answer is f32 whatever the model's compute dtype."""
        model = self.predictor.model
        fn = {
            "encode": lambda x: model.encode(x)[0],
            "decode": model.decode,
            "recon": lambda x: model.decode(model.encode(x)[0]),
            "trajectory": self._trajectory,
        }[name]
        return lambda *inputs: fn(*(x.to(self.device) for x in inputs)).float()

    def _trajectory(self, obs, obs_mask, obs_lab, query_lab) -> torch.Tensor:
        """Encode the K subjects' observed frames ``obs [K·t_obs, ...]``,
        extend the basis by them and decode the posterior latents at the
        queries: frames ``[K·n_query, ...]``."""
        pr = self.predictor
        k, t_obs, n_query = self.k_subjects, self.t_obs, self.n_query
        mu_obs = pr.model.encode(obs)[0].float()  # the GP algebra runs in f32
        ones_q = torch.ones((k, n_query), dtype=torch.float32, device=obs.device)
        z_pred = gp_predict_extend_batch(
            pr.spec0, pr.spec1, pr.gp_params.kp0, pr.gp_params.kp1, pr.noise,
            self._basis, obs_lab, obs_mask, mu_obs.reshape(k, t_obs, -1),
            query_lab, ones_q, pr.z,
        )
        return pr.model.decode(z_pred.reshape(k * n_query, -1))

    def _capture(self, name: str, *shapes) -> None:
        """On the card, capture the program ``name`` over fixed inputs of
        ``shapes`` (its warm-up runs on zeros); on the CPU nothing."""
        if self.device.type == "cuda":
            inputs = [torch.zeros(shape, dtype=torch.float32, device=self.device)
                      for shape in shapes]
            self._graphs.capture(name, self._program(name), inputs)

    def _capture_trajectory(self) -> None:
        k, t_obs, n_query = self.k_subjects, self.t_obs, self.n_query
        q = self.predictor.basis_labels.shape[1]
        self._capture("trajectory", (k * t_obs,) + self._in_shape[1:], (k, t_obs),
                      (k, t_obs, q), (k, n_query, q))

    def _call(self, name: str, *inputs: torch.Tensor) -> torch.Tensor:
        """The program ``name`` on ``inputs`` (host or device tensors of its
        fixed shapes): on the card a replay of its graph, whose output the
        next replay overwrites; on the CPU the eager program."""
        return self._graphs.run(name, self._program(name), inputs,
                                eager=steps_eagerly(self.device))

    def for_k_subjects(self, k_subjects: int) -> "CompiledServing":
        """A sibling bundle serving ``k_subjects``-sized requests: it shares
        this bundle's encode, decode and recon programs and captures only
        its own trajectory program, over a copy of the folded cohort basis
        (a later :meth:`refresh_basis` of either bundle leaves the other's
        basis as it is)."""
        if self.t_obs is None or self.n_query is None:
            raise ValueError(
                "bundle built without trajectory support: pass "
                "t_obs/n_query to aot_compile"
            )
        sib = copy.copy(self)
        sib.k_subjects = int(k_subjects)
        sib._basis = PredictBasis(*(t.clone() for t in self._basis))
        sib._graphs = StepGraphs(self._graphs.pool, inference=True)
        sib._graphs.update((name, g) for name, g in self._graphs.items() if name != "trajectory")
        sib._capture_trajectory()
        return sib

    def _blocks_on_device(self, labels, mu):
        """Flat labels/latents → padded subject blocks on the device."""
        pr = self.predictor
        labels = np.asarray(labels, np.float32)
        blocks = build_subject_blocks(labels, pr.id_covariate)
        xb = labels[blocks.index] * blocks.mask[..., None]
        mu_b = np.asarray(mu, np.float32)[blocks.index] * blocks.mask[..., None]
        dev = self.device
        return _f32(xb, dev), _f32(blocks.mask, dev), _f32(mu_b, dev)

    def _fold_basis(self) -> None:
        """Fold the whole basis cohort's block solves into ``(H, c)``, the
        bundle's basis buffers: the fold program (``ops/predict.fold_basis``),
        on the card a replay of its graph at the cohort's ``[P, T]``, which
        a later ``aot_compile`` of the same shapes replays again."""
        pr = self.predictor
        xb, mask, mu_b = self._blocks_on_device(pr.basis_labels, pr.basis_mu)
        self._basis = fold_basis(pr.spec0, pr.spec1, pr.gp_params.kp0, pr.gp_params.kp1,
                                 pr.noise, xb, mask, mu_b, pr.z, eps=pr.eps)

    @torch.inference_mode()
    def refresh_basis(self, new_data, new_labels) -> None:
        """Fold new TRAINING subjects into the serving basis, in place.

        ``(H, c)`` are sums over subject blocks, so the new subjects' blocks
        are encoded and added incrementally (equal to a full refold) by the
        extension program (``ops/predict.extend_basis``, on the card a
        replay at the new subjects' ``[K, T]``, which takes the basis as an
        input), and the sums are copied into this bundle's basis buffers,
        which its captured trajectory program reads. ``new_labels`` must
        carry subject ids not already in the basis; once folded, a subject
        is a training subject — do not send it as new in a request. Sibling
        bundles hold their own basis.
        """
        pr = self.predictor
        new_labels = np.asarray(new_labels, np.float32)
        known = set(np.asarray(pr.basis_labels)[:, pr.id_covariate].tolist())
        dup = sorted({float(s) for s in new_labels[:, pr.id_covariate]} & known)
        if dup:
            raise ValueError(
                f"refresh_basis: subject ids {dup[:5]} are already in the "
                "basis — folding them again would double-count their blocks"
            )
        mu_new = self.encode(new_data)[: new_labels.shape[0]]
        xb, mask, mu_b = self._blocks_on_device(new_labels, mu_new)
        grown = extend_basis(pr.spec0, pr.spec1, pr.gp_params.kp0, pr.gp_params.kp1, pr.noise,
                             self._basis, xb, mask, mu_b, pr.z)
        for fixed, value in zip(self._basis, grown):
            fixed.copy_(value)
        # keep this bundle's predictor view consistent with the grown basis
        # (the replaced predictor holds the same model and GP tensors, which
        # the captured programs read)
        self.predictor = dataclasses.replace(
            pr,
            basis_labels=np.concatenate([pr.basis_labels, new_labels]),
            basis_mu=np.concatenate([pr.basis_mu, np.asarray(mu_new, pr.basis_mu.dtype)]),
        )

    @torch.inference_mode()
    def predict_trajectories(
        self, observed_data, observed_labels, query_labels, observed_mask=None
    ) -> np.ndarray:
        """K-subject batch trajectory prediction.

        ``observed_data [K, t_obs, ...]`` / ``observed_labels [K, t_obs, Q]``
        — each row one NEW subject's observed frames; ``query_labels
        [K, n_query, Q]`` — queries for that subject (or a data-free row:
        zero ``observed_mask`` → population mean). Returns decoded frames
        ``[K, n_query, ...]``.
        """
        if self._basis is None:
            raise ValueError(
                "bundle built without trajectory support: pass t_obs/n_query "
                "to aot_compile"
            )
        k, t_obs, n_query = self.k_subjects, self.t_obs, self.n_query
        frame = self._in_shape[1:]
        if observed_mask is None:
            observed_mask = np.ones((k, t_obs), np.float32)
        inputs = (np.reshape(observed_data, (k * t_obs,) + frame),
                  np.reshape(observed_mask, (k, t_obs)),
                  np.reshape(observed_labels, (k, t_obs, -1)),
                  np.reshape(query_labels, (k, n_query, -1)))
        out = self._call("trajectory", *(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                                         for a in inputs))
        return out.reshape((k, n_query) + frame).cpu().numpy()

    def predict_trajectory(self, observed_data, observed_labels, query_labels) -> np.ndarray:
        """Single-subject trajectory prediction; with a K>1 bundle the
        request is padded with data-free ghost subjects."""
        k = self.k_subjects
        q = self.predictor.basis_labels.shape[1]
        frame = self._in_shape[1:]
        obs = np.zeros((k, self.t_obs) + frame, np.float32)
        obs[0] = np.asarray(observed_data, np.float32).reshape((self.t_obs,) + frame)
        labs = np.zeros((k, self.t_obs, q), np.float32)
        labs[0] = np.asarray(observed_labels, np.float32)
        queries = np.zeros((k, self.n_query, q), np.float32)
        queries[0] = np.asarray(query_labels, np.float32)
        mask = np.zeros((k, self.t_obs), np.float32)
        mask[0] = 1.0
        return self.predict_trajectories(obs, labs, queries, observed_mask=mask)[0]

    def _check_seq_rows(self, n: int) -> None:
        if self.seq_len and n % self.seq_len:
            raise ValueError(
                f"RNN serving needs subject-major requests with N divisible "
                f"by T={self.seq_len}; got N={n} (a partial subject would be "
                f"zero-padded into its own recurrence)"
            )

    @torch.inference_mode()
    def _chunked(self, name: str, x: np.ndarray) -> np.ndarray:
        """The program ``name`` over the rows of ``x`` in zero-padded chunks
        of ``batch_size``: the request is staged once in host memory (pinned
        on the card), each chunk copied into the program's fixed input, and
        each output copied out before the next call."""
        n, b = x.shape[0], self.batch_size
        chunks = max(1, -(-n // b))
        host = torch.zeros((chunks * b,) + x.shape[1:], dtype=torch.float32,
                           pin_memory=self.device.type == "cuda")
        host[:n] = torch.from_numpy(x)
        out = None
        for i in range(chunks):
            y = self._call(name, host[i * b:(i + 1) * b])
            if out is None:
                out = y.new_empty((chunks * b,) + tuple(y.shape[1:]))
            out[i * b:(i + 1) * b].copy_(y)
        return out[:n].cpu().numpy()

    def encode(self, data) -> np.ndarray:
        data = np.asarray(data, np.float32).reshape((-1,) + self._in_shape[1:])
        self._check_seq_rows(data.shape[0])
        return self._chunked("encode", data)

    def decode(self, latents) -> np.ndarray:
        return self._chunked("decode", np.asarray(latents, np.float32))

    def impute(self, data, mask=None) -> np.ndarray:
        data = np.asarray(data, np.float32).reshape((-1,) + self._in_shape[1:])
        self._check_seq_rows(data.shape[0])
        recon = self._chunked("recon", data)
        if mask is None:
            return recon
        mask = np.asarray(mask, np.float32).reshape(recon.shape)
        return data.reshape(recon.shape) * mask + recon * (1.0 - mask)

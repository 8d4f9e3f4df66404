"""Serving-side inference API (port of lvae_tpu.inference).

Packages a trained L-VAE into a predictor for three capabilities:

* :meth:`LVAEPredictor.impute` — reconstruct missing pixels of observed
  frames;
* :meth:`LVAEPredictor.predict_trajectory` — given observed frames of a
  subject (even one never seen in training), predict its frames at
  arbitrary query covariates;
* :meth:`LVAEPredictor.encode` / :meth:`decode` — raw latent access.

:meth:`LVAEPredictor.aot_compile` builds a :class:`CompiledServing` bundle
with a fixed batch shape and a pre-folded GP basis. PyTorch runs eagerly, so
the bundle compiles nothing: it keeps the JAX package's name so that each
entry point has its counterpart. Everything runs on ``device``, ``cuda``
unless the caller passes ``"cpu"``; arrays cross the API as host numpy.
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
from lvae_torch.ops import kernels as kx
from lvae_torch.ops.predict import (
    extend_predict_basis,
    gp_predict_extend_batch,
    precompute_predict_basis,
    predict_latents,
)
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
    ``device`` as float32, and the model is put in ``eval()`` mode.
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
        mu, _ = encode_dataset(model, pipeline.dataset.data, device=pipeline.device)
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
        self._basis = None
        if t_obs is not None and n_query is not None:
            self._fold_basis()

    @property
    def device(self) -> torch.device:
        return self.predictor.device

    def for_k_subjects(self, k_subjects: int) -> "CompiledServing":
        """A sibling bundle serving ``k_subjects``-sized requests; it shares
        this bundle's folded cohort basis."""
        if self.t_obs is None or self.n_query is None:
            raise ValueError(
                "bundle built without trajectory support: pass "
                "t_obs/n_query to aot_compile"
            )
        sib = copy.copy(self)
        sib.k_subjects = int(k_subjects)
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

    @torch.inference_mode()
    def _fold_basis(self) -> None:
        """Fold the whole basis cohort's block solves into ``(H, c)``."""
        pr = self.predictor
        xb, mask, mu_b = self._blocks_on_device(pr.basis_labels, pr.basis_mu)
        self._basis = precompute_predict_basis(
            pr.spec0, pr.spec1, pr.gp_params.kp0, pr.gp_params.kp1, pr.noise,
            xb, mask, mu_b, pr.z, eps=pr.eps,
        )

    @torch.inference_mode()
    def refresh_basis(self, new_data, new_labels) -> None:
        """Fold new TRAINING subjects into the serving basis, in place.

        ``(H, c)`` are sums over subject blocks, so the new subjects' blocks
        are encoded and added incrementally (equal to a full refold).
        ``new_labels`` must carry subject ids not already in the basis; once
        folded, a subject is a training subject — do not send it as new in a
        request. Sibling bundles hold their own basis reference.
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
        self._basis = extend_predict_basis(
            pr.spec0, pr.spec1, pr.gp_params.kp0, pr.gp_params.kp1, pr.noise,
            self._basis, xb, mask, mu_b, pr.z,
        )
        # keep this bundle's predictor view consistent with the grown basis
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
        pr = self.predictor
        dev = self.device
        k, t_obs, n_query = self.k_subjects, self.t_obs, self.n_query
        frame = self._in_shape[1:]
        obs = _f32(np.asarray(observed_data, np.float32).reshape((k * t_obs,) + frame), dev)
        if observed_mask is None:
            observed_mask = np.ones((k, t_obs), np.float32)
        obs_mask = _f32(observed_mask, dev)
        obs_lab = _f32(np.asarray(observed_labels, np.float32).reshape(k, t_obs, -1), dev)
        query_lab = _f32(np.asarray(query_labels, np.float32).reshape(k, n_query, -1), dev)

        mu_obs, _ = pr.model.encode(obs)
        ones_q = torch.ones((k, n_query), dtype=torch.float32, device=dev)
        z_pred = gp_predict_extend_batch(
            pr.spec0, pr.spec1, pr.gp_params.kp0, pr.gp_params.kp1, pr.noise,
            self._basis, obs_lab, obs_mask, mu_obs.reshape(k, t_obs, -1),
            query_lab, ones_q, pr.z,
        )
        out = pr.model.decode(z_pred.reshape(k * n_query, -1))
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

    @torch.inference_mode()
    def _chunked(self, fn, x: np.ndarray) -> np.ndarray:
        n, b = x.shape[0], self.batch_size
        dev = self.device
        outs = []
        for i in range(0, max(n, 1), b):
            chunk = x[i : i + b]
            pad = b - chunk.shape[0]
            if pad:
                chunk = np.concatenate([chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
            out = fn(_f32(chunk, dev))
            outs.append(out[: b - pad] if pad else out)
        return torch.cat(outs).cpu().numpy()

    def encode(self, data) -> np.ndarray:
        data = np.asarray(data, np.float32).reshape((-1,) + self._in_shape[1:])
        return self._chunked(lambda x: self.predictor.model.encode(x)[0], data)

    def decode(self, latents) -> np.ndarray:
        return self._chunked(self.predictor.model.decode, np.asarray(latents, np.float32))

    def impute(self, data, mask=None) -> np.ndarray:
        data = np.asarray(data, np.float32).reshape((-1,) + self._in_shape[1:])
        model = self.predictor.model
        recon = self._chunked(lambda x: model.decode(model.encode(x)[0]), data)
        if mask is None:
            return recon
        mask = np.asarray(mask, np.float32).reshape(recon.shape)
        return data.reshape(recon.shape) * mask + recon * (1.0 - mask)

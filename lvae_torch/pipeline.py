"""End-to-end L-VAE pipeline (port of lvae_tpu.pipeline).

Wires config → data → model → GP prior → training regime → artefacts →
validation → test MSE → image generation, the programmatic equivalent of
the reference's ``LVAE.py``, on one device (``cuda`` unless the caller asks
for the CPU) or, with ``--data_mesh``/``--latent_mesh`` above 1, on a mesh
of ranks (one process each, ``torchrun``; ``parallel/``).

Regimes ported: Hensman SVI, the standard full-batch ones (closed,
GPapprox, GPapprox_closed, GPPVAE with ``mini_batch``) and the VI regime
(``variational_inference_training``, :meth:`LVAEPipeline.run_vi`), with the
ConvVAE, SimpleVAE and RNN encoders. A Hensman run also writes the
reference's GP resume files (``utils/torch_compat.py``). On a mesh the
trainers are the sharded ones (GPPVAE stays in one process, with a
warning), the sparse-GP tests run mesh-parallel, and rank 0 writes every
file while the other ranks wait; a checkpoint holds the whole state.
``model_dtype=bfloat16`` (or ``''`` with ``LVAE_MODEL_BF16=1``) runs the
VAE's layers in bf16 with f32 parameters, losses and GP algebra
(``models/vae.py``); ``dtype=bfloat16``, the GP algebra in bf16, raises
``NotImplementedError`` naming ROADMAP item 13. Every checkpoint goes
through the configured ``checkpoint_backend`` (``utils/checkpoint.py``: a
file, a directory, or a directory written in the background while
training goes on); a resume reads either form.
"""

from __future__ import annotations

import math
import os
import pickle
import time
from typing import Optional

import numpy as np
import torch

from lvae_torch.config import LVAEConfig
from lvae_torch.data.blocks import build_subject_blocks
from lvae_torch.data.datasets import load_dataset
from lvae_torch.evaluation.encode import encode_dataset
from lvae_torch.evaluation.generation import recon_complete_gen
from lvae_torch.evaluation.programs import dataset_tensor
from lvae_torch.evaluation.testing import mse_test_exact, mse_test_gp_approx
from lvae_torch.evaluation.validate import validate
from lvae_torch.parallel import mesh as pm
from lvae_torch.parallel.distributed import initialize_distributed
from lvae_torch.models.vae import auto_model_dtype, make_vae
from lvae_torch.ops import kernels as kx
from lvae_torch.train import state as st
from lvae_torch.train.hensman import HensmanConfig, HensmanTrainer
from lvae_torch.train.standard import StandardConfig, StandardTrainer
from lvae_torch.train.vi import VIConfig, VITrainer
from lvae_torch.utils.checkpoint import (
    read_checkpoint, save_checkpoint, save_checkpoint_async, save_checkpoint_dir,
    try_load_checkpoint, vae_state_dict, wait_for_async_saves,
)
from lvae_torch.utils.device import resolve_device
from lvae_torch.utils.metrics import RECORDER, MetricsLogger, device_memory_stats, span
from lvae_torch.utils.torch_compat import save_reference_gp_state

DTYPES = {"float32": torch.float32, "float64": torch.float64}
MODEL_DTYPES = {**DTYPES, "bfloat16": torch.bfloat16}


def check_ported(cfg) -> None:
    """Raise ``NotImplementedError`` for a configuration the port does not
    run, naming the ROADMAP item that says why."""
    waiting = []
    if getattr(cfg, "dtype", "") == "bfloat16":
        waiting.append("dtype=bfloat16: the GP algebra runs at f32 or wider, as in the JAX "
                       "package, whose kernels take f32 only (ROADMAP queue 1 item 13); "
                       "model_dtype=bfloat16 runs the VAE in bf16")
    if waiting:
        raise NotImplementedError("not ported to lvae_torch: " + "; ".join(waiting))


def profile_line(summary: dict) -> str:
    """One line of a profiled run's phases (median device ms a step of the
    captured step's last replay, sampled at each chunk's read) and spans
    (count and total seconds)."""
    phases = " ".join(f"{k} {v:.3f}" for k, v in summary["phase_ms"].items()) or "not marked"
    spans = " ".join(f"{k} {v['total_s']:.3f} s ({v['count']})"
                     for k, v in sorted(summary["spans"].items()))
    return f"Profile phases (median ms a step): {phases}; spans (total): {spans or 'none'}"


def reference_vae_state_dict(sd: dict) -> dict:
    """The reference's torch VAE ``state_dict`` (``.pth``) as the port's:
    the layer names match, the observation noise ``_log_vy`` becomes
    ``raw_log_vy``."""
    return {("raw_log_vy" if k == "_log_vy" else k): v for k, v in sd.items()}


class LVAEPipeline:
    """Build-and-run harness for one L-VAE experiment on ``device``."""

    def __init__(self, cfg: LVAEConfig, datasets: Optional[dict] = None, device="cuda"):
        cfg.validate()
        check_ported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = None
        if cfg.data_mesh * cfg.latent_mesh > 1:
            # one process per rank: the group from torchrun's environment;
            # a world of another size raises ValueError
            initialize_distributed(device=self.device)
            self.mesh = pm.make_mesh(cfg.data_mesh, cfg.latent_mesh, device=self.device)
            self.device = self.mesh.device
        self.dtype = DTYPES[cfg.dtype]
        ds = datasets or {}

        def given_or(name, loader):
            # None-check, not truthiness: a dataset passed in is never
            # swapped for the configured files
            got = ds.get(name)
            return got if got is not None else loader()

        self.dataset = given_or("train", lambda: load_dataset(cfg, "train"))
        if self.dataset is None:
            raise ValueError("No training dataset configured")
        want_pred = cfg.run_tests or cfg.generate_images or cfg.variational_inference_training
        self.prediction_dataset = given_or(
            "prediction", lambda: load_dataset(cfg, "prediction") if want_pred else None)
        self.generation_dataset = given_or(
            "generation", lambda: load_dataset(cfg, "generation") if cfg.generate_images else None)
        self.validation_dataset = given_or(
            "validation", lambda: load_dataset(cfg, "validation") if cfg.run_validation else None)
        self.test_dataset = given_or(
            "test", lambda: load_dataset(cfg, "test") if cfg.run_tests else None)
        will_test = cfg.run_tests and self.test_dataset is not None
        will_gen = cfg.generate_images and self.generation_dataset is not None
        if (will_test or will_gen) and self.prediction_dataset is None \
                and not cfg.variational_inference_training:
            # tests and generation regress on the prediction cohort: fail
            # here, not in the best-model callback mid-training
            raise ValueError(
                "run_tests/generate_images need a prediction cohort: pass "
                "datasets['prediction'] or set csv_file_prediction_data/"
                "prediction_mask_file"
            )
        print(f"Length of dataset:  {len(self.dataset)}")
        if not len(self.dataset):
            raise ValueError("Dataset is empty")

        self.num_dim = cfg.num_dim or self.dataset.num_dim
        self.q = self.dataset.num_covariates
        # '' = auto (models/vae.auto_model_dtype: the GP dtype unless
        # LVAE_MODEL_BF16=1); bfloat16 computes in bf16 over parameters in
        # the GP dtype
        model_dtype = (MODEL_DTYPES[cfg.model_dtype] if cfg.model_dtype
                       else auto_model_dtype(self.dtype))
        bf16 = model_dtype == torch.bfloat16
        self.model = make_vae(
            cfg.type_nnet, cfg.latent_dim, self.num_dim, vy_init=cfg.vy_init,
            dropout=cfg.dropout, dropout_input=cfg.dropout_input,
            generator=torch.Generator().manual_seed(cfg.seed),
            dtype=self.dtype if bf16 else model_dtype,
            T=cfg.T or None, hidden_dim=cfg.hidden_dim, type_rnn=cfg.type_rnn,
            compute_dtype=torch.bfloat16 if bf16 else None,
        )
        self.spec0, self.spec1 = kx.split_kernel_spec(
            id_covariate=cfg.id_covariate, **cfg.kernel_spec_kwargs()
        )
        self.blocks = build_subject_blocks(self.dataset.labels, cfg.id_covariate)
        self.metrics = MetricsLogger((cfg.results_path or cfg.save_path) if self.writer else None)
        self.trainer = None
        self.best = {"val": np.inf, "epoch": 0}

    @property
    def out_dir(self) -> str:
        return self.cfg.results_path or self.cfg.save_path

    @property
    def writer(self) -> bool:
        """Whether this process writes the run's files: rank 0 of a mesh."""
        return self.mesh is None or self.mesh.writer

    def _save(self, path: str, state, metadata=None) -> None:
        """A checkpoint of the whole state, written by rank 0 while the
        other ranks wait (with ``orbax_async``, until rank 0 has started
        the write: :meth:`_settle` waits for its commit)."""
        with span("lvae.pipeline.checkpoint"):
            if self.writer:
                self._save_ckpt(path, state, metadata=metadata)
            self._barrier()

    def _save_ckpt(self, path: str, state, metadata=None) -> None:
        """Write through the configured backend: a file (``pickle``), a
        directory (``orbax``), or a directory written in the background
        (``orbax_async``)."""
        backend = self.cfg.checkpoint_backend
        if backend == "orbax_async":
            save_checkpoint_async(path, state, metadata=metadata)
        elif backend == "orbax":
            save_checkpoint_dir(path, state, metadata=metadata)
        else:
            save_checkpoint(path, state, metadata=metadata)

    def _settle(self) -> None:
        """Wait for rank 0's background save in flight, then for every rank:
        after it, every rank reads committed checkpoints."""
        wait_for_async_saves()
        self._barrier()

    def _barrier(self) -> None:
        if self.mesh is not None:
            self.mesh.barrier()

    def _agree(self, value: float) -> float:
        """Rank 0's ``value``: a decision every rank follows alike."""
        return value if self.mesh is None else self.mesh.agree(value)

    # ---------------------------------------------------------------- setup
    def _load_pretrained_vae(self, vae) -> None:
        """Seed the VAE module ``vae`` from ``cfg.model_params``: a port
        checkpoint (``.ckpt``) or the reference's torch ``state_dict``
        (``.pth``)."""
        sd = self._pretrained_vae_state_dict()
        if sd is None:
            print("Did not load pre-trained values.")
            return
        try:
            vae.load_state_dict(sd)
            print("Loaded pre-trained values.")
        except Exception as e:  # noqa: BLE001
            print(f"Did not load pre-trained values: {e}")

    def _pretrained_vae_state_dict(self) -> Optional[dict]:
        path = self.cfg.model_params
        if not (path and os.path.exists(path)):
            return None
        try:
            if path.endswith(".pth"):
                sd = torch.load(path, map_location="cpu", weights_only=True)
                return reference_vae_state_dict(sd)
            return vae_state_dict(read_checkpoint(path))
        except Exception as e:  # noqa: BLE001 — unreadable → train from scratch
            print(f"pre-trained VAE {path} not readable: {e}")
            return None

    def build_trainer(self):
        cfg = self.cfg
        z = st.init_inducing_points(self.dataset.labels, cfg.M, seed=cfg.seed, dtype=np.float32)
        if cfg.hensman:
            hcfg = HensmanConfig(
                spec0=self.spec0, spec1=self.spec1, latent_dim=cfg.latent_dim,
                P_tot=self.blocks.num_subjects, N_tot=len(self.dataset),
                weight=cfg.weight, loss_function=cfg.loss_function,
                natural_gradient=cfg.natural_gradient,
                natural_gradient_lr=cfg.natural_gradient_lr,
                constrain_scales=cfg.constrain_scales, eps=cfg.eps,
                dropout=cfg.dropout > 0, vy_fixed=cfg.vy_fixed,
                learn_inducing=cfg.learn_inducing,
            )
            self.trainer = HensmanTrainer(
                self.model, hcfg, self.dataset, self.blocks, z,
                subjects_per_batch=cfg.subjects_per_batch,
                learning_rate=cfg.learning_rate, seed=cfg.seed, dtype=self.dtype,
                t_buckets=cfg.T_buckets, device=self.device,
            )
            if self.mesh is not None:
                self.trainer = pm.ShardedHensmanTrainer(self.trainer, self.mesh)
        elif cfg.variational_inference_training:
            raise RuntimeError("the VI regime has no amortised trainer; run() routes it "
                               "through run_vi()")
        else:
            scfg = StandardConfig(
                spec0=self.spec0, spec1=self.spec1, latent_dim=cfg.latent_dim,
                P_tot=self.blocks.num_subjects, T=self.blocks.t_max,
                weight=cfg.weight, loss_function=cfg.loss_function,
                type_KL=cfg.type_KL, num_samples=cfg.num_samples,
                constrain_scales=cfg.constrain_scales, eps=cfg.eps,
                dropout=cfg.dropout > 0, vy_fixed=cfg.vy_fixed,
            )
            self.trainer = StandardTrainer(
                self.model, scfg, self.dataset, self.blocks, z,
                learning_rate=cfg.learning_rate, seed=cfg.seed, dtype=self.dtype,
                pseudo_minibatch=cfg.mini_batch, device=self.device,
            )
            if self.mesh is not None:
                if cfg.mini_batch:
                    print("WARNING: --data_mesh/--latent_mesh are ignored with "
                          "mini_batch=True (the GPPVAE pseudo-minibatch regime "
                          "exists to bound memory); every rank trains it whole")
                else:
                    self.trainer = pm.ShardedStandardTrainer(self.trainer, self.mesh)
        self._load_pretrained_vae(self.trainer.state.trainables.vae)
        self._try_resume(self.trainer)
        return self.trainer

    def _try_resume(self, trainer) -> None:
        """Resume the whole training state from ``cfg.gp_model_folder``
        (``model_final.ckpt``, else ``model_best.ckpt``) when it holds one."""
        folder = self.cfg.gp_model_folder
        if not folder:
            return
        for name in ("model_final.ckpt", "model_best.ckpt"):
            path = os.path.join(folder, name)
            state = try_load_checkpoint(path, like=trainer.state)
            if state is not None:
                trainer.state = state
                print(f"Loaded GP models (resumed from {path})")
                return
        print("GP model loading failed!")

    # -------------------------------------------------------------- training
    def _epoch_callback(self, trainer, epoch, metrics):
        """Per-chunk housekeeping: one metrics record per epoch, the
        non-finite guard and rollback, the ``checkpoint_every`` snapshot,
        ``debug_nans``, and every ``test_freq`` epochs validation with
        best-model checkpoint, tests and generation."""
        cfg = self.cfg
        hist = getattr(trainer, "history", None) or []
        start = getattr(self, "_metrics_logged", 0)
        fresh = hist[start:]
        last = os.path.join(self.out_dir, "model_last.ckpt")
        if cfg.auto_recover and not self._agree(bool(st.tree_finite(trainer.state.trainables))):
            # recover before logging: the chunk is replayed, so its epochs
            # must not enter metrics.jsonl or diagnostics.pkl
            self._recover(trainer, epoch, last)
            if fresh:
                del trainer.history[start:]
            return "rollback"
        with span("lvae.pipeline.log"):
            if fresh:
                base = epoch - len(fresh)
                for i, m in enumerate(fresh):
                    self.metrics.log(base + i + 1, m._asdict())
                self._metrics_logged = len(hist)
            else:
                self.metrics.log(epoch, metrics._asdict())
        if cfg.auto_recover or (cfg.checkpoint_every > 0 and epoch % cfg.checkpoint_every == 0):
            # the rolling known-good snapshot (auto_recover: every chunk,
            # finiteness checked above), else the flag's cadence
            self._save(last, trainer.state, metadata={"epoch": epoch})
        if cfg.debug_nans:
            from lvae_torch.utils.debug import assert_state_finite

            assert_state_finite(trainer.state.trainables, where=f"epoch {epoch}")
        if self.validation_dataset is None:
            return None
        if cfg.test_freq <= 0 or epoch % cfg.test_freq != 0:
            return None
        with span("lvae.pipeline.validate"):
            model, gp_params, noise = self.current_params()
            res = validate(
                model, gp_params, noise, self.spec0, self.spec1, self.validation_dataset,
                trainer.tdata.z, cfg.id_covariate, cfg.weight, cfg.loss_function,
                cfg.latent_dim, cfg.eps, type_kl=cfg.type_KL, num_samples=cfg.num_samples,
                device=self.device,
            )
            val = self._agree(res.net)
            if val < self.best["val"]:
                self.best = {"val": val, "epoch": epoch}
                print("Saving better model")
                self._save(os.path.join(self.out_dir, "model_best.ckpt"), trainer.state,
                           metadata={"epoch": epoch, "val": val})
                run_tests = cfg.run_tests and self.test_dataset is not None
                gen = cfg.generate_images and self.generation_dataset is not None
                pred = self.encode_prediction_cohort() if (run_tests or gen) else None
                if run_tests:
                    self._run_tests(save_file="result_error_best.csv", pred=pred)
                if gen and self.writer:
                    self._generate(pred, epoch)
        return None

    def _recover(self, trainer, epoch, last_path: str) -> None:
        """Non-finite training state → reload the rolling known-good
        snapshot and reseed the generator, so that the replayed stretch
        takes another sample path. Gives up after 3 attempts."""
        self.recoveries = getattr(self, "recoveries", 0) + 1
        if self.recoveries > 3:
            raise FloatingPointError(
                f"state non-finite at epoch {epoch}; giving up after "
                f"{self.recoveries - 1} recoveries"
            )
        self._settle()  # the rolling snapshot may still be in flight
        state = try_load_checkpoint(last_path, like=trainer.state)
        if state is None:
            raise FloatingPointError(
                f"state non-finite at epoch {epoch} and no recovery checkpoint at {last_path}"
            )
        seed = int(torch.randint(0, 2**62, (1,), generator=state.rng))
        state.rng.manual_seed(seed + self.recoveries)
        trainer.state = state
        print(
            f"Recovered from non-finite state at epoch {epoch} "
            f"(attempt {self.recoveries}; resumed from {last_path})",
            flush=True,
        )

    def train(self):
        """Fit ``cfg.epochs`` epochs in chunks of gcd(checkpoint_every,
        test_freq) epochs, so that the callback sees every checkpoint and
        validation epoch; with ``cfg.profile`` under ``torch.profiler``,
        writing a Chrome trace to ``<results>/profile/trace.json`` (the
        program's spans and the eager steps' phases among its ranges) and
        printing each captured phase's median device ms a step and each
        span's total."""
        if self.trainer is None:
            self.build_trainer()
        cfg = self.cfg
        start = time.perf_counter()
        chunk = max(1, int(cfg.checkpoint_every or 0))
        if cfg.test_freq and cfg.test_freq > 0:
            chunk = math.gcd(chunk, int(cfg.test_freq))
        fit_kwargs = dict(log_every=1, callback=self._epoch_callback, chunk=chunk)
        if cfg.profile:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            since = time.time_ns()
            with profile(activities=acts) as prof:
                self.trainer.fit(cfg.epochs, **fit_kwargs)
            trace = os.path.join(self.out_dir, "profile", "trace.json")
            os.makedirs(os.path.dirname(trace), exist_ok=True)
            prof.export_chrome_trace(trace)
            print(f"Profile written to {trace}")
            print(profile_line(RECORDER.summary(since)))
        else:
            self.trainer.fit(cfg.epochs, **fit_kwargs)
        print(f"Duration of training: {time.perf_counter() - start:.2f} seconds")
        if cfg.memory_dbg:
            print(f"Device memory: {device_memory_stats()}")
        return self.trainer.history

    # --------------------------------------------------------------- params
    def current_params(self):
        """(the VAE module, the GP hyperparameters, the constrained noise
        ``[L]``), the noise pinned to 1 under ``constrain_scales``."""
        tr = self.trainer.state.trainables
        raw = tr.gp.raw_noise.detach()
        noise = torch.ones_like(raw) if self.cfg.constrain_scales else kx.constrain(raw)
        return tr.vae, tr.gp, noise

    def encode_prediction_cohort(self):
        """The prediction cohort's labels and latent means: its frames move
        to the device once, then the encode program runs on them."""
        ds = self.prediction_dataset
        data = dataset_tensor(ds.data, self.model.raw_log_vy.dtype, self.device)
        mu, _ = encode_dataset(self.model, data, device=self.device)
        return ds.labels, mu

    # ------------------------------------------------------------ evaluation
    def _run_tests(self, save_file: str = "result_error.csv", pred=None):
        cfg = self.cfg
        model, gp_params, noise = self.current_params()
        prediction_x, prediction_mu = pred or self.encode_prediction_cohort()
        out = self.out_dir if self.writer else None
        if cfg.type_KL in ("GPapprox", "GPapprox_closed"):
            return mse_test_gp_approx(
                model, gp_params, noise, self.spec0, self.spec1, self.test_dataset,
                prediction_x, prediction_mu, self.trainer.tdata.z, cfg.id_covariate, cfg.eps,
                results_path=out, save_file=save_file, device=self.device,
                # a mesh run's posterior runs mesh-parallel
                mesh=self.mesh,
            )
        spec_full, kp_full = kx.join_specs(self.spec0, self.spec1, gp_params.kp0, gp_params.kp1)
        return mse_test_exact(
            model, kp_full, spec_full, noise, self.test_dataset, prediction_x, prediction_mu,
            cfg.eps, results_path=out, save_file=save_file, device=self.device,
        )

    def _generate(self, pred, epoch: int) -> str:
        model, gp_params, noise = self.current_params()
        prediction_x, prediction_mu = pred
        return recon_complete_gen(
            self.generation_dataset, model, gp_params, noise, self.spec0, self.spec1,
            prediction_x, prediction_mu, self.trainer.tdata.z, self.cfg.id_covariate,
            self.out_dir, epoch=epoch, eps=self.cfg.eps, device=self.device,
        )

    def save_artifacts(self):
        """Final artefacts in ``cfg.save_path``: ``diagnostics.pkl`` (the
        per-epoch metrics as a list of dicts), ``plot_values.pkl``
        (``[labels, mu, log_var, z sample, row index]`` of the final model
        on the training cohort) and ``model_final.ckpt``; on a mesh, rank 0
        writes them while the other ranks wait. Every checkpoint is
        committed when it returns."""
        if self.writer:
            self._write_artifacts()
        self._settle()

    def _write_artifacts(self) -> None:
        cfg = self.cfg
        out = cfg.save_path
        os.makedirs(out, exist_ok=True)
        if self.best["epoch"]:
            print("Best results in epoch: " + str(self.best["epoch"]))
        with open(os.path.join(out, "diagnostics.pkl"), "wb") as f:
            pickle.dump([m._asdict() for m in self.trainer.history], f)
        mu, log_var = encode_dataset(self.model, self.dataset.data, device=self.device)
        noise = torch.randn(mu.shape, generator=torch.Generator().manual_seed(cfg.seed),
                            dtype=torch.from_numpy(mu[:0]).dtype).numpy()
        z_sample = mu + noise * np.exp(0.5 * log_var)
        with open(os.path.join(out, "plot_values.pkl"), "wb") as f:
            pickle.dump([np.asarray(self.dataset.labels), mu, log_var, z_sample,
                         np.arange(len(self.dataset))], f)
        self._save_ckpt(os.path.join(out, "model_final.ckpt"), self.trainer.state)
        if cfg.hensman:
            # the reference's GP resume files (gp_model.pth, zt_list.pth,
            # m.pth, H.pth), so that the GP resumes in the reference
            state = self.trainer.state
            tr = state.trainables
            if state.m_nat is not None:
                m_out, h_out = state.m_nat, state.H_nat
            else:
                m_out, h_out = tr.m, st.psd_from_factor(tr.h_factor)
            save_reference_gp_state(
                out, tr.gp, self.trainer.tdata.z, m_out, h_out, latent_dim=cfg.latent_dim,
                constrain_scales=cfg.constrain_scales, id_covariate=cfg.id_covariate,
                **cfg.kernel_spec_kwargs(),
            )
        self.metrics.flush()

    def build_vi_trainer(self) -> VITrainer:
        """The VI regime's trainer: the pre-trained VAE (or the fresh one),
        the initial GP hyperparameters and inducing points, and the state
        of ``gp_model_folder/model_vi.ckpt`` where there is one."""
        cfg = self.cfg
        self._load_pretrained_vae(self.model)
        gp = st.init_gp_params(self.spec0, self.spec1, cfg.latent_dim,
                               constrain_scales=cfg.constrain_scales, dtype=self.dtype)
        z = st.init_inducing_points(self.dataset.labels, cfg.M, seed=cfg.seed)
        vicfg = VIConfig(
            spec0=self.spec0, spec1=self.spec1, latent_dim=cfg.latent_dim, weight=cfg.weight,
            loss_function=cfg.loss_function, constrain_scales=cfg.constrain_scales, eps=cfg.eps,
        )
        self.trainer = VITrainer(
            self.model, vicfg, self.dataset, self.blocks, z, gp,
            learning_rate=cfg.learning_rate, seed=cfg.seed, dtype=self.dtype, device=self.device,
        )
        if self.mesh is not None:
            self.trainer = pm.ShardedVITrainer(self.trainer, self.mesh)
        if cfg.gp_model_folder:
            path = os.path.join(cfg.gp_model_folder, "model_vi.ckpt")
            state = try_load_checkpoint(path, like=self.trainer.state)
            if state is not None:
                self.trainer.state = state
                print(f"Loaded VI state (resumed from {path})")
        return self.trainer

    def run_vi(self, pred_epochs: int = 1000):
        """The VI regime end to end: ``cfg.epochs`` steps of phase 1 (free
        per-row moments, decoder and GP hyperparameters), ``model_vi.ckpt``;
        then ``pred_epochs`` steps inferring the prediction cohort's latents
        jointly with the trained ones (the reference fixes 1000),
        ``vi_prediction.ckpt``; then the generation grid decoded from the
        jointly inferred cohort. Validation and tests do not run here."""
        cfg = self.cfg
        if cfg.run_tests or cfg.run_validation:
            print("WARNING: run_tests/run_validation are not supported under "
                  "variational_inference_training; ignoring")
        trainer = self.build_vi_trainer()
        trainer.fit(cfg.epochs, log_every=1)
        if self.writer:
            os.makedirs(cfg.save_path, exist_ok=True)
        self._save(os.path.join(cfg.save_path, "model_vi.ckpt"), trainer.state)
        if self.prediction_dataset is not None:
            mu_pred, lv_pred = trainer.optimize_prediction_set(
                self.prediction_dataset, epochs=pred_epochs)
            self._save(os.path.join(cfg.save_path, "vi_prediction.ckpt"),
                       {"mu_pred": mu_pred, "log_var_pred": lv_pred})
            if cfg.generate_images and self.generation_dataset is not None and self.writer:
                prediction_x, prediction_mu = trainer.joint_cohort(
                    self.prediction_dataset, mu_pred)
                gp = trainer.state.gp
                raw = gp.raw_noise.detach()
                noise = torch.ones_like(raw) if cfg.constrain_scales else kx.constrain(raw)
                recon_complete_gen(
                    self.generation_dataset, self.model, gp, noise, self.spec0, self.spec1,
                    prediction_x, prediction_mu, trainer.z_ind, cfg.id_covariate,
                    self.out_dir, epoch=cfg.epochs, eps=cfg.eps, device=self.device,
                )
        self.metrics.flush()
        self._settle()
        return None

    def run(self):
        """Full experiment: train → save → validate → test → generate."""
        cfg = self.cfg
        if cfg.variational_inference_training:
            return self.run_vi()
        self.build_trainer()
        self.train()
        self.save_artifacts()
        if cfg.run_validation and self.validation_dataset is not None:
            model, gp_params, noise = self.current_params()
            validate(
                model, gp_params, noise, self.spec0, self.spec1, self.validation_dataset,
                self.trainer.tdata.z, cfg.id_covariate, cfg.weight, cfg.loss_function,
                cfg.latent_dim, cfg.eps, type_kl=cfg.type_KL, num_samples=cfg.num_samples,
                device=self.device,
            )
        result = None
        run_tests = cfg.run_tests and self.test_dataset is not None
        gen = cfg.generate_images and self.generation_dataset is not None
        pred = self.encode_prediction_cohort() if (run_tests or gen) else None
        if run_tests:
            result = self._run_tests(pred=pred)
        if gen and self.writer:
            self._generate(pred, epoch=-1)
        self._settle()
        return result

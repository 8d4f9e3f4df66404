#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lvae_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernels from ``lvae_torch/csrc`` (K2 ``chol_inv``,
K1 ``b_chain``, K3 ``kernel_matrix``, K4 ``block_pair`` and K5 ``adam``,
one ``nvcc`` each, all started together), holds each against its plain
PyTorch version on the card, forward and gradient (K2 at every n from 2 to
64, K2 and K1 at batches that leave a block partly filled, K1 also at the
VI shapes ``[32,100,20,20]`` and a ragged ``[32,120,20,20]``; K3's symmetric
walk bit-equal to its general walk and to the transpose, K4 bit-equal
with scalar stores and to the transpose of each block), then runs the
main paths
at the full width of ``configs/healthmnist_lvae.txt`` (ConvVAE on 36×36
frames, L=32 latent GPs, M=60 inducing points, P=100 subjects × T=20
frames, random frames and weights from ``--seed``):

* serving, through ``LVAEPredictor``, ``aot_compile``, ``impute``,
  ``predict_trajectories``, ``predict_trajectory``,
  ``predict_latent_trajectory`` and ``refresh_basis``: the bundle's
  encode, decode, recon and trajectory programs captured as CUDA graphs
  at construction and replayed per request (K2 once inside each
  trajectory replay), the basis fold and its extension as GP programs
  (K2 once inside the fold's graph at ``[32,100,20,20]``; a second
  ``aot_compile`` replays the fold and captures nothing), held bit-equal
  to the same programs run eagerly (cuDNN deterministic) over the K=8
  request, encode, decode, the 256-frame impute, the folded and the
  refreshed basis and a request after ``refresh_basis``, a sibling from
  ``for_k_subjects`` unchanged by its parent's refresh;
* Hensman training with natural gradients, through ``HensmanTrainer``'s
  epoch program: two epochs of 5 steps (20 subjects, 400 frames a step),
  each step replaying the step captured as a CUDA graph (K1 once and K2
  three times inside it, counted per replay and by kernel name in a trace
  of a replayed epoch), held bit-equal to the same step run eagerly on the
  same draws (cuDNN deterministic; with its default algorithms two eager
  runs differ too, and both are printed), a resumed run (one epoch, a
  checkpoint loaded through the state setter, one more) bit-equal to two
  epochs straight through; the eager and the replayed step's host clock,
  device time and host launch calls, the capture's cost and a replayed
  epoch; K5 with its step count on the device bit-equal to the host-scalar
  launch over 1,000 steps;
* standard full-batch training, through ``StandardTrainer``'s epoch
  program with ``hensman=False``, each epoch a replay of the step captured
  as a CUDA graph: 5 epochs of ``type_KL=closed`` (one step each over all
  N = 2000 frames, K3 building the ``[32, 2000, 2000]`` prior once a step),
  2 each of ``GPapprox_closed``, ``GPapprox`` and the five-phase GPPVAE
  regime (its per-subject replay loop inside one graph), and 2 closed
  epochs with the fused optimizer (K5 once a step); each run, and a bf16
  GPapprox_closed run, replayed against the same epochs run eagerly from
  one state (cuDNN deterministic, held bit-equal; the host clock of each;
  the closed step's device memory replayed and eager), a ``fit`` over 2
  chunks rolled back once through the state setter against an eager fit
  straight through, and two replays from one state that draw fresh
  dropout masks;
* the reference-format CLI, through ``lvae_torch.cli.main`` on data from
  the port's generator: 2 pre-training epochs, 4 epochs with validation,
  tests, generation and checkpoints, a resumed run, and 2 epochs on the K4
  route (K1 off, the block-pair switch on), with the kernels each step and
  each validation launched checked on both routes; the run's reference GP
  files (``gp_model.pth``, ``zt_list.pth``, ``m.pth``, ``H.pth``) written
  again and read back; one rollback through the pipeline's epoch callback
  (``auto_recover``, a poisoned epoch) bit-equal to the same restore done
  by hand; the pre-training epoch program (one captured step) timed and
  held against the CPU;
* the evaluation programs (``evaluation/programs.py``) from the CLI run's
  ``model_final.ckpt``: validation of the pipeline's 20-subject cohort and
  of its 100-subject training cohort (2,000 frames) in GPapprox_closed,
  GPapprox (3 samples) and on the K4 route, the prediction cohort's and
  the 2,000-frame cohort's encoding, the 2,000-row decode,
  ``mse_test_gp_approx`` and generation, each captured once, replayed and
  held bit-equal to the same programs run eagerly (cuDNN deterministic),
  each call's K1, K2 and K4 launches checked (``ROUTE_LAUNCHES``);
  ``mse_test_exact`` (eager by rule) on the card at the reference's
  6040-row cap on a generated 6,200-row prediction cohort, and against
  the CPU at 520 rows; in the fresh process each validation's and
  program's profile replayed and eager (wall, device ms, idle share, host
  calls, copies: one read to the host, no pageable copy), the exact
  regression's, and the K1, K2 and K4 kernels of replayed validations and
  posteriors by name;
* the VI regime through ``lvae_torch.cli.main`` with
  ``--variational_inference_training=True`` on the same data and
  pre-trained VAE: 3 phase-1 epochs over the whole cohort through
  ``fit``'s epoch program (each step a replay of the captured step, K1 and
  K2 once inside it, checked), 1000 phase-2 steps on the test split, each
  a replay (K1 and K2 once, in the operators' build), generation, and a
  run resumed from ``model_vi.ckpt``; from that checkpoint 3 phase-1
  epochs, a resume through the state setter and 1000 phase-2 steps, each
  held bit-equal to the same steps run eagerly (cuDNN deterministic);
* the RNN encoder (``type_nnet=rnn``, hidden 64) with each cell, LSTM and
  GRU: one Hensman epoch (5 steps, launches checked) and one K-subject
  request of whole 20-frame sequences through ``LVAEPredictor``;
* bf16 VAE compute (``model_dtype=bfloat16``: the layers in bf16, the
  parameters, losses and GP algebra in f32): 10 replayed Hensman steps
  (K1 once and K2 three times a replay, counted by kernel name in a trace
  in the fresh process, whose bf16 convolution kernels are named there),
  a serving bundle's K=8 request and 256-frame impute, a VI phase-1
  step, an LSTM epoch and request, each against the CPU in bf16 and
  timed beside f32, each replay bit-equal to its eager twin (cuDNN
  deterministic); the bf16 frame table; a replayed epoch at P = 1000, bf16
  against f32; the CLI with ``--model_dtype=bfloat16`` and a resume; a
  sharded bf16 run at mesh (2, 1); and the RNN encoder's replayed step,
  each cell in f32 and bf16, bit-equal to its eager twin;
* subject- and latent-parallel training and serving (``lvae_torch.parallel``):
  one world of 2 gloo ranks sharing the card runs, at the (data, latent)
  meshes (1, 2) and (2, 1), the Hensman run's 10 steps from H + 0.1·I
  through ``ShardedHensmanTrainer``, a 2-subject request through
  ``LVAEPredictor(mesh=)`` and, at (1, 2), 2 closed-KL epochs through
  ``ShardedStandardTrainer``, each rank recording the shape of every K1,
  K2 and K3 launch (checked against the per-rank shapes) and held against
  the single-process card runs; the same 10 steps in f64 are held to
  1e-8 of one f64 process, and one f32 process with each batch's subjects
  rolled by half a batch shows how far f32 rounding alone moves the run;
  a world of one NCCL rank trains one epoch on the trivial mesh;
  ``torchrun --nproc_per_node=2 -m lvae_torch.cli ... --data_mesh=2`` runs
  2 epochs with validation and tests on the pipeline's data.

The bf16 phase holds the card against the CPU at 2e-2 (losses, m/H and
latents, relative) and 1e-2 abs (frames, 2.5 bf16 ulps at 0.5).
Each path is replayed with ``device="cpu"`` (the plain versions) and the
card's answers are held against the CPU's; the standard regime at P=26
subjects (N = 520, still at K3's gate), since an N = 2000 replay is about a
TFLOP of f32 Cholesky work a step on the CPU; the CLI run's final
checkpoint through ``validate`` and ``mse_test_gp_approx``; VI from
``model_vi.ckpt`` (3 phase-1 and 4 phase-2 steps, one noise); the RNN runs
from H + 0.1·I with cuDNN's TF32 off. One ``batch_loss`` from the CLI
run's final checkpoint is held on the K4 route against the K1 route.

The profiler traces of graph replays (the Hensman step and epoch, the
pre-training epoch, a serving request, impute and basis fold, a VI
phase-1 step and a phase-2 run, each standard run's step, each beside its
eager twin, and each capture's cost) are taken in a fresh process, a
world of one rank: a traced replay crashed the long main process. There
K1's and K2's kernels are counted by name in the traces of a replayed
Hensman epoch, 5 replayed requests, a replayed impute and fold, 5
replayed VI phase-1 epochs and a replayed phase 2, and K1's, K2's, K3's
and K5's in 2 replayed epochs of each standard run, and each count is
held to what the path must launch and to the launch counters,
which add a graph's recorded launches after each replay (the kernels
line's ``launches_traced``).

Phases print one line each. Any failure raises and exits non-zero (a rank
that fails too); without
CUDA the script exits non-zero before printing a result. The last lines
are a ``{"kernels": [...]}`` JSON object, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.

Numbers: a kernel's ``ms`` (and ``plain_ms``, ``library_ms``) is the device
time per call from a ``torch.profiler`` trace of 20 warm calls, summed over
every kernel the call launches; ``*event_ms`` is the CUDA-event average over
50 back-to-back calls, which includes the host's launch cost wherever that
exceeds the device time. Inputs are warm (L2-resident). Request and step
times are host-clock medians of calls that end in a synchronise.
``bound_ms`` is the larger of bytes over 3.35 TB/s and f32 operations over
67 TFLOP/s (H100 SXM data sheet).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import itertools
import json
import math
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import time
import traceback
import warnings

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from lvae_torch import cli  # noqa: E402
from lvae_torch import pipeline as pipeline_mod  # noqa: E402
from lvae_torch.config import load_flag_file, parse_flag_lines  # noqa: E402
from lvae_torch.data.blocks import build_subject_blocks  # noqa: E402
from lvae_torch.data.datasets import ArrayDataset  # noqa: E402
from lvae_torch.data.healthmnist import generate_healthmnist  # noqa: E402
from lvae_torch.evaluation import programs as eval_programs  # noqa: E402
from lvae_torch.evaluation.encode import decode_latents, encode_dataset  # noqa: E402
from lvae_torch.evaluation.generation import recon_complete_gen  # noqa: E402
from lvae_torch.evaluation.programs import dataset_tensor, on_device  # noqa: E402
from lvae_torch.evaluation.testing import (  # noqa: E402
    cap_prediction_rows, exact_gp_predict_per_dim, mse_test_exact, mse_test_gp_approx, vae_test,
)
from lvae_torch.inference import LVAEPredictor  # noqa: E402
from lvae_torch.kernels_cuda import adam as k5  # noqa: E402
from lvae_torch.kernels_cuda import b_chain as k1  # noqa: E402
from lvae_torch.kernels_cuda import block_pair as k4  # noqa: E402
from lvae_torch.kernels_cuda import build  # noqa: E402
from lvae_torch.kernels_cuda import chol_plan as cp  # noqa: E402
from lvae_torch.kernels_cuda import cholesky as k2  # noqa: E402
from lvae_torch.kernels_cuda import kernel_matrix as k3  # noqa: E402
from lvae_torch.kernels_cuda import km_plan  # noqa: E402
from lvae_torch.models.rnn import cudnn_layout  # noqa: E402
from lvae_torch.models.vae import make_vae  # noqa: E402
from lvae_torch.ops import kernels as kx  # noqa: E402
from lvae_torch.ops import linalg as la  # noqa: E402
from lvae_torch.ops.predict import predict_latents  # noqa: E402
from lvae_torch.parallel import (  # noqa: E402
    ShardedHensmanTrainer, ShardedStandardTrainer, initialize_distributed, make_mesh,
)
from lvae_torch.parallel.distributed import free_port, join_ranks, spawn_ranks  # noqa: E402
from lvae_torch.train import hensman as hensman_mod  # noqa: E402
from lvae_torch.train.hensman import HensmanConfig, HensmanTrainer  # noqa: E402
from lvae_torch.train.graph import CapturedStep, eager_steps  # noqa: E402
from lvae_torch.train.hensman import batch_loss as hensman_batch_loss  # noqa: E402
from lvae_torch.train.pretrain import VAEPretrainer  # noqa: E402
from lvae_torch.train.standard import StandardConfig, StandardTrainer  # noqa: E402
from lvae_torch.train.state import (  # noqa: E402
    init_gp_params, init_inducing_points, make_optimizer,
)
from lvae_torch.train.vi import VIConfig, VITrainer  # noqa: E402
from lvae_torch.utils.checkpoint import (  # noqa: E402
    load_checkpoint, read_checkpoint, save_checkpoint,
)
from lvae_torch.utils.torch_compat import (  # noqa: E402
    load_reference_gp_state, save_reference_gp_state,
)

CONFIG = os.path.join(ROOT, "configs", "healthmnist_lvae.txt")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, HBM3
F32_FLOPS_PER_S = 67e12  # H100 SXM, f32 outside the tensor cores

BATCH = 256  # serving bundle batch; also the impute request size
T_OBS, N_QUERY, K_SUBJECTS = 10, 10, 8
N_REQUESTS = 5  # predict_trajectories requests timed on the card
N_FOLDS = 3  # basis folds on the card: the first meets CUDA's lazy set-up, the rest are warm
REFRESH_SUBJECTS = 4

LATENT_RTOL = 1e-3  # card vs CPU, max |Δ| over max |CPU|
FRAME_ATOL = 1e-4  # card vs CPU, decoded frames in [0, 1]
TRAIN_EPOCHS = 2  # Hensman epochs on the card and on the CPU (5 steps each)
# card vs CPU, training losses, relative: the reconstruction terms at 1e-3;
# the KL term (and so the net loss) at 1e-2, because it reads K0zz⁻¹, and
# K0zz (60 inducing points over covariates with few distinct values, its
# floor the f32 adaptive jitter) has a condition number near 1e5, which
# magnifies f32 rounding: measured 3.6e-3 on the card
LOSS_RTOL = 1e-3
KL_RTOL = 1e-2
VARIATIONAL_RTOL = 1e-2  # card vs CPU, final m_nat / H_nat, max |Δ| over max |CPU|
H_SHIFT = 0.1  # the compared pair of training runs starts from H + H_SHIFT·I
GRAD_RTOL = 1e-3  # kernel vs plain gradients, max |Δ| over max |plain| per array
# K3 vs its plain version, max |Δ| over max |plain|: one expf and a few
# products per term, summed in the same order; its gradient (plain torch on
# both sides, fed the kernel's or the plain forward) at 1e-4
K3_RTOL, K3_GRAD_RTOL = 1e-5, 1e-4
# K5 vs its plain version per step, max |Δ| over max |plain| of m', v' and
# Δ (a fused multiply-add may round once less); against torch.optim.Adam,
# whose bias correction is written √v/√bc2, relative to the largest update
K5_RTOL, K5_TORCH_RTOL = 1e-6, 1e-5
STD_CLOSED_EPOCHS = 5  # closed-KL epochs on the card (one step each)
STD_EPOCHS = 2  # epochs of each other standard mode, and of the fused optimizer
STD_COMPARE_P = 26  # subjects of the card-vs-CPU standard replay: N = 520 >= 512
STD_COMPARE_CLOSED_EPOCHS = 3
# K4 vs its plain version, max |Δ| over max |plain|: the same expf and
# products per term (multiplied in another order), summed in component
# order; its gradient (plain torch on both sides) at 1e-4
K4_RTOL, K4_GRAD_RTOL = 1e-6, 1e-4
VAL_SUBJECTS = 20  # subjects of the pipeline's validation split


# the last line said, named again on the standard error if a phase fails
last_said = ["(nothing yet)"]


def say(phase: str, msg: str) -> None:
    line = f"[{phase}] {msg}"
    last_said[0] = line[:160]
    print(line, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# --------------------------------------------------------------------- data
def make_cohort(rng: np.random.Generator, subject_ids, t: int, hw: int):
    """HealthMNIST-layout covariates ``[time_age, disease_time, subject,
    gender, disease, location]`` (disease_time 0 for healthy subjects) and
    uniform random frames ``[N, hw, hw, 1]``."""
    time_points = np.arange(t, dtype=np.float64) - (t // 2 - 1)
    rows = []
    for s in subject_ids:
        sick, gender, loc = (int(v) for v in rng.integers(0, 2, 3))
        for i in range(t):
            rows.append([i, time_points[i] if sick else 0.0, s, gender, sick, loc])
    labels = np.asarray(rows, np.float32)
    frames = rng.uniform(size=(labels.shape[0], hw, hw, 1)).astype(np.float32)
    return frames, labels


class World:
    """Everything the serving run needs, made from the seed."""

    def __init__(self, seed: int):
        cfg, _ = load_flag_file(CONFIG)
        self.cfg = cfg
        self.seed = seed
        self.hw = int(round(math.sqrt(cfg.num_dim)))
        rng = np.random.default_rng(seed)
        self.frames, self.labels = make_cohort(rng, range(cfg.P), cfg.T, self.hw)
        req_f, req_l = make_cohort(rng, range(1000, 1000 + K_SUBJECTS), cfg.T, self.hw)
        req_f = req_f.reshape(K_SUBJECTS, cfg.T, self.hw, self.hw, 1)
        req_l = req_l.reshape(K_SUBJECTS, cfg.T, -1)
        self.req_frames, self.req_labels = req_f, req_l  # whole sequences (RNN serving)
        self.obs_frames, self.obs_labels = req_f[:, :T_OBS], req_l[:, :T_OBS]
        self.query_labels = req_l[:, T_OBS:T_OBS + N_QUERY]
        self.new_frames, self.new_labels = make_cohort(
            rng, range(2000, 2000 + REFRESH_SUBJECTS), cfg.T, self.hw
        )
        self.impute_frames = self.frames[:BATCH]
        self.impute_mask = (rng.uniform(size=self.impute_frames.shape) > 0.3).astype(np.float32)
        self.spec0, self.spec1 = kx.split_kernel_spec(
            id_covariate=cfg.id_covariate, **cfg.kernel_spec_kwargs()
        )
        self.gp = init_gp_params(
            self.spec0, self.spec1, cfg.latent_dim, constrain_scales=cfg.constrain_scales
        )
        self.noise = (
            torch.ones(cfg.latent_dim, dtype=torch.float32)
            if cfg.constrain_scales else kx.constrain(self.gp.raw_noise)
        )
        self.z = init_inducing_points(self.labels, cfg.M, seed=seed)
        # training: the cohort above with a random observation mask
        self.pixmask = (rng.uniform(size=(self.labels.shape[0], cfg.num_dim)) > 0.1).astype(
            np.float32)
        self.blocks = build_subject_blocks(self.labels, cfg.id_covariate)

    def model(self, dtype=torch.float32, compute=None, dropout=None):
        """A fresh ConvVAE with the seed's random weights, on the CPU,
        computing in ``compute`` (None: its parameters' dtype), with the
        config's dropout unless ``dropout`` names another."""
        cfg = self.cfg
        return make_vae(
            cfg.type_nnet, cfg.latent_dim, cfg.num_dim, vy_init=cfg.vy_init,
            dropout=cfg.dropout if dropout is None else dropout, dropout_input=cfg.dropout_input,
            generator=torch.Generator().manual_seed(self.seed), dtype=dtype,
            compute_dtype=compute,
        )

    def rnn_model(self, cell: str, compute=None):
        """A fresh RNN encoder model (``type_nnet=rnn``, hidden 64, the
        config default) with the seed's random weights, on the CPU."""
        cfg = self.cfg
        return make_vae("rnn", cfg.latent_dim, cfg.num_dim, vy_init=cfg.vy_init, T=cfg.T,
                        hidden_dim=cfg.hidden_dim, type_rnn=cell,
                        generator=torch.Generator().manual_seed(self.seed), compute_dtype=compute)

    def trainer(self, device: str, model=None, dtype=torch.float32) -> HensmanTrainer:
        """A Hensman trainer at the config file's settings, on ``device``,
        for ``model`` (the ConvVAE by default) in ``dtype``; every trainer
        made here for one model kind and dtype starts from the same state."""
        cfg = self.cfg
        hcfg = HensmanConfig(
            spec0=self.spec0, spec1=self.spec1, latent_dim=cfg.latent_dim,
            P_tot=self.blocks.num_subjects, N_tot=self.labels.shape[0], weight=cfg.weight,
            loss_function=cfg.loss_function, natural_gradient=cfg.natural_gradient,
            natural_gradient_lr=cfg.natural_gradient_lr,
            constrain_scales=cfg.constrain_scales, eps=cfg.eps, dropout=cfg.dropout > 0,
            vy_fixed=cfg.vy_fixed, learn_inducing=cfg.learn_inducing,
        )

        class Cohort:
            data, labels, mask = self.frames, self.labels, self.pixmask

        return HensmanTrainer(
            model or self.model(), hcfg, Cohort, self.blocks, self.z,
            subjects_per_batch=cfg.subjects_per_batch, learning_rate=cfg.learning_rate,
            seed=self.seed, t_buckets=cfg.T_buckets, dtype=dtype, device=device,
        )

    def vi_trainer(self, device: str, compute=None) -> VITrainer:
        """A VI trainer at the config file's settings over the whole cohort,
        on ``device`` (the decoder computing in ``compute``); every trainer
        made here starts from the same state."""
        cfg = self.cfg
        vcfg = VIConfig(spec0=self.spec0, spec1=self.spec1, latent_dim=cfg.latent_dim,
                        weight=cfg.weight, loss_function=cfg.loss_function,
                        constrain_scales=cfg.constrain_scales, eps=cfg.eps)

        class Cohort:
            data, labels, mask = self.frames, self.labels, self.pixmask

        return VITrainer(self.model(compute=compute), vcfg, Cohort, self.blocks, self.z, self.gp,
                         learning_rate=cfg.learning_rate, seed=self.seed, device=device)

    def standard_trainer(self, device: str, type_kl: str = "closed",
                         pseudo_minibatch: bool = False, optimizer: str = "adam",
                         subjects=None, compute=None, dropout=None) -> StandardTrainer:
        """A full-batch trainer (``hensman=False``) at the config file's
        settings on the first ``subjects`` subjects (all by default), on
        ``device``, the VAE computing in ``compute``, with the config's
        dropout unless ``dropout`` names another; every trainer made here
        for one compute dtype and dropout starts from the same state."""
        cfg = self.cfg
        p = subjects or cfg.P
        n = p * cfg.T
        dropout = cfg.dropout if dropout is None else dropout
        scfg = StandardConfig(
            spec0=self.spec0, spec1=self.spec1, latent_dim=cfg.latent_dim, P_tot=p, T=cfg.T,
            weight=cfg.weight, loss_function=cfg.loss_function, type_KL=type_kl,
            num_samples=cfg.num_samples, constrain_scales=cfg.constrain_scales, eps=cfg.eps,
            dropout=dropout > 0, vy_fixed=cfg.vy_fixed,
        )

        class Cohort:
            data, labels, mask = self.frames[:n], self.labels[:n], self.pixmask[:n]

        trainer = StandardTrainer(
            self.model(compute=compute, dropout=dropout), scfg, Cohort,
            build_subject_blocks(Cohort.labels, cfg.id_covariate),
            self.z, learning_rate=cfg.learning_rate, seed=self.seed,
            pseudo_minibatch=pseudo_minibatch, device=device,
        )
        # the optimizer named here, whatever $LVAE_OPT says
        trainer.state = trainer.state._replace(opt_state=make_optimizer(
            trainer.state.trainables.parameters(), cfg.learning_rate, optimizer))
        return trainer

    def train_chain_inputs(self):
        """The B-chain's inputs at the first training batch's shape
        ``[L, S, T]``: constrained params from ``init_gp_params``, the first
        ``subjects_per_batch`` subjects of the cohort."""
        s_dim, t = self.cfg.subjects_per_batch, self.cfg.T
        xb = torch.as_tensor(self.labels[: s_dim * t].reshape(s_dim, t, -1), device="cuda")
        mask = torch.ones(s_dim, t, device="cuda")
        return (self.spec0, self.spec1, *constrained(self.gp.kp0), *constrained(self.gp.kp1),
                self.noise.cuda(), xb.contiguous(), mask)

    def vi_chain_inputs(self):
        """The B-chain's inputs of a VI phase-1 step, the whole cohort
        ``[L, P, T]``: constrained params from ``init_gp_params``."""
        xb = torch.as_tensor(self.labels.reshape(self.cfg.P, self.cfg.T, -1), device="cuda")
        mask = torch.ones(self.cfg.P, self.cfg.T, device="cuda")
        return (self.spec0, self.spec1, *constrained(self.gp.kp0), *constrained(self.gp.kp1),
                self.noise.cuda(), xb.contiguous(), mask)

    def fold_b(self, device) -> torch.Tensor:
        """The basis fold's ``B = K1 + σ²I`` stack ``[L, P, T, T]``, the
        input the main path hands kernel K2."""
        t = self.cfg.T
        xb = torch.as_tensor(self.labels.reshape(self.cfg.P, t, -1), device=device)
        mask = torch.ones(self.cfg.P, t, dtype=torch.float32, device=device)
        return kx.block_b_operator(
            self.spec1, self.gp.kp1.to(device), xb, mask, self.noise.to(device)
        ).contiguous()


# ------------------------------------------------------------ kernel check
def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest per-matrix max |Δ| over max |ref|."""
    num = (got - want).abs().amax(dim=(-1, -2))
    den = want.abs().amax(dim=(-1, -2))
    return float((num / den).max())


def rel_err_scalar(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |Δ| over max(|want|, 1) of per-latent scalars (log|B|, tr)."""
    return float(((got - want).abs() / want.abs().clamp(min=1)).max())


def spd_stack(shape, n: int, gen: torch.Generator, cond: float = 1e2) -> torch.Tensor:
    """Random SPD stack on the card with eigenvalues log-spaced in [1, cond]."""
    x = torch.randn(*shape, n, n, generator=gen, dtype=torch.float64, device="cuda")
    q, _ = torch.linalg.qr(x)
    lam = torch.logspace(0, math.log10(cond), n, dtype=torch.float64, device="cuda")
    a = (q * lam[..., None, :]) @ q.mT
    return (0.5 * (a + a.mT)).float().contiguous()


def cuda_ms(fn, arg, iters: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn(arg)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(arg)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def timing_row(shape, arg, kernel, plain, library, bound: dict) -> dict:
    """Device and CUDA-event times per call of the kernel's wrapper, its
    plain version and the library call (None: there is none)."""
    row = {"shape": list(shape)}
    for key, fn in (("", kernel), ("plain_", plain), ("library_", library)):
        if fn is None:
            row[f"{key}ms"] = None
            continue
        prof = profile_window(lambda: fn(arg), 20)
        if prof["device_ms"] == 0.0:  # a trace that recorded no device work
            say("kernel", f"empty device trace for the {key or 'kernel_'}call at {list(shape)}: "
                f"{json.dumps(prof)}; tracing again")
            prof = profile_window(lambda: fn(arg), 20)
        row[f"{key}ms"] = prof["device_ms"] or None  # None: not measured
        row[f"{key}event_ms"] = cuda_ms(fn, arg)
    return {**row, **bound}


def rotating(fn, items):
    """``fn`` over ``items`` in turn, one a call: with the items' bytes past
    the 50 MB L2 cache, each call finds its inputs in device memory, as a
    training step's optimizer does."""
    it = itertools.cycle(items)
    return lambda _: fn(next(it))


def library_chol_inv(a: torch.Tensor):
    l = torch.linalg.cholesky(a)
    return l, torch.cholesky_inverse(l)


def chol_inv_bound(shape) -> dict:
    """Least time for (L, A⁻¹) of an f32 stack: read A, write L and A⁻¹
    once; about n³ flops per matrix (factor, triangular inverse, product)."""
    n = shape[-1]
    batch = math.prod(shape[:-2])
    bytes_ms = 3 * batch * n * n * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = batch * n ** 3 / F32_FLOPS_PER_S * 1e3
    return {
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }


def check_k2(world: World) -> dict:
    """K2 against its plain version on the card; returns the kernels-line
    entry (without the main path's launch count)."""
    gen = torch.Generator(device="cuda").manual_seed(world.seed)
    cases = [
        ("n=2", spd_stack((32, 8), 2, gen), 1e-4),
        ("n=20 fold shape", spd_stack((32, 100), 20, gen), 1e-4),
        ("n=20 request shape", spd_stack((32, K_SUBJECTS), 20, gen), 1e-4),
        ("n=60", spd_stack((32,), 60, gen), 1e-3),
        ("n=64", spd_stack((32,), 64, gen), 1e-3),
        ("fold B of the serving cohort", world.fold_b("cuda"), 1e-4),
    ]
    for name, a, tol in cases:
        l, inv = k2.cholesky_inverse(a)
        lr, ir = k2.cholesky_inverse_reference(a)
        torch.cuda.synchronize()
        el, ei = rel_err(l, lr), rel_err(inv, ir)
        say("kernel", f"K2 {name} {list(a.shape)}: rel err L {el:.3e}, A^-1 {ei:.3e} (tol {tol:g})")
        if not (el <= tol and ei <= tol):
            raise AssertionError(f"K2 disagrees with its plain version at {name}")
        if not bool((torch.triu(l, 1) == 0).all()):
            raise AssertionError(f"K2 L has nonzeros above the diagonal at {name}")
        if not torch.equal(inv, inv.mT):
            raise AssertionError(f"K2 A^-1 is not exactly symmetric at {name}")

    bad = spd_stack((4,), 20, gen)
    bad[1] = -bad[1]
    l, inv = k2.cholesky_inverse(bad)
    torch.cuda.synchronize()
    good = [0, 2, 3]
    if not (torch.isnan(l[1]).any() and torch.isnan(inv[1]).any()):
        raise AssertionError("K2 gave no NaN on a non-SPD block")
    if not (torch.isfinite(l[good]).all() and torch.isfinite(inv[good]).all()):
        raise AssertionError("a non-SPD block spoiled its neighbours")
    say("kernel", "K2 non-SPD block: NaN in that block only")
    check_k2_every_n(gen)

    # times, at the shapes the main path gives the kernel
    fold_b = cases[-1][1]
    per_shape = []
    for a in (fold_b, fold_b[:, :K_SUBJECTS].contiguous()):
        row = timing_row(a.shape, a, k2.cholesky_inverse, k2.cholesky_inverse_reference,
                         library_chol_inv, chol_inv_bound(a.shape))
        say("kernel", "K2 times " + json.dumps(row))
        per_shape.append(row)

    l, inv = k2.cholesky_inverse(fold_b)
    lr, ir = k2.cholesky_inverse_reference(fold_b)
    max_abs = max(float((l - lr).abs().max()), float((inv - ir).abs().max()))
    fold = per_shape[0]
    return {
        "name": "chol_inv",
        "route": "cuda",
        "source": k2.SOURCE,
        "replaces": k2.REPLACES,
        "launches": None,
        "max_abs_err": max_abs,
        "ms": fold["ms"],
        "kernel_ms": fold["ms"],
        "event_ms": fold["event_ms"],
        "plain_ms": fold["plain_ms"],
        "plain_event_ms": fold["plain_event_ms"],
        "bound_ms": fold["bound_ms"],
        "bound_by": fold["bound_by"],
        "library_ms": fold["library_ms"],
        "library_call": "torch.linalg.cholesky + torch.cholesky_inverse",
        "shape": fold["shape"],
        "bound_us": fold["bound_ms"] * 1e3,
        "max_rel_err": max(rel_err(l, lr), rel_err(inv, ir)),
        "per_shape": per_shape,
    }


def card_sms() -> int:
    return cp.num_sms(torch.device("cuda", torch.cuda.current_device()))


def k2_batches(n: int) -> list:
    """The batches K2 is held at for size ``n``: 1, 7, an odd multiple (265
    on 132 SMs) of the teams a block of a batch large enough for packed warp
    teams (n <= 32), and, where a block holds several teams, one matrix
    more, which leaves the last block one team."""
    sms = card_sms()
    odd = (cp.WARP_TEAMS_AN_SM * sms // cp.MAX_WARP_TEAMS) | 1
    teams = cp.chol_inv_plan(n, odd * cp.MAX_WARP_TEAMS, sms).teams
    return [1, 7, odd * teams] + ([odd * teams + 1] if teams > 1 else [])


def check_k2_matrices(name: str, a: torch.Tensor, tol: float) -> float:
    """K2 against its plain version on ``a``, with its contracts: exact zeros
    above L's diagonal and a bitwise-symmetric A⁻¹. Returns the error."""
    l, inv = k2.cholesky_inverse(a)
    lr, ir = k2.cholesky_inverse_reference(a)
    torch.cuda.synchronize()
    err = max(rel_err(l, lr), rel_err(inv, ir))
    if not err <= tol:
        raise AssertionError(f"K2 disagrees with its plain version at {name}: {err:.3e} > {tol:g}")
    if not bool((torch.triu(l, 1) == 0).all()):
        raise AssertionError(f"K2 L has nonzeros above the diagonal at {name}")
    if not torch.equal(inv, inv.mT):
        raise AssertionError(f"K2 A^-1 is not exactly symmetric at {name}")
    return err


def check_k2_every_n(gen: torch.Generator) -> None:
    """K2 at every n from 2 to 64, each at the batches of :func:`k2_batches`
    (tolerance 1e-4 at n <= 20, 1e-3 above, as the main-path cases), and
    non-SPD matrices among several teams of a block, 5 and the last (alone
    in the last block for a warp team, n = 20; a block team, n = 60)."""
    worst = {"warp": 0.0, "block": 0.0}
    for n in range(la.KERNEL_MIN_N, la.KERNEL_MAX_N + 1):
        for batch in k2_batches(n):
            err = check_k2_matrices(f"n={n} batch={batch}", spd_stack((batch,), n, gen),
                                    1e-4 if n <= 20 else 1e-3)
            kind = "warp" if n <= 32 else "block"
            worst[kind] = max(worst[kind], err)
    say("kernel", f"K2 at every n in {la.KERNEL_MIN_N}..{la.KERNEL_MAX_N}, batches "
        f"{k2_batches(20)} (n <= 32), {k2_batches(60)} (n > 32): worst rel err, warp teams "
        f"{worst['warp']:.3e}, block teams {worst['block']:.3e}; zeros above L's diagonal, "
        "A^-1 bitwise symmetric")
    for n in (20, 60):
        batch = k2_batches(n)[-1]
        a = spd_stack((batch,), n, gen)
        bad = [5, batch - 1]
        a[bad] = -a[bad]
        l, inv = k2.cholesky_inverse(a)
        torch.cuda.synchronize()
        good = torch.ones(batch, dtype=torch.bool, device="cuda")
        good[bad] = False
        if not all(torch.isnan(l[i]).any() and torch.isnan(inv[i]).any() for i in bad):
            raise AssertionError(f"K2 gave no NaN on a non-SPD block at n={n}")
        if not (torch.isfinite(l[good]).all() and torch.isfinite(inv[good]).all()):
            raise AssertionError(f"a non-SPD block spoiled its neighbours at n={n}")
    say("kernel", f"K2 non-SPD blocks 5 and last of {k2_batches(20)[-1]} (n=20) and of "
        f"{k2_batches(60)[-1]} (n=60): NaN in those blocks only")


def constrained(kp):
    """(scale, 1/(2ℓ²)) on the card from raw kernel parameters."""
    ls = kx.constrain(kp.raw_lengthscale.cuda())
    return kx.constrain(kp.raw_scale.cuda()), 0.5 / (ls * ls)


def grad_rel_err(fn_a, fn_b, leaves, rest, weights) -> float:
    """Largest max |Δ| over max |b| among the gradients w.r.t. ``leaves`` of
    the same weighted scalar through ``fn_a`` and ``fn_b``."""
    def grads(fn):
        xs = [x.detach().clone().requires_grad_(True) for x in leaves]
        outs = fn(*xs, *rest)
        sum(torch.sum(o * w) for o, w in zip(outs, weights)).backward()
        return [x.grad for x in xs]

    return max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(grads(fn_a), grads(fn_b)))


def check_k2_training(world: World) -> list:
    """K2 at the training step's shapes: the stacked [K0zz; H] ([64,60,60])
    and the natural-gradient inversion ([32,60,60]); its gradient
    (ops/linalg.CholeskyInverse, kernel forward) against torch.autograd
    through the plain version. Returns the per-shape rows."""
    gen = torch.Generator(device="cuda").manual_seed(world.seed + 1)
    m = world.cfg.M
    rows = []
    for batch in (2 * world.cfg.latent_dim, world.cfg.latent_dim):
        a = spd_stack((batch,), m, gen)
        w = [torch.randn(a.shape, generator=gen, device="cuda") for _ in range(2)]
        err = grad_rel_err(
            lambda x: la.cholesky_and_inverse(la.symmetrize(x)),
            lambda x: k2.cholesky_inverse_reference(la.symmetrize(x)),
            [a], [], w,
        )
        say("kernel", f"K2 gradient {list(a.shape)}: rel err {err:.3e} (tol {GRAD_RTOL:g})")
        if not err <= GRAD_RTOL:
            raise AssertionError(f"K2's gradient disagrees at {list(a.shape)}")
        row = timing_row(a.shape, a, k2.cholesky_inverse, k2.cholesky_inverse_reference,
                         library_chol_inv, chol_inv_bound(a.shape))
        say("kernel", "K2 times " + json.dumps(row))
        rows.append(row)
    return rows


def chain_inputs(gen, spec0, spec1, n_lat, n_subj, t):
    """Synthetic B-chain inputs on the card in the HealthMNIST covariate
    layout: subject 1 ragged (half its frames masked), the last a ghost."""
    dev = "cuda"
    xb = torch.zeros(n_subj, t, 6, device=dev)
    xb[:, :, 0] = torch.arange(t, device=dev) + torch.rand(n_subj, 1, generator=gen, device=dev)
    xb[:, :, 1] = torch.randn(n_subj, t, generator=gen, device=dev)
    xb[:, :, 2] = torch.arange(n_subj, device=dev)[:, None].float()
    xb[:, :, 3:] = torch.randint(0, 2, (n_subj, 1, 3), generator=gen, device=dev).float()
    mask = torch.ones(n_subj, t, device=dev)
    mask[1, t // 2:] = 0.0
    mask[-1] = 0.0

    def params(c):
        ls = 1.5 + torch.rand(n_lat, c, generator=gen, device=dev)
        return 0.5 + torch.rand(n_lat, c, generator=gen, device=dev), 0.5 / (ls * ls)

    noise = 0.5 + torch.rand(n_lat, generator=gen, device=dev)
    return (spec0, spec1, *params(len(spec0.components)), *params(len(spec1.components)),
            noise, (xb * mask[..., None]).contiguous(), mask)


def b_chain_bound(args) -> dict:
    """Least time for the B-chain: read the params, σ², covariates and mask
    and write B⁻¹ and the two per-block scalars once; about T³ flops per
    block (factor, triangular inverse, product) plus 8 flops per component
    and entry for K1 and K0, and 2 per entry for the trace."""
    spec0, spec1, s0, _, s1, _, _, xb, _ = args
    n_lat, (n_subj, t, q) = s0.shape[0], xb.shape
    c0, c1 = s0.shape[1], s1.shape[1]
    nbytes = 4 * (n_lat * n_subj * (t * t + 2) + n_subj * t * (q + 1) + n_lat * (2 * c0 + 2 * c1 + 1))
    ops = n_lat * n_subj * (t ** 3 + (8 * (c0 + c1) + 2) * t * t)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def check_k1_partial_block(world: World, gen: torch.Generator) -> None:
    """K1 at L·S = 11 × 97 = 1,067 blocks: packed warp teams with the last
    thread block partly filled (its last team the ghost subject), against
    the plain version; then latent 10's σ² negative: NaN in its real blocks,
    the ghost beside them in the last thread block still the identity."""
    args = list(chain_inputs(gen, world.spec0, world.spec1, 11, 97, 20))
    p = cp.b_chain_plan(20, 11 * 97, args[7].shape[2], card_sms())
    if not (p.team == cp.WARP and p.blocks * p.teams > 11 * 97):
        raise AssertionError(f"K1's plan {p} leaves no partly filled last block")
    ib, ld, tr = k1.b_chain(*args)
    ibr, ldr, trr = k1.b_chain_reference(*args)
    errs = (rel_err(ib, ibr), rel_err_scalar(ld, ldr), rel_err_scalar(tr, trr))
    if not max(errs) <= 1e-4:
        raise AssertionError(f"K1 disagrees with its plain version at 11 x 97 blocks: {errs}")
    args[6] = args[6].clone()
    args[6][-1] = -50.0
    ib, ld, tr = k1.b_chain(*args)
    torch.cuda.synchronize()
    if not (torch.isnan(ib[-1, -2]).any() and torch.isnan(ld[-1]) and torch.isnan(tr[-1])):
        raise AssertionError("K1 gave no NaN on a non-SPD block in the last thread block")
    if not (torch.equal(ib[-1, -1], torch.eye(20, device="cuda"))
            and torch.isfinite(ib[:-1]).all() and torch.isfinite(ld[:-1]).all()):
        raise AssertionError("a non-SPD block spoiled its neighbours in the last thread block")
    say("kernel", f"K1 L,S,T=[11, 97, 20] ({p.blocks} blocks of {p.teams} warp teams, the last "
        f"{11 * 97 - (p.blocks - 1) * p.teams}): rel err iB {errs[0]:.3e}, log|B| {errs[1]:.3e}, "
        f"tr {errs[2]:.3e} (tol 1e-4); a non-SPD latent: NaN in its blocks only, the ghost "
        "beside them the identity")


def check_k1(world: World) -> dict:
    """K1 against its plain version on the card, forward and gradient;
    returns the kernels-line entry (without the main path's launches)."""
    gen = torch.Generator(device="cuda").manual_seed(world.seed + 2)
    train = world.train_chain_inputs()
    vi_shapes = [("VI phase 1, the whole cohort", world.vi_chain_inputs()),
                 ("VI phase 2, a ragged joint cohort",
                  chain_inputs(gen, world.spec0, world.spec1, world.cfg.latent_dim,
                               world.cfg.P + VAL_SUBJECTS, world.cfg.T))]
    cases = [("training shape, smoke cohort", train)] + vi_shapes
    cases += [(f"ragged + ghost T={t}", chain_inputs(gen, world.spec0, world.spec1, 8, 6, t))
              for t in (2, 20, 31, 32, 33, 64, 65, 128)]
    for name, args in cases:
        ib, ld, tr = k1.b_chain(*args)
        ibr, ldr, trr = k1.b_chain_reference(*args)
        torch.cuda.synchronize()
        t = args[7].shape[1]
        tol = 1e-4 if t <= 20 else 1e-3
        errs = (rel_err(ib, ibr), rel_err_scalar(ld, ldr), rel_err_scalar(tr, trr))
        w = [torch.randn(ib.shape, generator=gen, device="cuda"),
             torch.full(ld.shape, 0.7, device="cuda"), torch.full(tr.shape, 1.3, device="cuda")]
        g_err = grad_rel_err(
            lambda *x: k1.BChain.apply(args[0], args[1], *x),
            lambda *x: k1.b_chain_reference(args[0], args[1], *x),
            list(args[2:7]), list(args[7:]), w,
        )
        say("kernel", f"K1 {name} L,S,T={list(ib.shape[:3])}: rel err iB {errs[0]:.3e}, "
            f"log|B| {errs[1]:.3e}, tr {errs[2]:.3e} (tol {tol:g}); gradient "
            f"(s0,g0,s1,g1,sigma2) {g_err:.3e} (tol {GRAD_RTOL:g})")
        if not (max(errs) <= tol and g_err <= GRAD_RTOL):
            raise AssertionError(f"K1 disagrees with its plain version at {name}")
        if not torch.equal(ib, ib.mT):
            raise AssertionError(f"K1 B^-1 is not exactly symmetric at {name}")

    bad = list(dict(cases)["ragged + ghost T=20"])
    bad[6] = bad[6].clone()
    bad[6][3] = -50.0  # sigma^2 of latent 3: its real blocks are indefinite
    ib, ld, tr = k1.b_chain(*bad)
    torch.cuda.synchronize()
    keep = [i for i in range(ib.shape[0]) if i != 3]
    if not (torch.isnan(ib[3, 0]).any() and torch.isnan(ld[3]) and torch.isnan(tr[3])):
        raise AssertionError("K1 gave no NaN on a non-SPD block")
    if not (torch.isfinite(ib[keep]).all() and torch.isfinite(ld[keep]).all()):
        raise AssertionError("a non-SPD block spoiled other latents")
    say("kernel", "K1 non-SPD latent: NaN in its blocks only")
    check_k1_partial_block(world, gen)

    ib, ld, tr = k1.b_chain(*train)
    ibr, ldr, trr = k1.b_chain_reference(*train)
    max_abs = max(float((a - b).abs().max()) for a, b in ((ib, ibr), (ld, ldr), (tr, trr)))
    per_shape = []
    for args in [train] + [a for _, a in vi_shapes]:
        row = timing_row([args[2].shape[0], *args[7].shape[:2]], args, lambda a: k1.b_chain(*a),
                         lambda a: k1.b_chain_reference(*a), None, b_chain_bound(args))
        say("kernel", f"K1 times {json.dumps(row)} | {card_line()}")
        per_shape.append(row)
    row = per_shape[0]
    return {
        "name": "b_chain",
        "route": "cuda",
        "source": k1.SOURCE,
        "replaces": k1.REPLACES,
        "launches": None,
        "max_abs_err": max_abs,
        "ms": row["ms"],
        "event_ms": row["event_ms"],
        "plain_ms": row["plain_ms"],
        "plain_event_ms": row["plain_event_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes the chain",
        "shape": row["shape"],
        "max_rel_err": rel_err(ib, ibr),
        "per_shape": per_shape,
    }


def kernel_matrix_bound(spec, shape, q: int) -> dict:
    """Least time for ``K [L, N1, N2]``: read the covariates and parameters
    and write K once; per entry and latent one exp and four flops for each
    RBF component and two for each other one."""
    n_lat, n1, n2 = shape
    c = len(spec.components)
    n_rbf = sum(comp.rbf_col >= 0 for comp in spec.components)
    nbytes = 4 * (n_lat * n1 * n2 + (n1 + n2) * q + 2 * n_lat * c)
    ops = n_lat * n1 * n2 * (5 * n_rbf + 2 * (c - n_rbf))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def k3_inputs(spec, kp, x1, x2, dev):
    """(spec, constrained scale, g, x1, x2) on ``dev``; ``x2 is x1`` stays
    one tensor, so that K3 takes its symmetric walk, as on the main path."""
    scale = kx.constrain(kp.raw_scale.to(dev))
    ls = kx.constrain(kp.raw_lengthscale.to(dev))
    t1 = torch.as_tensor(x1, device=dev).contiguous()
    t2 = t1 if x2 is x1 else torch.as_tensor(x2, device=dev).contiguous()
    return (spec, scale.contiguous(), (0.5 / (ls * ls)).contiguous(), t1, t2)


def general_walk(args):
    """The same K3 inputs with x2 a copy of x1: the general walk."""
    return (*args[:4], args[3].clone())


def bitwise_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    """Entries whose bits differ (NaN equal to NaN of the same bits)."""
    return int((a.view(torch.int32) != b.view(torch.int32)).sum())


def random_kp(gen, spec, n_lat, dev):
    c = len(spec.components)
    return kx.KernelParams(
        0.3 * torch.randn(n_lat, c, generator=gen, device=dev),
        0.3 * torch.randn(n_lat, c, generator=gen, device=dev) + 1.0)


def max_rel(got, want) -> float:
    """max |Δ| over max |reference|."""
    return float((got - want).abs().max() / want.abs().max())


def k3_grad_err(spec, kp, x1, x2, cot, mask1=None, mask2=None) -> float:
    """Gradient w.r.t. the raw parameters of ``Σ cot ⊙ K`` through
    ``kernel_matrix_kernel`` (K3 forward, FusedKernelMatrix backward)
    against autograd through the plain version."""
    def plain(spec, params, x1, x2, mask1, mask2):
        scale = kx.constrain(params.raw_scale)
        ls = kx.constrain(params.raw_lengthscale)
        out = k3.kernel_matrix_reference(spec, scale, 0.5 / (ls * ls), x1, x2)
        if mask1 is not None:
            out = out * mask1[:, None] * mask2[None, :]
        return out

    def grads(fn):
        leaves = [t.detach().clone().requires_grad_(True) for t in kp]
        torch.sum(fn(spec, kx.KernelParams(*leaves), x1, x2, mask1, mask2) * cot).backward()
        return [t.grad for t in leaves]

    return max(max_rel(a, b) for a, b in zip(grads(k3.kernel_matrix_kernel), grads(plain)))


def check_k3(world: World, dev: str = "cuda") -> dict:
    """K3 against its plain version on the card, forward and gradient;
    returns the kernels-line entry (without the main path's launches)."""
    gen = torch.Generator(device=dev).manual_seed(world.seed + 3)
    # the closed-KL prior's joined spec at the trainer's initial parameters
    spec, kp = kx.join_specs(world.spec0, world.spec1, world.gp.kp0, world.gp.kp1)
    labels = world.labels
    n, q = labels.shape
    n_lat = world.cfg.latent_dim
    main = k3_inputs(spec, kp, labels, labels, dev)
    small = world.labels[:STD_COMPARE_P * world.cfg.T]
    odd = labels[:517]
    cases = [
        ("standard closed-KL prior", main),
        ("card-vs-CPU replay shape", k3_inputs(spec, random_kp(gen, spec, 32, dev), small,
                                                small, dev)),
        ("symmetric, N % 4 != 0", k3_inputs(spec, random_kp(gen, spec, 9, dev), odd, odd, dev)),
        ("not tile multiples", k3_inputs(spec, random_kp(gen, spec, 3, dev), labels[:517],
                                         labels[:1030], dev)),
        ("below the gate, called directly", k3_inputs(spec, random_kp(gen, spec, 2, dev),
                                                      labels[:70], labels[:37], dev)),
    ]
    for name, args in cases:
        got = k3.kernel_matrix_fused(*args)
        want = k3.kernel_matrix_reference(*args)
        torch.cuda.synchronize()
        err = max_rel(got, want)
        msg = f"K3 {name} {list(got.shape)}: rel err {err:.3e} (tol {K3_RTOL:g})"
        if not (err <= K3_RTOL and got.shape == want.shape):
            raise AssertionError(f"K3 disagrees with its plain version at {name}")
        if args[4] is args[3]:
            # the symmetric walk against the general one on a copy, and K[l] = K[l]ᵀ
            general = k3.kernel_matrix_fused(*general_walk(args))
            diff, asym = bitwise_diff(got, general), bitwise_diff(got, got.mT)
            msg += f"; symmetric vs general walk {diff} entries differ, K[l] vs K[l]ᵀ {asym}"
            if diff or asym:
                raise AssertionError(f"K3's symmetric walk is not bit-equal at {name}")
            del general
        say("kernel", msg)
        del got, want

    # every factor kind (centred categorical, both-one) with row and column masks
    comp = kx.KernelComponent
    cat_spec = kx.KernelSpec(components=(
        comp(kind="cat_mod", rbf_col=-1, eq_cols=(), and_cols=(), cat_mod=(3, 2)),
        comp(kind="cat_mod_rbf", rbf_col=0, eq_cols=(2,), and_cols=(4,), cat_mod=(5, 2)),
        *world.spec1.components,
    ))
    cat_kp = random_kp(gen, cat_spec, 4, dev)
    x1 = torch.as_tensor(labels[:600], device=dev)
    x2 = torch.as_tensor(labels[700:1230], device=dev)
    m1 = (torch.rand(600, generator=gen, device=dev) > 0.2).float()
    m2 = (torch.rand(530, generator=gen, device=dev) > 0.2).float()
    got = k3.kernel_matrix_kernel(cat_spec, cat_kp, x1, x2, m1, m2)
    want = k3.kernel_matrix_reference(*k3_inputs(cat_spec, cat_kp, x1, x2, dev))
    want = want * m1[:, None] * m2[None, :]
    torch.cuda.synchronize()
    err = max_rel(got, want)
    say("kernel", f"K3 cat_mod + both-one spec, row/column masks {list(got.shape)}: rel err "
        f"{err:.3e} (tol {K3_RTOL:g})")
    if not err <= K3_RTOL:
        raise AssertionError("K3 disagrees with its plain version on the cat_mod spec")

    g_errs = {
        "masked cat_mod [4,600,530]": k3_grad_err(
            cat_spec, cat_kp, x1, x2, torch.randn(4, 600, 530, generator=gen, device=dev),
            m1, m2),
        f"standard prior [{n_lat},{n},{n}]": k3_grad_err(
            spec, kx.KernelParams(kp.raw_scale.to(dev), kp.raw_lengthscale.to(dev)),
            main[3], main[4], torch.randn(n_lat, n, n, generator=gen, device=dev)),
    }
    say("kernel", f"K3 gradient (raw scale, lengthscale) rel err {json.dumps(g_errs)} "
        f"(tol {K3_GRAD_RTOL:g})")
    if not max(g_errs.values()) <= K3_GRAD_RTOL:
        raise AssertionError("K3's gradient disagrees with autograd of the plain version")
    # the backward of the closed-KL prior (plain torch, FusedKernelMatrix)
    cot = torch.randn(n_lat, n, n, generator=gen, device=dev)
    with la.full_precision():
        bwd = profile_window(lambda: k3.kernel_matrix_backward(*main, cot), 5)
    del cot
    say("kernel", f"K3 backward [{n_lat},{n},{n}]: device {bwd['device_ms']:.4f} ms a call, "
        f"{bwd['kernels_per_call']:g} kernels; top {json.dumps(bwd['top'])}")

    got = k3.kernel_matrix_fused(*main)
    want = k3.kernel_matrix_reference(*main)
    max_abs = float((got - want).abs().max())
    rel = max_rel(got, want)
    del got, want
    rows = []
    for args in (main, cases[1][1], general_walk(main)):
        shape = (args[1].shape[0], args[3].shape[0], args[4].shape[0])
        row = timing_row(shape, args, lambda a: k3.kernel_matrix_fused(*a),
                         lambda a: k3.kernel_matrix_reference(*a), None,
                         kernel_matrix_bound(spec, shape, q))
        row["walk"] = "symmetric" if args[4] is args[3] else "general"
        say("kernel", "K3 times " + json.dumps(row))
        rows.append(row)
    row = rows[0]
    return {
        "name": "kernel_matrix",
        "route": "cuda",
        "source": k3.SOURCE,
        "replaces": k3.REPLACES,
        "launches": None,
        "max_abs_err": max_abs,
        "ms": row["ms"],
        "event_ms": row["event_ms"],
        "plain_ms": row["plain_ms"],
        "plain_event_ms": row["plain_event_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes the additive kernel stack",
        "shape": row["shape"],
        "max_rel_err": rel,
        "per_shape": rows,
        "backward_ms": bwd["device_ms"],
    }


def block_pair_bound(args) -> dict:
    """Least time for K4: read the covariates, mask and both specs'
    parameters and write both stacks once; per entry, latent and spec one
    exp and four flops for each RBF component and two for each other one."""
    spec0, spec1, s0, _, _, _, xb, _ = args
    n_lat, (n_subj, t, q) = s0.shape[0], xb.shape
    pairs = n_lat * n_subj * t * t
    c = len(spec0.components) + len(spec1.components)
    n_rbf = sum(comp.rbf_col >= 0 for comp in spec0.components + spec1.components)
    nbytes = 4 * (2 * pairs + n_subj * t * (q + 1) + 2 * n_lat * c)
    ops = pairs * (5 * n_rbf + 2 * (c - n_rbf))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def k4_args(chain_args):
    """B-chain inputs without σ²: the block pair's (spec0, spec1, s0, g0,
    s1, g1, xb, mask)."""
    return tuple(chain_args[:6]) + tuple(chain_args[7:])


def check_k4(world: World) -> dict:
    """K4 against its plain version on the card, forward and gradient
    (through BlockPair against autograd of the plain version); returns the
    kernels-line entry (without the main path's launches)."""
    gen = torch.Generator(device="cuda").manual_seed(world.seed + 4)
    train = k4_args(world.train_chain_inputs())
    n_lat = world.cfg.latent_dim
    val = k4_args(chain_inputs(gen, world.spec0, world.spec1, n_lat, VAL_SUBJECTS,
                               world.cfg.T))
    cases = [("Hensman batch, smoke cohort", train), ("validation cohort, ragged + ghost", val)]
    cases += [(f"ragged + ghost T={t}", k4_args(chain_inputs(
        gen, world.spec0, world.spec1, 8, 6, t))) for t in (2, 3, 37, 64, 128, 150)]
    cases.append(("S·T² % 4 != 0 (S=7, T=3)", k4_args(chain_inputs(
        gen, world.spec0, world.spec1, 5, 7, 3))))
    comp = kx.KernelComponent
    cat_spec0 = kx.KernelSpec(components=(
        comp(kind="cat_mod", rbf_col=-1, eq_cols=(), and_cols=(), cat_mod=(3, 2)),
        comp(kind="cat_mod_rbf", rbf_col=0, eq_cols=(), and_cols=(4,), cat_mod=(5, 3)),
        *world.spec0.components,
    ))
    cases.append(("cat_mod + both-one spec0, ragged + ghost",
                  k4_args(chain_inputs(gen, cat_spec0, world.spec1, 5, 7, 20))))
    for name, args in cases:
        k0, k1 = k4.block_pair(*args)
        r0, r1 = k4.block_pair_reference(*args)
        torch.cuda.synchronize()
        err = max(max_rel(k0, r0), max_rel(k1, r1))
        w = [torch.randn(k0.shape, generator=gen, device="cuda") for _ in range(2)]
        g_err = grad_rel_err(
            lambda *x: k4.BlockPair.apply(args[0], args[1], *x),
            lambda *x: k4.block_pair_reference(args[0], args[1], *x),
            list(args[2:6]), list(args[6:]), w,
        )
        say("kernel", f"K4 {name} L,S,T={list(k0.shape[:3])}: rel err K0/K1 {err:.3e} "
            f"(tol {K4_RTOL:g}); gradient (s0,g0,s1,g1) {g_err:.3e} (tol {K4_GRAD_RTOL:g})")
        if not (err <= K4_RTOL and g_err <= K4_GRAD_RTOL):
            raise AssertionError(f"K4 disagrees with its plain version at {name}")
        if bool((args[7][-1] == 0).all()) and not (
                bool((k0[:, -1] == 0).all()) and bool((k1[:, -1] == 0).all())):
            raise AssertionError(f"K4 wrote nonzeros into a ghost subject at {name}")
        # every block bitwise symmetric; scalar stores bit-equal to the wrapper's
        asym = bitwise_diff(k0, k0.mT) + bitwise_diff(k1, k1.mT)
        scalar = km_plan.k4_plan(args[2].shape[0], *args[6].shape[:2])._replace(vec=False)
        o0, o1 = k4._launch(*args, scalar)
        diff = bitwise_diff(k0, o0) + bitwise_diff(k1, o1)
        say("kernel", f"K4 {name}: K[l,s] vs K[l,s]ᵀ {asym} entries differ; scalar stores vs "
            f"the wrapper's {diff}")
        if asym or diff:
            raise AssertionError(f"K4 is not bit-equal to itself at {name}")

    k0, k1 = k4.block_pair(*train)
    r0, r1 = k4.block_pair_reference(*train)
    max_abs = max(float((k0 - r0).abs().max()), float((k1 - r1).abs().max()))
    rel = max(max_rel(k0, r0), max_rel(k1, r1))
    rows = []
    for args in (train, val):
        row = timing_row(args[6].shape, args, lambda a: k4.block_pair(*a),
                         lambda a: k4.block_pair_reference(*a), None, block_pair_bound(args))
        row["shape"] = [args[2].shape[0], *args[6].shape[:2]]
        say("kernel", "K4 times " + json.dumps(row))
        rows.append(row)
    row = rows[0]
    return {
        "name": "block_pair",
        "route": "cuda",
        "source": k4.SOURCE,
        "replaces": k4.REPLACES,
        "launches": None,
        "max_abs_err": max_abs,
        "ms": row["ms"],
        "event_ms": row["event_ms"],
        "plain_ms": row["plain_ms"],
        "plain_event_ms": row["plain_event_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,
        "library_call": "none: no single PyTorch call computes the two block stacks",
        "shape": row["shape"],
        "max_rel_err": rel,
        "per_shape": rows,
    }


def adam_bound(n: int) -> dict:
    """Least time for one flat Adam step: read m, v, g and write m', v', Δ
    once (24 bytes an element); a dozen flops an element."""
    bytes_ms = 24 * n / HBM_BYTES_PER_S * 1e3
    ops_ms = 12 * n / F32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def check_k5(world: World, dev: str = "cuda") -> dict:
    """K5 against its plain version for 3 steps at the standard trainer's
    parameter count (the ConvVAE's and the GP's), and FusedAdam against
    torch.optim.Adam on tensors of those shapes; returns the kernels-line
    entry (without the main path's launches)."""
    gen = torch.Generator(device=dev).manual_seed(world.seed + 5)
    shapes = [p.shape for p in world.model().parameters()] + [
        t.shape for t in world.gp.tensors()]
    n = sum(math.prod(s) for s in shapes)
    m = torch.zeros(n, device=dev)
    v = torch.zeros(n, device=dev)
    mr, vr = m.clone(), v.clone()
    errs = []
    max_abs = 0.0
    for step in range(1, 4):
        g = 1e-2 * torch.randn(n, generator=gen, device=dev)
        c1, c2 = k5.bias_corrections(step, 0.9, 0.999)
        kw = dict(b1=0.9, b2=0.999, lr=world.cfg.learning_rate, eps=1e-8, c1=c1, c2=c2)
        d = k5.fused_adam_update(m, v, g, **kw)
        mr, vr, dr = k5.adam_reference(mr, vr, g, **kw)
        torch.cuda.synchronize()
        errs.append(max(max_rel(a, b) for a, b in ((m, mr), (v, vr), (d, dr))))
        max_abs = max([max_abs] + [float((a - b).abs().max()) for a, b in
                                   ((m, mr), (v, vr), (d, dr))])
    say("kernel", f"K5 n={n} 3 steps: rel err (m', v', delta) per step "
        f"{[f'{e:.3e}' for e in errs]} (tol {K5_RTOL:g})")
    if not max(errs) <= K5_RTOL:
        raise AssertionError("K5 disagrees with its plain version")

    count_ulps = k5_count_vs_host(n, gen, world.cfg.learning_rate, dev)
    say("kernel", f"K5 with the step count on the device vs the host-scalar launch, "
        f"{K5_COUNT_STEPS} steps at n={n}: largest difference in ulps (m', v', delta) "
        f"{json.dumps(count_ulps)} (bit-equal predicted)")
    if max(count_ulps.values()) != 0:
        raise AssertionError("K5 with the device count differs from the host-scalar launch")

    # from zero, so that the parameters' own rounding (an ulp of a unit-size
    # weight is 1e-4 of a 1e-3 update) does not hide the updates' agreement
    init = [torch.zeros(s, device=dev) for s in shapes]
    grads = [[1e-2 * torch.randn(s, generator=gen, device=dev) for s in shapes]
             for _ in range(3)]

    def run(make):
        ps = [p.clone().requires_grad_(True) for p in init]
        opt = make(ps)
        for gs in grads:
            for p, gr in zip(ps, gs):
                p.grad = gr
            opt.step()
        return ps, opt

    lr = world.cfg.learning_rate
    ours, _ = run(lambda ps: k5.FusedAdam(ps, lr=lr))
    theirs, _ = run(lambda ps: torch.optim.Adam(ps, lr=lr, fused=True))
    torch_err = max(max_rel(a.detach(), b.detach()) for a, b in zip(ours, theirs))
    say("kernel", f"K5 FusedAdam vs torch.optim.Adam(fused=True), 3 steps: max |delta| over "
        f"the largest update {torch_err:.3e} (tol {K5_TORCH_RTOL:g})")
    if not torch_err <= K5_TORCH_RTOL:
        raise AssertionError("FusedAdam disagrees with torch.optim.Adam")

    # times with the inputs out of L2: four sets of everything in turn
    c1, c2 = k5.bias_corrections(4, 0.9, 0.999)
    kw = dict(b1=0.9, b2=0.999, lr=lr, eps=1e-8, c1=c1, c2=c2)
    sets = [(torch.zeros(n, device=dev), torch.zeros(n, device=dev),
             1e-2 * torch.randn(n, generator=gen, device=dev)) for _ in range(4)]
    lib_opts = [run(lambda ps: torch.optim.Adam(ps, lr=lr, fused=True))[1] for _ in range(4)]
    fused_opts = [run(lambda ps: k5.FusedAdam(ps, lr=lr))[1] for _ in range(4)]
    row = timing_row((n,), None, rotating(lambda a: k5.fused_adam_update(*a, **kw), sets),
                     rotating(lambda a: k5.adam_reference(*a, **kw), sets),
                     rotating(lambda o: o.step(), lib_opts), adam_bound(n))
    step_fused = rotating(lambda o: o.step(), fused_opts)
    row["fused_adam_step_ms"] = profile_window(lambda: step_fused(None), 20)["device_ms"]
    say("kernel", "K5 times " + json.dumps(row))
    return {
        "name": "adam",
        "route": "cuda",
        "source": k5.SOURCE,
        "replaces": k5.REPLACES,
        "launches": None,
        "max_abs_err": max_abs,
        "ms": row["ms"],
        "event_ms": row["event_ms"],
        "plain_ms": row["plain_ms"],
        "plain_event_ms": row["plain_event_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": row["library_ms"],
        "library_event_ms": row["library_event_ms"],
        "library_call": "torch.optim.Adam(fused=True).step over the same tensors",
        "fused_adam_step_ms": row["fused_adam_step_ms"],
        "shape": row["shape"],
        "max_rel_err": max(errs),
        "count_vs_host_ulps": count_ulps,
    }


K5_COUNT_STEPS = 1000


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in units in the last place between two f32
    tensors of one sign pattern (their bit patterns as integers)."""
    return int((a.view(torch.int32).long() - b.view(torch.int32).long()).abs().max())


def k5_count_vs_host(n: int, gen: torch.Generator, lr: float, dev: str) -> dict:
    """K5 over K5_COUNT_STEPS steps with its bias corrections computed on
    the device from the step count there, against the launch that takes
    them as host scalars, on the same gradients: the largest difference in
    ulps of m', v' and delta over the steps."""
    m_a, v_a = torch.zeros(n, device=dev), torch.zeros(n, device=dev)
    m_b, v_b = m_a.clone(), v_a.clone()
    count = torch.zeros((), dtype=torch.int64, device=dev)
    worst = {"m": 0, "v": 0, "delta": 0}
    for step in range(1, K5_COUNT_STEPS + 1):
        g = 1e-2 * torch.randn(n, generator=gen, device=dev)
        c1, c2 = k5.bias_corrections(step, 0.9, 0.999)
        kw = dict(b1=0.9, b2=0.999, lr=lr, eps=1e-8)
        d_a = k5.fused_adam_update(m_a, v_a, g, c1=c1, c2=c2, **kw)
        count.add_(1)
        d_b = k5.fused_adam_update(m_b, v_b, g, count=count, **kw)
        for key, a, b in (("m", m_a, m_b), ("v", v_a, v_b), ("delta", d_a, d_b)):
            worst[key] = max(worst[key], ulps(a, b))
    return worst


# ---------------------------------------------------------------- training
def train(world: World, device: str, h_shift: float = 0.0, cell=None,
          epochs: int = TRAIN_EPOCHS, dtype=torch.float32, roll: bool = False,
          eager: bool = False, compute=None) -> dict:
    """``epochs`` Hensman epochs on ``device`` through ``run_epochs`` (the
    ConvVAE in ``dtype``, or the RNN encoder with ``cell``; either
    computing in ``compute``), from the
    trainer's initial state with ``h_shift``·I added to H; returns the
    per-epoch and per-step metrics, the final (m_nat, H_nat), the kernels
    launched in each step (K1, K2), whether each step's natural-gradient
    update was applied (the PSD-cone guard's decision, read from the device
    with the metrics) and the trainer. On the card the steps replay the
    captured graph; ``eager`` runs the same step function eagerly instead,
    on the same draws. ``roll`` takes each batch's subjects, and their
    noise, from the middle of the batch on (eagerly): the same loss, its
    subject sums added in another order."""
    model = world.rnn_model(cell, compute) if cell else world.model(dtype, compute)
    trainer = world.trainer(device, model, dtype=dtype)
    if h_shift:
        h = trainer.state.H_nat
        trainer.state = trainer.state._replace(
            H_nat=h + h_shift * torch.eye(h.shape[-1], dtype=h.dtype, device=h.device))
    per_step = []
    real_step = trainer._run_step

    def eager_step(b, rows, eps, out):
        table = trainer.tables[b]
        if roll:  # half the batch rolled round, its noise with it
            s, t = rows.shape[0], table.index.shape[1]
            rows = rows.roll(s // 2)
            eps = eps.reshape(s, t, -1).roll(s // 2, 0).reshape(s * t, -1)
        out.copy_(trainer._step(table, rows, eps))
        trainer._advance()

    step = eager_step if (eager or roll) else real_step

    def counted_step(b, rows, eps, out):
        b1, b2 = k1.b_chain.launches, k2.cholesky_inverse.launches
        step(b, rows, eps, out)
        per_step.append((k1.b_chain.launches - b1, k2.cholesky_inverse.launches - b2))

    trainer._run_step = counted_step
    metrics = trainer.run_epochs(epochs)
    trainer._run_step = real_step
    return {
        "epochs": [m._asdict() for m in metrics],
        "steps": [m._asdict() for m, _ in trainer.last_steps],
        "m_nat": trainer.state.m_nat.detach().cpu().double().numpy(),
        "H_nat": trainer.state.H_nat.detach().cpu().double().numpy(),
        "params": [p.detach().cpu().double().numpy()
                   for p in trainer.state.trainables.parameters()],
        "per_step": per_step,
        "ng_applied": [kept for _, kept in trainer.last_steps],
        "trainer": trainer,
    }


def check_training(run: dict) -> None:
    for m in run["epochs"]:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite epoch metrics {m}")
    lam = np.linalg.eigvalsh(run["H_nat"]).min()
    if not lam > 0:
        raise AssertionError(f"H left the PSD cone (smallest eigenvalue {lam:.3e})")


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


LOSS_TOLS = {"recon": LOSS_RTOL, "nll": LOSS_RTOL, "kld": KL_RTOL, "gp": KL_RTOL,
             "net": KL_RTOL}


def compare_losses(card: list, cpu: list, keys=("net", "kld", "recon", "nll")) -> dict:
    """Largest relative card-vs-CPU difference of each loss over the runs'
    steps or epochs."""
    return {key: max(rel(a[key], b[key]) for a, b in zip(card, cpu)) for key in keys}


def compare_variational(card: dict, cpu: dict) -> dict:
    return {key: float(np.abs(card[key] - cpu[key]).max() / np.abs(cpu[key]).max())
            for key in ("m_nat", "H_nat")}


def check_within(errs: dict) -> None:
    """Raise on any card-vs-CPU difference above its tolerance."""
    bad = []
    for what, row in errs.items():
        for key, err in row.items():
            tol = LOSS_TOLS.get(key, VARIATIONAL_RTOL)
            if not err <= tol:
                bad.append(f"{what} {key}: {err:.3e} > {tol:g}")
    if bad:
        raise AssertionError("training card vs CPU: " + "; ".join(bad))


# -------------------------------------------------------- standard training
def launch_counts() -> dict:
    return {"b_chain": k1.b_chain.launches, "chol_inv": k2.cholesky_inverse.launches,
            "kernel_matrix": k3.kernel_matrix_fused.launches,
            "adam": k5.fused_adam_update.launches, "block_pair": k4.block_pair.launches}


def graph_launches(graph: CapturedStep) -> dict:
    """The kernel launches of one replay of ``graph``, by name (its
    ``launches`` follow ``train/graph.COUNTERS``: K1, K2, K3, K4, K5)."""
    return dict(zip(("b_chain", "chol_inv", "kernel_matrix", "block_pair", "adam"),
                    graph.launches))


def set_launch_counts(counts: dict) -> None:
    k1.b_chain.launches = counts["b_chain"]
    k2.cholesky_inverse.launches = counts["chol_inv"]
    k3.kernel_matrix_fused.launches = counts["kernel_matrix"]
    k5.fused_adam_update.launches = counts["adam"]
    k4.block_pair.launches = counts["block_pair"]


def reset_launch_counts() -> None:
    set_launch_counts(dict.fromkeys(launch_counts(), 0))


@contextlib.contextmanager
def uncounted(on: bool = True):
    """With ``on``, the block's launches leave the counts as they were: an
    f32 run that the bf16 path is compared with is not that path's."""
    saved = launch_counts()
    try:
        yield
    finally:
        if on:
            set_launch_counts(saved)


def train_standard(world: World, device: str, type_kl: str, epochs: int,
                   pseudo_minibatch: bool = False, optimizer: str = "adam",
                   subjects=None) -> dict:
    """``epochs`` full-batch epochs (one step each) on ``device``; returns
    the per-epoch metrics, the kernels each step launched, the host-clock
    seconds and the trainer."""
    trainer = world.standard_trainer(device, type_kl, pseudo_minibatch, optimizer, subjects)
    metrics, per_step = [], []
    t0 = time.perf_counter()
    for _ in range(epochs):
        before = launch_counts()
        metrics.append(trainer.run_epoch()._asdict())
        per_step.append({k: v - before[k] for k, v in launch_counts().items()})
    return {"epochs": metrics, "per_step": per_step, "seconds": time.perf_counter() - t0,
            "trainer": trainer}


def check_standard(run: dict, name: str, want: dict) -> None:
    """Finite losses, and per step exactly the launches ``want`` names
    (a count, or None for at least one)."""
    for m in run["epochs"]:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"standard {name}: non-finite epoch metrics {m}")
    for step in run["per_step"]:
        for kernel, n in want.items():
            if (step[kernel] < 1) if n is None else (step[kernel] != n):
                raise AssertionError(f"standard {name}: a step launched {kernel} "
                                     f"{step[kernel]} times, expected {n or 'at least 1'}")


# name: (type_KL, pseudo_minibatch, optimizer, epochs, launches a step on the card)
STANDARD_RUNS = {
    "closed": ("closed", False, "adam", STD_CLOSED_EPOCHS,
               {"kernel_matrix": 1, "adam": 0, "b_chain": 0, "chol_inv": 0}),
    "GPapprox_closed": ("GPapprox_closed", False, "adam", STD_EPOCHS,
                        {"kernel_matrix": 0, "b_chain": 1, "chol_inv": None}),
    "GPapprox": ("GPapprox", False, "adam", STD_EPOCHS,
                 {"kernel_matrix": 0, "b_chain": 1, "chol_inv": None}),
    "GPPVAE GPapprox_closed": ("GPapprox_closed", True, "adam", STD_EPOCHS,
                               {"kernel_matrix": 0, "b_chain": 1, "chol_inv": None}),
    "closed, fused Adam": ("closed", False, "fused", STD_EPOCHS,
                           {"kernel_matrix": 1, "adam": 1}),
}


def standard_path(world: World) -> dict:
    """Every standard run of STANDARD_RUNS at full width on the card, each
    epoch a replay of its captured step (the first epoch the capture's
    warm-up)."""
    runs = {}
    for name, (type_kl, pseudo, opt, epochs, want) in STANDARD_RUNS.items():
        run = train_standard(world, "cuda", type_kl, epochs, pseudo, opt)
        check_standard(run, name, want)
        say("standard", f"{name}: {epochs} epochs in {run['seconds']:.3f} s (first call "
            f"included); launches per step {json.dumps(run['per_step'][0])}; last epoch "
            f"{json.dumps(run['epochs'][-1])}")
        runs[name] = run
    nets = [m["net"] for m in runs["closed"]["epochs"]]
    say("standard", f"closed net loss by epoch {nets}")
    if not nets[-1] < nets[0]:
        raise AssertionError("the closed-KL net loss did not fall over its epochs")
    return runs


STD_LOSS_KEYS = ("net", "gp", "recon", "nll")


def compare_standard(world: World) -> dict:
    """Card against CPU from one state at P=STD_COMPARE_P subjects: per-epoch
    losses of 3 closed epochs (K3 still runs on the card: N = 520) and 2 of
    each other mode."""
    errs = {}
    for name, (type_kl, pseudo, _, epochs, want) in STANDARD_RUNS.items():
        if name.endswith("fused Adam"):
            continue
        if type_kl == "closed":
            epochs = STD_COMPARE_CLOSED_EPOCHS
        card = train_standard(world, "cuda", type_kl, epochs, pseudo, subjects=STD_COMPARE_P)
        cpu = train_standard(world, "cpu", type_kl, epochs, pseudo, subjects=STD_COMPARE_P)
        check_standard(card, name, want)
        check_standard(cpu, name, {k: 0 for k in want})
        errs[name] = compare_losses(card["epochs"], cpu["epochs"], keys=STD_LOSS_KEYS)
        say("standard", f"P={STD_COMPARE_P} {name}: card {json.dumps(card['epochs'][-1])} "
            f"CPU {json.dumps(cpu['epochs'][-1])} ({cpu['seconds']:.1f} s on the CPU)")
    return errs


# epochs of each standard run replayed (the first the capture's warm-up) and eager
STD_GVE_EPOCHS = 3
STD_TIMED = 2  # warm steps of each standard run on the host clock, replayed and eager
STD_CHUNK = 2  # epochs a chunk of the standard fit that rolls back
STD_DROPOUT = 0.25  # the dropout of the run whose replays must draw fresh masks
STD_TRACED = 2  # replayed epochs of each standard run traced in the fresh process
STD_DIR = os.path.join(ROOT, "build", "chip_smoke_standard")  # git-ignored


def std_params(trainer: StandardTrainer) -> list:
    """Every trained tensor of a standard trainer, as numpy (f64)."""
    return [p.detach().cpu().double().numpy() for p in trainer.state.trainables.parameters()]


def compare_std_runs(a: StandardTrainer, b: StandardTrainer) -> dict:
    """Two standard runs: per metric the epochs that differ and the largest
    relative difference, and the same over every trained tensor."""
    out = {key: bit_diff(np.asarray([getattr(m, key) for m in a.history]),
                         np.asarray([getattr(m, key) for m in b.history]))
           for key in STD_LOSS_KEYS}
    diffs = [bit_diff(x, y) for x, y in zip(std_params(a), std_params(b))]
    out["params"] = {"differ": sum(d["differ"] for d in diffs),
                     "rel": max(d["rel"] for d in diffs)}
    out["epochs"] = [len(a.history), len(b.history)]
    return out


def check_std_steps(per_step: list, want: dict, where: str) -> None:
    for got in per_step:
        for kernel, n in want.items():
            if (got[kernel] < 1) if n is None else (got[kernel] != n):
                raise AssertionError(f"{where}: a step launched {json.dumps(got)}, expected "
                                     f"{json.dumps(want)} (None: at least 1)")


def std_graph_vs_eager(world: World, type_kl: str, pseudo: bool, opt: str, want: dict,
                       name: str, compute=None, memory: bool = False) -> dict:
    """One standard run at full width, from one state on one noise:
    STD_GVE_EPOCHS epochs and STD_TIMED + 1 more through the captured step
    (each step's launches on the counters), and the same epochs run eagerly
    (``eager_steps``); the host clock of the STD_TIMED warm steps of each;
    with ``memory`` the peak device memory each run allocates above its
    trainer's state (the replayed run's with its capture) and the memory
    the graph keeps after ``empty_cache``. The caller holds the cuDNN mode."""
    trainers, per_step, times, mem = {}, [], {}, {}
    for mode in ("eager", "replayed"):
        tr = trainers[mode] = world.standard_trainer("cuda", type_kl, pseudo, opt,
                                                     compute=compute)
        if mode == "replayed":
            tr._run_step = counted(tr._run_step, per_step)
        with eager_steps() if mode == "eager" else contextlib.nullcontext():
            if memory:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
                base, reserved = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
            tr.run_epochs(STD_GVE_EPOCHS)
            if memory:
                torch.cuda.synchronize()
                mem[f"{mode}_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
                mem[f"{mode}_peak_above_state_gib"] = (torch.cuda.max_memory_allocated()
                                                       - base) / 2**30
                torch.cuda.empty_cache()
                mem[f"{mode}_kept_gib"] = (torch.cuda.memory_reserved() - reserved) / 2**30
            times[f"{mode}_ms"] = host_ms(tr.run_epoch, STD_TIMED)
        if mode == "replayed":
            del tr._run_step
    replayed, eager = trainers["replayed"], trainers["eager"]
    if len(replayed._graphs) != 1 or eager._graphs:
        raise AssertionError(f"standard {name}: {len(replayed._graphs)} graphs replayed, "
                             f"{len(eager._graphs)} eager")
    check_std_steps(per_step, want, f"standard {name} replayed")
    res = {"graph_vs_eager": compare_std_runs(replayed, eager), "per_step": per_step[-1],
           "per_replay": graph_launches(next(iter(replayed._graphs.values()))),
           "times": times, "memory": mem}
    return res


def standard_graph_vs_eager(world: World) -> dict:
    """Every run of STANDARD_RUNS and a bf16 GPapprox_closed run
    (``model_dtype=bfloat16``) replayed against eager, with cuDNN's
    deterministic algorithms (:func:`std_graph_vs_eager`), each held
    bit-equal; the closed run's memory. Their launches are not the
    standard path's (uncounted)."""
    res = {}
    with deterministic_cudnn(), uncounted():
        for name, (type_kl, pseudo, opt, _, want) in STANDARD_RUNS.items():
            res[name] = std_graph_vs_eager(world, type_kl, pseudo, opt, want, name,
                                           memory=name == "closed")
        res["GPapprox_closed bf16"] = std_graph_vs_eager(
            world, "GPapprox_closed", False, "adam", STANDARD_RUNS["GPapprox_closed"][4],
            "GPapprox_closed bf16", compute=BF16)
    differ = {k: v["graph_vs_eager"] for k, v in res.items()
              if any(d["differ"] for key, d in v["graph_vs_eager"].items() if key != "epochs")}
    if differ:
        raise AssertionError(f"standard graph vs eager on the card: {json.dumps(differ)}")
    return res


def standard_rollback(world: World, root: str) -> dict:
    """GPapprox_closed at full width (cuDNN deterministic): ``fit`` over 2
    chunks of STD_CHUNK epochs through the captured step, with a callback
    that saves the state after chunk 1 and, the first time chunk 2 ends,
    loads it back through the state setter (the graph goes; the chunk runs
    again and captures anew) and rolls back; against an eager ``fit``
    straight through. Held bit-equal."""
    with deterministic_cudnn(), uncounted():
        tr = world.standard_trainer("cuda", "GPapprox_closed")
        path, calls, graphs = os.path.join(root, "std_chunk1.ckpt"), [], []

        def callback(t, done, last):
            calls.append(done)
            graphs.append(len(t._graphs))
            if done == STD_CHUNK:
                save_checkpoint(path, t.state)
            elif calls == [STD_CHUNK, 2 * STD_CHUNK]:
                t.state = load_checkpoint(path, like=t.state)
                if t._graphs:
                    raise AssertionError("the standard state setter kept the graph")
                del t.history[STD_CHUNK:]
                return "rollback"
            return None

        tr.fit(2 * STD_CHUNK, log_every=0, callback=callback, chunk=STD_CHUNK)
        eager = world.standard_trainer("cuda", "GPapprox_closed")
        with eager_steps():
            eager.fit(2 * STD_CHUNK, log_every=0, chunk=STD_CHUNK)
    res = compare_std_runs(tr, eager) | {"calls": calls, "graphs_at_callbacks": graphs}
    if calls != [STD_CHUNK, 2 * STD_CHUNK, 2 * STD_CHUNK] or any(
            d["differ"] for k, d in res.items() if k in STD_LOSS_KEYS + ("params",)):
        raise AssertionError(f"standard fit with a rollback vs eager: {json.dumps(res)}")
    return res


def standard_dropout_replays(world: World) -> dict:
    """GPapprox_closed at full width with dropout STD_DROPOUT and without
    (cuDNN deterministic): the captured step replayed twice from one state
    (its tensors and Adam's written back in place between the replays) on
    one noise. With dropout each replay draws its masks anew, so the two
    differ; without, they are the same bits."""
    out = {}
    with deterministic_cudnn(), uncounted():
        for p in (STD_DROPOUT, 0.0):
            tr = world.standard_trainer("cuda", "GPapprox_closed", dropout=p)
            gen = torch.Generator().manual_seed(world.seed + 3)
            noise = [torch.randn(shape, generator=gen, dtype=dtype).to(tr.device)
                     for shape, dtype in tr._noise_specs()]
            row = torch.empty(4, dtype=tr.dtype, device=tr.device)
            tr._run_step(noise, row)  # the capture, its warm-up this step
            opt = tr.state.opt_state
            held = [*tr.state.trainables.parameters(),
                    *(v for st in opt.state.values() for v in st.values() if torch.is_tensor(v))]
            saved = [t.detach().clone() for t in held]
            rows = []
            for _ in range(2):
                with torch.no_grad():
                    for t, v in zip(held, saved):
                        t.copy_(v)
                tr._run_step(noise, row)
                rows.append(row.cpu().numpy().copy())
            if len(tr._graphs) != 1:
                raise AssertionError(f"dropout {p}: {len(tr._graphs)} graphs")
            out[f"dropout_{p:g}"] = bit_diff(rows[0], rows[1])
    if not out[f"dropout_{STD_DROPOUT:g}"]["differ"] or out["dropout_0"]["differ"]:
        raise AssertionError(f"two replays with and without dropout: {json.dumps(out)}")
    return out


def standard_replay_times(world: World) -> dict:
    """Every run of STANDARD_RUNS at full width in the fresh process: the
    host clock and the profile of a replayed and of an eager step, and the
    K1, K2, K3 and K5 launches of STD_TRACED replayed epochs by name in a
    trace, held to what the graph records."""
    names = ("b_chain", "chol_inv", "kernel_matrix", "adam")
    out = {}
    for name, (type_kl, pseudo, opt, _, want) in STANDARD_RUNS.items():
        tr = world.standard_trainer("cuda", type_kl, pseudo, opt)
        tr.run_epoch()  # the capture
        graph = next(iter(tr._graphs.values()))
        res = {"replay_launches": graph_launches(graph),
               "replayed": {"step_ms": host_median_ms(tr.run_epoch, 3),
                            "profile": profile_window(tr.run_epoch, 2)}}
        with eager_steps():
            res["eager"] = {"step_ms": host_median_ms(tr.run_epoch, 2),
                            "profile": profile_window(tr.run_epoch, 1)}
        res["traced"] = traced_launches(lambda: tr.run_epochs(STD_TRACED), names)
        if len(tr._graphs) != 1:
            raise AssertionError(f"standard {name}: the traced epochs captured again")
        check_std_steps([res["replay_launches"]], want, f"standard {name} graph")
        res["want"] = {k: STD_TRACED * res["replay_launches"][k] for k in names}
        out[name] = res
        del tr, graph
    return out


# ---------------------------------------------------------------- pipeline
PIPE_DIR = os.path.join(ROOT, "build", "chip_smoke_pipeline")  # git-ignored
PIPE_PER_DIGIT = 50  # training cohort: 50 + 50 subjects, the config file's P = 100
PIPE_EVAL_PER_DIGIT = 10  # validation and test cohorts: 10 + 10 subjects each
PRETRAIN_EPOCHS = 2
PIPE_EPOCHS, PIPE_TEST_FREQ = 4, 2  # main run: validation and checkpoint every 2 epochs
RESUME_EPOCHS = 2
K4_EPOCHS = 2  # the K4 route's run, validation every epoch
# kernel launches of one training step and one validation on each route
# (K2: the stacked [K0zz; H], the natural-gradient inversion and the new H's
# factor a step, K0zz a validation, and on the K4 route the B stack in each)
ROUTE_LAUNCHES = {
    "k1": {"step": {"b_chain": 1, "block_pair": 0, "chol_inv": 3},
           "validation": {"b_chain": 1, "block_pair": 0, "chol_inv": 1}},
    "k4": {"step": {"b_chain": 0, "block_pair": 1, "chol_inv": 4},
           "validation": {"b_chain": 0, "block_pair": 1, "chol_inv": 2}},
}
PIPE_ARTEFACTS = ("model_params_vae.ckpt", "model_best.ckpt", "model_final.ckpt",
                  "model_last.ckpt", "result_error.csv", "result_error_best.csv",
                  "recon_complete.npz", "recon_complete_best.npz", "plot_values.pkl",
                  "diagnostics.pkl", "metrics.jsonl")


def write_flags(path: str, lines) -> str:
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def make_pipeline_data(root: str, seed: int) -> str:
    """Train, validation and test splits from the port's generator; the
    test split is also the prediction and generation cohort."""
    data = os.path.join(root, "data")
    for suffix, n, s in (("", PIPE_PER_DIGIT, seed), ("_validation", PIPE_EVAL_PER_DIGIT, seed + 1),
                         ("_test", PIPE_EVAL_PER_DIGIT, seed + 2)):
        generate_healthmnist(
            n, n, seed=s, destination=data, data_file_name=f"health_MNIST_data{suffix}.csv",
            data_masked_file_name=f"health_MNIST_data_masked{suffix}.csv",
            labels_file_name=f"health_MNIST_label{suffix}.csv", mask_file_name=f"mask{suffix}.csv")
    return data


def pipeline_flags(data: str, results: str, *extra) -> list:
    """The config file with the run's paths and ``extra`` over it."""
    lines = [f"--f={CONFIG}", f"--data_source_path={data}", f"--save_path={results}",
             f"--results_path={results}"]
    for split, suffix in (("test", "_test"), ("prediction", "_test"), ("generation", "_test"),
                          ("validation", "_validation")):
        lines += [f"--csv_file_{split}_data=health_MNIST_data_masked{suffix}.csv",
                  f"--csv_file_{split}_label=health_MNIST_label{suffix}.csv",
                  f"--{split}_mask_file=mask{suffix}.csv"]
    return lines + list(extra)


def counted(fn, into: list):
    """``fn`` that appends the kernel launches of each call to ``into``."""
    def wrapped(*args, **kwargs):
        before = launch_counts()
        out = fn(*args, **kwargs)
        into.append({k: v - before[k] for k, v in launch_counts().items()})
        return out
    return wrapped


class PathCounter:
    """While active: the kernel launches of every Hensman step of the epoch
    program (``_run_step``: a replay of the captured step, or the capture
    with its warm-up step) and every pipeline ``validate`` call, and the
    pipeline ``cli.main`` ran."""

    def __enter__(self):
        self.steps, self.validations, self.pipeline = [], [], None
        self._saved = (HensmanTrainer._run_step, pipeline_mod.validate,
                       pipeline_mod.LVAEPipeline.run)
        step, validate, run = self._saved
        counter = self

        def keep_run(pipe):
            counter.pipeline = pipe
            return run(pipe)

        HensmanTrainer._run_step = counted(step, self.steps)
        pipeline_mod.validate = counted(validate, self.validations)
        pipeline_mod.LVAEPipeline.run = keep_run
        return self

    def __exit__(self, *exc):
        (HensmanTrainer._run_step, pipeline_mod.validate,
         pipeline_mod.LVAEPipeline.run) = self._saved
        return False

    def check(self, route: str, n_steps: int, n_validations: int, where: str) -> None:
        """Exactly ``n_steps`` steps and ``n_validations`` validations, each
        with the route's launches."""
        if len(self.steps) != n_steps or len(self.validations) != n_validations:
            raise AssertionError(f"{where}: {len(self.steps)} steps and {len(self.validations)} "
                                 f"validations, expected {n_steps} and {n_validations}")
        for kind, calls in (("step", self.steps), ("validation", self.validations)):
            want = ROUTE_LAUNCHES[route][kind]
            for got in calls:
                if any(got[k] != n for k, n in want.items()):
                    raise AssertionError(f"{where}: a {kind} launched {json.dumps(got)}, "
                                         f"expected {json.dumps(want)}")


def cli_run(args, device: str) -> float:
    """``lvae_torch.cli.main(args)`` on ``device``; returns its seconds."""
    t0 = time.perf_counter()
    rc = cli.main(list(args) + ([f"--device={device}"] if device != "cuda" else []))
    if rc != 0:
        raise AssertionError(f"cli.main({args}) returned {rc}")
    if device == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0


def check_pipeline_run(results: str, epochs: int, hw: int, artefacts=PIPE_ARTEFACTS) -> dict:
    """Every artefact present; losses, test MSEs and the generation grid
    (where ``artefacts`` name it) finite."""
    missing = [a for a in artefacts if not os.path.exists(os.path.join(results, a))]
    if missing:
        raise AssertionError(f"pipeline artefacts missing: {missing}")
    with open(os.path.join(results, "diagnostics.pkl"), "rb") as f:
        hist = pickle.load(f)
    if len(hist) != epochs or not all(math.isfinite(v) for m in hist for v in m.values()):
        raise AssertionError(f"pipeline losses: {hist}")
    errs = {name: np.loadtxt(os.path.join(results, name)).tolist()
            for name in ("result_error.csv", "result_error_best.csv")}
    if not all(np.isfinite(v).all() and len(v) == 2 for v in errs.values()):
        raise AssertionError(f"test MSEs: {errs}")
    if "recon_complete.npz" in artefacts:
        grid = np.load(os.path.join(results, "recon_complete.npz"))
        if grid["grid"].shape[1:] != (20, hw, hw) or not np.isfinite(grid["grid"]).all() \
                or not grid["filled"].any():
            raise AssertionError(f"generation grid {grid['grid'].shape}")
    return {"losses": hist[-1], "test_mse": errs}


def run_pipeline(world: World, root: str, device: str = "cuda") -> dict:
    """The CLI workflow at the config file's width: generate, pre-train, the
    main run (validation, best model, tests, generation, checkpoints) and a
    resumed run. Returns stage seconds, launches and the main results."""
    cfg, hw = world.cfg, world.hw
    times = {}
    t0 = time.perf_counter()
    data = make_pipeline_data(root, world.seed)
    times["generate"] = time.perf_counter() - t0
    results = os.path.join(root, "results")
    vae_cfg = write_flags(os.path.join(root, "vae.txt"), [
        f"--data_source_path={data}", f"--save_path={results}", "--dataset_type=HealthMNIST",
        "--csv_file_data=health_MNIST_data_masked.csv", "--csv_file_label=health_MNIST_label.csv",
        "--mask_file=mask.csv", f"--type_nnet={cfg.type_nnet}", f"--latent_dim={cfg.latent_dim}",
        f"--num_dim={cfg.num_dim}", f"--epochs={PRETRAIN_EPOCHS}", "--loss_function=nll",
        f"--dropout={cfg.dropout}", f"--seed={world.seed}"])
    times["pretrain"] = cli_run(["pretrain", f"--f={vae_cfg}"], device)

    main_cfg = write_flags(os.path.join(root, "main.txt"), pipeline_flags(
        data, results, f"--epochs={PIPE_EPOCHS}", f"--test_freq={PIPE_TEST_FREQ}",
        f"--checkpoint_every={PIPE_TEST_FREQ}", "--run_tests=True", "--run_validation=True",
        "--generate_images=True", f"--model_params={results}/model_params_vae.ckpt",
        "--gp_model_folder=", f"--seed={world.seed}"))
    reset_launch_counts()
    with PathCounter() as main_run:
        times["train"] = cli_run([f"--f={main_cfg}"], device)
    counts = launch_counts()
    steps_per_epoch = main_run.pipeline.trainer.tables[0].index.shape[0] // cfg.subjects_per_batch
    out = check_pipeline_run(results, PIPE_EPOCHS, hw)
    final = read_checkpoint(os.path.join(results, "model_final.ckpt"))

    resumed = os.path.join(root, "resumed")
    resume_cfg = write_flags(os.path.join(root, "resume.txt"), pipeline_flags(
        data, resumed, f"--epochs={RESUME_EPOCHS}", f"--test_freq={RESUME_EPOCHS}",
        f"--checkpoint_every={RESUME_EPOCHS}", "--run_validation=True",
        f"--gp_model_folder={results}", f"--seed={world.seed}"))
    times["resume"] = cli_run([f"--f={resume_cfg}"], device)
    step = read_checkpoint(os.path.join(resumed, "model_final.ckpt"))["step"]
    if step != final["step"] + RESUME_EPOCHS * steps_per_epoch:
        raise AssertionError(f"the resumed run ended at step {step}, not at "
                             f"{final['step']} + {RESUME_EPOCHS * steps_per_epoch}")
    return {"times": times, "counts": counts, "counter": main_run, "data": data,
            "results": results, "steps_per_epoch": steps_per_epoch, "final_step": final["step"],
            "resumed_step": step, **out}


def use_route(route: str) -> None:
    """K1 (the default, None: on for CUDA tensors) or K4 (K1 off, the
    block-pair switch on)."""
    kx.use_b_chain_kernel = None if route == "k1" else False
    kx.use_block_pair_kernel = route == "k4"


def run_pipeline_k4(world: World, root: str, run: dict, device: str = "cuda") -> dict:
    """K4_EPOCHS epochs with validation every epoch on the K4 route, resumed
    from the main run's ``model_final.ckpt``."""
    results = os.path.join(root, "k4")
    k4_cfg = write_flags(os.path.join(root, "k4.txt"), pipeline_flags(
        run["data"], results, f"--epochs={K4_EPOCHS}", "--test_freq=1", "--checkpoint_every=1",
        "--run_validation=True", f"--gp_model_folder={run['results']}", f"--seed={world.seed}"))
    use_route("k4")
    try:
        reset_launch_counts()
        with PathCounter() as k4_run:
            seconds = cli_run([f"--f={k4_cfg}"], device)
        counts = launch_counts()
    finally:
        use_route("k1")
    with open(os.path.join(results, "diagnostics.pkl"), "rb") as f:
        hist = pickle.load(f)
    if not all(math.isfinite(v) for m in hist for v in m.values()):
        raise AssertionError(f"K4 route losses: {hist}")
    return {"seconds": seconds, "counts": counts, "counter": k4_run, "losses": hist[-1]}


def resumed_pipeline(root: str, run: dict, device: str):
    """A pipeline on ``device`` whose trainer holds the main run's final
    state (resumed from its folder), with the validation and test cohorts."""
    cfg, _ = parse_flag_lines(pipeline_flags(
        run["data"], os.path.join(root, f"replay_{device}"), "--run_tests=True",
        "--run_validation=True", f"--gp_model_folder={run['results']}"))
    pipe = pipeline_mod.LVAEPipeline(cfg, device=device)
    pipe.build_trainer()
    return pipe


def compare_routes(pipe) -> dict:
    """One full-width ``batch_loss`` and its gradients from one state on the
    K1 and the K4 route; returns the relative differences."""
    trainer = pipe.trainer
    state = trainer.state
    table = trainer.tables[0]
    rows = torch.arange(trainer.subjects_per_batch, device=trainer.device)
    idx, bmask = table.index[rows], table.mask[rows]
    p_batch = torch.sum(rows < table.num_real).to(bmask.dtype)
    eps = torch.randn((idx.numel(), trainer.cfg.latent_dim),
                      generator=torch.Generator().manual_seed(7))
    params = list(state.trainables.parameters())
    out = {}
    for route in ("k1", "k4"):
        use_route(route)
        for p in params:
            p.grad = None
        before = launch_counts()
        net, (metrics, _) = hensman_batch_loss(trainer.model, trainer.cfg, state.trainables,
                                               state.m_nat, state.H_nat, trainer.tdata, idx,
                                               bmask, p_batch, eps=eps)
        net.backward()
        launched = {k: v - before[k] for k, v in launch_counts().items()}
        out[route] = ({k: float(v) for k, v in metrics._asdict().items()},
                      [None if p.grad is None else p.grad.clone() for p in params], launched)
    use_route("k1")
    (m1, g1, l1), (m4, g4, l4) = out["k1"], out["k4"]
    if l1["b_chain"] != 1 or l1["block_pair"] or l4["block_pair"] != 1 or l4["b_chain"]:
        raise AssertionError(f"route launches: K1 route {l1}, K4 route {l4}")
    errs = {key: rel(m4[key], m1[key]) for key in ("net", "kld", "recon", "nll")}
    grad_errs = []
    for a, b in zip(g4, g1):
        if a is None or b is None:
            if (a is None) != (b is None):
                raise AssertionError("one route left a trainable without a gradient")
            continue
        scale = float(b.abs().max())
        grad_errs.append(float((a - b).abs().max()) / scale if scale else float((a - b).abs().max()))
    errs["gradients"] = max(grad_errs)
    return errs


def check_route_errs(errs: dict) -> None:
    tols = {"net": KL_RTOL, "kld": KL_RTOL, "recon": LOSS_RTOL, "nll": LOSS_RTOL,
            "gradients": KL_RTOL}
    bad = [f"{k} {v:.3e} > {tols[k]:g}" for k, v in errs.items() if not v <= tols[k]]
    if bad:
        raise AssertionError("K4 route vs K1 route: " + "; ".join(bad))


def pipe_validate(pipe):
    """The pipeline's ``validate`` of its current state, quietly."""
    cfg = pipe.cfg
    model, gp, noise = pipe.current_params()
    return pipeline_mod.validate(
        model, gp, noise, pipe.spec0, pipe.spec1, pipe.validation_dataset, pipe.trainer.tdata.z,
        cfg.id_covariate, cfg.weight, cfg.loss_function, cfg.latent_dim, cfg.eps,
        type_kl=cfg.type_KL, verbose=False, device=pipe.device)


def evaluate_pipeline(pipe) -> dict:
    """``validate`` and ``mse_test_gp_approx`` of the pipeline's state on
    its own device (the sampled reconstructions draw from a generator
    seeded 0 on both devices)."""
    cfg = pipe.cfg
    model, gp, noise = pipe.current_params()
    val = pipe_validate(pipe)
    px, pmu = pipe.encode_prediction_cohort()
    test = mse_test_gp_approx(model, gp, noise, pipe.spec0, pipe.spec1, pipe.test_dataset, px,
                              pmu, pipe.trainer.tdata.z, cfg.id_covariate, cfg.eps,
                              verbose=False, device=pipe.device)
    return {**val._asdict(), **test._asdict()}


def compare_pipeline(card: dict, cpu: dict) -> dict:
    errs = {key: rel(card[key], cpu[key]) for key in card}
    tols = {"net": KL_RTOL, "gp": KL_RTOL, "nll": LOSS_RTOL, "recon": LOSS_RTOL,
            "vae_mse": LOSS_RTOL, "gp_mse": LOSS_RTOL}
    bad = [f"{k} {v:.3e} > {tols[k]:g}" for k, v in errs.items() if not v <= tols[k]]
    if bad:
        raise AssertionError("pipeline card vs CPU: " + "; ".join(bad))
    return errs


# ------------------------------------------------------- evaluation programs
# validation modes of the [eval] phase: (type_KL, kernel route, num_samples)
EVAL_MODES = (("GPapprox_closed", "k1", 1), ("GPapprox", "k1", 3), ("GPapprox_closed", "k4", 1))
EXACT_CAP = 6040  # the reference's cap on the exact regression's prediction cohort
EXACT_SUBJECTS = 310  # a generated prediction cohort of 6,200 rows, cut to the cap
EXACT_COMPARE_CAP = 520  # rows of the card-vs-CPU exact regression


def eval_cohorts(pipe) -> dict:
    """The validation cohorts of the [eval] phase: the pipeline's own (20
    subjects, 400 frames) and its training cohort (100 subjects, 2,000)."""
    return {"val20": pipe.validation_dataset, "val100": pipe.dataset}


def eval_validate(pipe, ds, type_kl: str, num_samples: int):
    """The pipeline's ``validate`` of its state on ``ds``, quietly."""
    cfg = pipe.cfg
    model, gp, noise = pipe.current_params()
    return pipeline_mod.validate(
        model, gp, noise, pipe.spec0, pipe.spec1, ds, pipe.trainer.tdata.z, cfg.id_covariate,
        cfg.weight, cfg.loss_function, cfg.latent_dim, cfg.eps, type_kl=type_kl,
        num_samples=num_samples, verbose=False, device=pipe.device)


def eval_answers(pipe, root: str) -> dict:
    """Every evaluation program's answers from the pipeline's state, as host
    arrays, and the launches of each call: validation of both cohorts in
    each of EVAL_MODES, the prediction cohort's encoding, the 2,000-frame
    training cohort encoded and decoded, ``mse_test_gp_approx`` and the
    generation grid (of the test cohort, into ``root``)."""
    cfg, dev = pipe.cfg, pipe.device
    model, gp, noise = pipe.current_params()
    out, launches = {}, {}

    def call(name, fn, *args, **kwargs):
        before = launch_counts()
        got = fn(*args, **kwargs)
        launches[name] = {k: v - before[k] for k, v in launch_counts().items() if v - before[k]}
        return got

    try:
        for cohort, ds in eval_cohorts(pipe).items():
            for type_kl, route, samples in EVAL_MODES:
                use_route(route)
                name = f"validate_{cohort}_{type_kl}_{route}"
                out[name] = np.asarray(call(name, eval_validate, pipe, ds, type_kl, samples))
    finally:
        use_route("k1")
    px, pmu = call("encode_prediction_cohort", pipe.encode_prediction_cohort)
    out["encode_prediction_cohort"] = pmu
    data = dataset_tensor(pipe.dataset.data, model.raw_log_vy.dtype, dev)
    out["encode_2000_mu"], out["encode_2000_log_var"] = call(
        "encode_2000", encode_dataset, model, data, device=dev)
    out["decode_2000"] = call("decode_2000", decode_latents, model, out["encode_2000_mu"],
                              device=dev)
    out["mse_test_gp_approx"] = np.asarray(call(
        "mse_test_gp_approx", mse_test_gp_approx, model, gp, noise, pipe.spec0, pipe.spec1,
        pipe.test_dataset, px, pmu, pipe.trainer.tdata.z, cfg.id_covariate, cfg.eps,
        verbose=False, device=dev))
    grid = call("generation", recon_complete_gen, pipe.test_dataset, model, gp, noise, pipe.spec0,
                pipe.spec1, px, pmu, pipe.trainer.tdata.z, cfg.id_covariate, root, eps=cfg.eps,
                verbose=False, device=dev)
    out["generation"] = np.load(grid)["grid"]
    return {"answers": out, "launches": launches}


def check_eval_launches(launches: dict, where: str) -> None:
    """Each validation launched its route's kernels (ROUTE_LAUNCHES), the
    GP posterior of the test and of the generation K2 once, the encodes
    and decodes nothing of ours."""
    for name, got in launches.items():
        if name.startswith("validate_"):
            want = {k: v for k, v in ROUTE_LAUNCHES[name.rsplit("_", 1)[1]]["validation"].items()
                    if v}
        elif name in ("mse_test_gp_approx", "generation"):
            want = {"chol_inv": 1}
        else:
            want = {}
        if got != want:
            raise AssertionError(f"{where}: {name} launched {json.dumps(got)}, expected "
                                 f"{json.dumps(want)}")


def eval_graph_keys(pipe) -> set:
    """The keys of the evaluation graphs of the pipeline's model and of the
    GP programs on its card."""
    model = pipe.current_params()[0]
    return (set(eval_programs.graphs_of(model, pipe.device))
            | set(eval_programs.graphs_of(None, pipe.trainer.tdata.z.device)))


def eval_graph_vs_eager(pipe, root: str) -> dict:
    """The [eval] phase's bit-equality: every program once to capture, then
    replayed (capturing nothing) and eagerly (cuDNN deterministic), the
    launches of each call checked; entries that differ between the replayed
    and eager answers."""
    runs = {}
    with deterministic_cudnn():
        for name in ("capture", "replayed", "eager"):
            keys = eval_graph_keys(pipe)
            with eager_steps() if name == "eager" else contextlib.nullcontext():
                runs[name] = eval_answers(pipe, os.path.join(root, name))
            check_eval_launches(runs[name]["launches"], f"[eval] {name}")
            if name == "replayed" and eval_graph_keys(pipe) != keys:
                raise AssertionError(f"[eval] the replayed run captured again: "
                                     f"{len(eval_graph_keys(pipe) - keys)} new graphs")
    replayed, eager = runs["replayed"]["answers"], runs["eager"]["answers"]
    return {"graph_vs_eager": {k: bit_diff(replayed[k], eager[k])["differ"] for k in replayed},
            "launches": runs["replayed"]["launches"], "graphs": len(eval_graph_keys(pipe)),
            "mu_2000": replayed["encode_2000_mu"]}


def exact_test(pipe, labels: np.ndarray, mu: np.ndarray, cap: int):
    """``mse_test_exact`` of the pipeline's state on its test cohort (400
    rows), the prediction cohort ``labels``/``mu`` cut to ``cap`` rows."""
    model, gp, noise = pipe.current_params()
    spec_full, kp_full = kx.join_specs(pipe.spec0, pipe.spec1, gp.kp0, gp.kp1)
    return mse_test_exact(model, kp_full, spec_full, noise, pipe.test_dataset, labels, mu,
                          pipe.cfg.eps, max_prediction_rows=cap, verbose=False,
                          device=pipe.device)


@torch.no_grad()
def exact_on(pipe, mu_2000: np.ndarray, cap: int = EXACT_COMPARE_CAP) -> dict:
    """:func:`exact_test` on the training cohort (encoded on the card:
    ``mu_2000``) at ``cap`` rows, and its latents and decoded frames, the
    same regression run step by step."""
    dev, f32 = pipe.device, torch.float32
    model, gp, noise = pipe.current_params()
    spec_full, kp_full = kx.join_specs(pipe.spec0, pipe.spec1, gp.kp0, gp.kp1)
    labels = np.asarray(pipe.dataset.labels)
    res = exact_test(pipe, labels, mu_2000, cap)
    px, pmu = cap_prediction_rows(labels, mu_2000, cap)
    z = exact_gp_predict_per_dim(
        spec_full, kp_full.to(device=dev, dtype=f32), on_device(px, f32, dev),
        on_device(pipe.test_dataset.labels, f32, dev), on_device(noise, f32, dev),
        on_device(pmu, f32, dev), eps=pipe.cfg.eps)
    return {**res._asdict(), "latents": z.cpu().numpy(),
            "frames": decode_latents(model, z, device=dev)}


def compare_exact(card: dict, cpu: dict) -> dict:
    """Card against CPU: latents (max |Δ| over max |CPU|) <= LATENT_RTOL,
    frames (max |Δ|) <= FRAME_ATOL, the test MSEs <= LOSS_RTOL relative."""
    errs = {"latents": rel_np(card["latents"], cpu["latents"]),
            "frames": float(np.abs(card["frames"] - cpu["frames"]).max()),
            "vae_mse": rel(card["vae_mse"], cpu["vae_mse"]),
            "gp_mse": rel(card["gp_mse"], cpu["gp_mse"])}
    tols = {"latents": LATENT_RTOL, "frames": FRAME_ATOL, "vae_mse": LOSS_RTOL,
            "gp_mse": LOSS_RTOL}
    bad = [f"{k} {v:.3e} > {tols[k]:g}" for k, v in errs.items() if not v <= tols[k]]
    if bad:
        raise AssertionError("mse_test_exact card vs CPU: " + "; ".join(bad))
    return errs


def exact_cohort(world: World, pipe):
    """A generated prediction cohort of EXACT_SUBJECTS subjects (6,200 rows,
    over the EXACT_CAP cap), encoded by the pipeline's model on the card:
    its labels and latent means."""
    frames, labels = make_cohort(np.random.default_rng(world.seed + 7),
                                 range(5000, 5000 + EXACT_SUBJECTS), world.cfg.T, world.hw)
    mu, _ = encode_dataset(pipe.current_params()[0], frames, device=pipe.device)
    return labels, mu


def eval_phase(world: World, card_pipe, cpu_pipe, root: str) -> dict:
    """The [eval] phase in the main process (its traces are taken in the
    fresh process): replayed against eager, the launches, host-clock
    validation times, ``mse_test_exact`` on the card at the cap and against
    the CPU at EXACT_COMPARE_CAP rows."""
    out = eval_graph_vs_eager(card_pipe, root)
    mu_2000 = out.pop("mu_2000")
    times = {}
    for cohort, ds in eval_cohorts(card_pipe).items():
        fn = functools.partial(eval_validate, card_pipe, ds, "GPapprox_closed", 1)
        times[cohort] = {"replayed_ms": host_ms(fn, 5)}
        with eager_steps():
            times[cohort]["eager_ms"] = host_ms(fn, 3)
    out["validation_host_ms"] = times
    card = exact_on(card_pipe, mu_2000)
    cpu = exact_on(cpu_pipe, mu_2000)
    out["exact_compare"] = {"card": {k: card[k] for k in ("vae_mse", "gp_mse")},
                            "cpu": {k: cpu[k] for k in ("vae_mse", "gp_mse")},
                            "errs": compare_exact(card, cpu)}
    labels, mu = exact_cohort(world, card_pipe)
    full_ms, results = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(exact_test(card_pipe, labels, mu, EXACT_CAP))
        torch.cuda.synchronize()
        full_ms.append((time.perf_counter() - t0) * 1e3)
    if not all(math.isfinite(v) for r in results for v in r):
        raise AssertionError(f"mse_test_exact at the {EXACT_CAP}-row cap: {results}")
    out["exact_full"] = {"host_ms": full_ms, "results": [r._asdict() for r in results],
                         "rows": int(labels.shape[0])}
    return out


def eval_profiles(world: World, pipe) -> dict:
    """The [eval] phase's traces: first the kernels of TRACED_REPLAYS
    replayed validations on each route and of as many replayed posteriors,
    by name; then each validation (both cohorts, EVAL_MODES) replayed and
    eager, the encode and decode of 2,000 rows, ``recon_mse``
    (``vae_test``) and the GP posterior of the test cohort, replayed and
    eager; ``mse_test_exact`` at the cap."""
    cfg, dev = pipe.cfg, pipe.device
    model, gp, noise = pipe.current_params()
    px, pmu = pipe.encode_prediction_cohort()
    data = dataset_tensor(pipe.dataset.data, model.raw_log_vy.dtype, dev)
    mu, _ = encode_dataset(model, data, device=dev)
    programs = {
        "encode_2000": lambda: encode_dataset(model, data, device=dev),
        "decode_2000": lambda: decode_latents(model, mu, device=dev),
        "recon_mse": lambda: vae_test(model, pipe.test_dataset, verbose=False, device=dev),
        "gp_predict": lambda: predict_latents(
            pipe.spec0, pipe.spec1, gp.kp0, gp.kp1, noise, px, pmu, pipe.test_dataset.labels,
            pipe.trainer.tdata.z, cfg.id_covariate, cfg.eps)}
    seconds, t0 = {}, time.perf_counter()
    traced = {}
    try:
        for route in ("k1", "k4"):
            use_route(route)
            fn = functools.partial(eval_validate, pipe, pipe.validation_dataset,
                                   "GPapprox_closed", 1)
            fn()  # the capture
            traced[f"validate_{route}"] = traced_launches(
                lambda: [fn() for _ in range(TRACED_REPLAYS)], ("b_chain", "chol_inv", "block_pair"))
    finally:
        use_route("k1")
    programs["gp_predict"]()
    traced["gp_predict"] = traced_launches(
        lambda: [programs["gp_predict"]() for _ in range(TRACED_REPLAYS)])
    seconds["traced"], t0 = time.perf_counter() - t0, time.perf_counter()
    out = {}
    try:
        for cohort, ds in eval_cohorts(pipe).items():
            for type_kl, route, samples in EVAL_MODES:
                use_route(route)
                fn = functools.partial(eval_validate, pipe, ds, type_kl, samples)
                name = f"validate_{cohort}_{type_kl}_{route}"
                out[f"{name}_replayed"] = profile_window(fn, 2)
                with eager_steps():
                    out[f"{name}_eager"] = profile_window(fn, 1)
    finally:
        use_route("k1")
    seconds["validation"], t0 = time.perf_counter() - t0, time.perf_counter()
    for name, fn in programs.items():
        out[f"{name}_replayed"] = profile_window(fn, 2)
        with eager_steps():
            out[f"{name}_eager"] = profile_window(fn, 1)
    seconds["programs"], t0 = time.perf_counter() - t0, time.perf_counter()
    labels, emu = exact_cohort(world, pipe)
    out["exact_full"] = profile_window(lambda: exact_test(pipe, labels, emu, EXACT_CAP), 1)
    seconds["exact"] = time.perf_counter() - t0
    return {"profiles": out, "traced": traced, "seconds": seconds}


def eval_replay_profiles(seed: int, data: str, results: str) -> dict:
    """Rank side of a world of one: :func:`eval_profiles` from the CLI run's
    resumed pipeline (``data`` and ``results`` its folders), in a fresh
    process of its own, its traced replays before any other trace."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    pipe = resumed_pipeline(PIPE_DIR, {"data": data, "results": results}, "cuda")
    return eval_profiles(World(seed), pipe)


# ---------------------------------------------------------------------- VI
VI_EPOCHS = 3  # phase-1 steps of the CLI run (one an epoch, the whole cohort)
VI_RESUME_EPOCHS = 2
VI_COMPARE_STEPS = 3  # phase-1 steps replayed on the card and the CPU from model_vi.ckpt
VI_COMPARE_PRED_STEPS = 4  # phase-2 steps replayed likewise (the CLI run takes 1000)


class VICounter:
    """While active: the kernel launches of every phase-1 step of
    ``VITrainer.fit`` (``_run_step``: a replay of the captured step, or the
    capture with its warm-up step) and of each phase 2
    (``optimize_prediction_set``), and the trainer."""

    def __enter__(self):
        self.steps, self.predictions, self.trainer = [], [], None
        self._saved = (VITrainer._run_step, VITrainer.optimize_prediction_set)
        step, pred = self._saved
        counter = self

        def keep(trainer, *args, **kwargs):
            counter.trainer = trainer
            return step(trainer, *args, **kwargs)

        VITrainer._run_step = counted(keep, self.steps)
        VITrainer.optimize_prediction_set = counted(pred, self.predictions)
        return self

    def __exit__(self, *exc):
        VITrainer._run_step, VITrainer.optimize_prediction_set = self._saved
        return False

    def check(self, n_steps: int, n_predictions: int, where: str) -> None:
        """``n_steps`` phase-1 steps, each K1 and K2 once on the counters (a
        replay adds its graph's record, which the fresh process's traces
        hold against the kernels that ran); ``n_predictions`` phase-2 runs,
        each K1 and K2 once (its operators are built once, its steps launch
        neither)."""
        if len(self.steps) != n_steps or len(self.predictions) != n_predictions:
            raise AssertionError(f"{where}: {len(self.steps)} steps and {len(self.predictions)} "
                                 f"phase-2 runs, expected {n_steps} and {n_predictions}")
        for got in self.steps:
            if got["b_chain"] != 1 or got["chol_inv"] != 1:
                raise AssertionError(f"{where}: a phase-1 step launched {json.dumps(got)}, "
                                     "expected K1 and K2 once")
        for got in self.predictions:
            if got["b_chain"] != 1 or got["chol_inv"] != 1:
                raise AssertionError(f"{where}: phase 2 launched {json.dumps(got)}, expected "
                                     "K1 and K2 once")


def vi_flags(run: dict, results: str, *extra) -> list:
    return pipeline_flags(
        run["data"], results, "--variational_inference_training=True", "--hensman=False",
        "--run_tests=False", "--run_validation=False",
        f"--model_params={run['results']}/model_params_vae.ckpt", *extra)


def run_vi(world: World, root: str, run: dict, device: str = "cuda") -> dict:
    """The VI regime through ``lvae_torch.cli.main`` on the pipeline's data
    and pre-trained VAE: VI_EPOCHS phase-1 epochs over the whole P=100
    cohort, phase 2 (1000 steps) on the test split, generation; then a run
    resumed from ``model_vi.ckpt`` (phase 1 only). Returns seconds, launches
    and the results."""
    results = os.path.join(root, "vi")
    cfg_path = write_flags(os.path.join(root, "vi.txt"), vi_flags(
        run, results, f"--epochs={VI_EPOCHS}", "--generate_images=True", "--gp_model_folder=",
        f"--seed={world.seed}"))
    reset_launch_counts()
    with VICounter() as counter:
        seconds = cli_run([f"--f={cfg_path}"], device)
    counts = launch_counts()
    counter.check(VI_EPOCHS, 1, "VI")
    hist = counter.trainer.history
    if len(hist) != VI_EPOCHS or not all(math.isfinite(v) for m in hist for v in m.values()):
        raise AssertionError(f"VI losses: {hist}")
    state = read_checkpoint(os.path.join(results, "model_vi.ckpt"))
    pred = read_checkpoint(os.path.join(results, "vi_prediction.ckpt"))
    grid = np.load(os.path.join(results, "recon_complete_best.npz"))
    n_rows, lat = world.cfg.P * world.cfg.T, world.cfg.latent_dim
    if state["kind"] != "vi" or tuple(state["mu"].shape) != (n_rows, lat) \
            or not torch.isfinite(state["mu"]).all():
        raise AssertionError(f"model_vi.ckpt: {state['kind']} {tuple(state['mu'].shape)}")
    if pred["mu_pred"].shape[1] != lat or not torch.isfinite(pred["mu_pred"]).all():
        raise AssertionError(f"vi_prediction.ckpt: {tuple(pred['mu_pred'].shape)}")
    if not (np.isfinite(grid["grid"]).all() and grid["filled"].any()):
        raise AssertionError(f"VI generation grid {grid['grid'].shape}")

    resumed = os.path.join(root, "vi_resumed")
    flags = [f for f in vi_flags(run, resumed, f"--epochs={VI_RESUME_EPOCHS}",
                                 "--generate_images=False", f"--gp_model_folder={results}",
                                 f"--seed={world.seed}") if "prediction" not in f]
    resume_s = cli_run([f"--f={write_flags(os.path.join(root, 'vi_resume.txt'), flags)}"], device)
    step = float(read_checkpoint(os.path.join(resumed, "model_vi.ckpt"))["opt"]["state"][0]["step"])
    if step != VI_EPOCHS + VI_RESUME_EPOCHS:
        raise AssertionError(f"the resumed VI run ended at Adam step {step}, not "
                             f"{VI_EPOCHS} + {VI_RESUME_EPOCHS}")
    return {"seconds": seconds, "resume_seconds": resume_s, "counts": counts,
            "counter": counter, "results": results, "losses": hist[-1],
            "n_pred": int(pred["mu_pred"].shape[0]), "trainer": counter.trainer}


def vi_pipeline(root: str, run: dict, vi: dict, name: str, device: str):
    """A VI pipeline on the CLI run's data (results in ``root/name``) and
    its trainer, resumed from the VI CLI run's ``model_vi.ckpt``."""
    cfg, _ = parse_flag_lines(vi_flags(run, os.path.join(root, name),
                                       f"--gp_model_folder={vi['results']}"))
    pipe = pipeline_mod.LVAEPipeline(cfg, device=device)
    return pipe, pipe.build_vi_trainer()


def vi_replay(world: World, root: str, run: dict, vi: dict, device: str) -> dict:
    """From ``model_vi.ckpt`` on ``device``: VI_COMPARE_STEPS phase-1 steps
    and VI_COMPARE_PRED_STEPS phase-2 steps with noise from one seeded CPU
    generator; returns the losses and the final moments."""
    pipe, trainer = vi_pipeline(root, run, vi, f"vi_replay_{device}", device)
    gen = torch.Generator().manual_seed(world.seed + 11)
    steps = []
    for _ in range(VI_COMPARE_STEPS):
        eps = torch.randn(trainer.state.mu.shape, generator=gen)
        steps.append(dict(zip(("net", "recon", "nll", "gp"), trainer.train_step(eps=eps).tolist())))
    eps = torch.randn((VI_COMPARE_PRED_STEPS, vi["n_pred"], world.cfg.latent_dim), generator=gen)
    mu_pred, _ = trainer.optimize_prediction_set(pipe.prediction_dataset,
                                                 epochs=VI_COMPARE_PRED_STEPS, log_every=0,
                                                 eps=eps)
    return {"steps": steps, "pred_steps": trainer.pred_history, "mu_pred": mu_pred,
            "mu": trainer.state.mu.detach().cpu().double().numpy(),
            "log_var": trainer.state.log_var.detach().cpu().double().numpy()}


def compare_vi(card: dict, cpu: dict) -> dict:
    errs = {"phase1_steps": compare_losses(card["steps"], cpu["steps"],
                                           keys=("net", "recon", "nll", "gp")),
            "phase2_steps": compare_losses(card["pred_steps"], cpu["pred_steps"],
                                           keys=("net", "recon", "gp")),
            "end_state": {key: float(np.abs(card[key] - cpu[key]).max() / np.abs(cpu[key]).max())
                          for key in ("mu", "log_var", "mu_pred")}}
    check_within(errs)
    return errs


def vi_step_times(trainer: VITrainer) -> dict:
    """Warm phase-1 steps on the card: the host clock of 4 steps ending in a
    synchronise (median of the last 3), then a profiler window of 2."""
    step_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return {"host_ms": statistics.median(step_ms[1:]),
            "profile": profile_window(trainer.train_step, 2)}


# ----------------------------------------------- captured serving and VI
VI_GVE_EPOCHS = 3  # phase-1 epochs from model_vi.ckpt, replayed and eager
VI_PRED_STEPS = 1000  # phase-2 steps, replayed and eager (the CLI run's count)
VI_PROFILE_PRED_STEPS = 100  # phase-2 steps of a traced run in the fresh process


def serving_answers(world: World, bundle, sib) -> dict:
    """Every answer of a full-width bundle and its K=1 sibling: encode,
    decode and impute of the 256-frame request, the K-subject request, the
    sibling's request, and both requests after a refresh of the parent."""
    one = (world.obs_frames[:1], world.obs_labels[:1], world.query_labels[:1])
    out = {"encode": bundle.encode(world.impute_frames),
           "impute": bundle.impute(world.impute_frames, world.impute_mask),
           "trajectories": bundle.predict_trajectories(
               world.obs_frames, world.obs_labels, world.query_labels),
           "sibling": sib.predict_trajectories(*one)}
    out["decode"] = bundle.decode(out["encode"])
    out["basis"] = basis_array(bundle)
    bundle.refresh_basis(world.new_frames, world.new_labels)
    out["basis_after_refresh"] = basis_array(bundle)
    out["sibling_basis_after_refresh"] = basis_array(sib)
    out["trajectories_after_refresh"] = bundle.predict_trajectories(
        world.obs_frames, world.obs_labels, world.query_labels)
    out["sibling_after_refresh"] = sib.predict_trajectories(*one)
    return out


def basis_array(bundle) -> np.ndarray:
    """A bundle's folded basis ``(H, c)``, flat, on the host."""
    return np.concatenate([t.cpu().numpy().ravel() for t in bundle._basis])


def serving_graph_vs_eager(world: World, pred: LVAEPredictor) -> dict:
    """The bundle's replayed programs, its basis fold and refresh among
    them, against the same programs run eagerly (under
    ``graph.eager_steps``), each on a bundle of its own from ``pred``, with
    cuDNN's default algorithms (reported: the decoder's transposed
    convolutions may add with atomics, so two eager calls can differ) and
    its deterministic ones (held bit-equal, and the sibling's answer the
    same bits before and after its parent's refresh, replayed and
    eager)."""
    res = {}
    for mode in ("default", "deterministic"):
        with (deterministic_cudnn() if mode == "deterministic" else contextlib.nullcontext()):
            runs = []
            for eager in (False, True):
                with eager_steps() if eager else contextlib.nullcontext():
                    bundle = pred.aot_compile(batch_size=BATCH, t_obs=T_OBS, n_query=N_QUERY,
                                              k_subjects=K_SUBJECTS)
                    sib = bundle.for_k_subjects(1)
                    runs.append(serving_answers(world, bundle, sib))
        res[mode] = {"graph_vs_eager": {k: bit_diff(runs[0][k], runs[1][k]) for k in runs[0]},
                     "sibling_across_refresh": [
                         bit_diff(r["sibling_after_refresh"], r["sibling"])["differ"]
                         for r in runs]}
    held = res["deterministic"]
    if any(held["sibling_across_refresh"]):
        raise AssertionError(f"a parent's refresh moved its sibling's answer: {held}")
    if any(d["differ"] for d in held["graph_vs_eager"].values()):
        raise AssertionError(f"serving graph vs eager on the card: {json.dumps(res)}")
    return res


def vi_state_arrays(trainer: VITrainer) -> list:
    """Every tensor phase 1 optimises (mu, log_var, the VAE, the GP), as f64."""
    return [p.detach().cpu().double().numpy()
            for p in trainer.state.opt_state.param_groups[0]["params"]]


def compare_vi_runs(a: VITrainer, b: VITrainer, epochs=slice(None)) -> dict:
    """Per phase-1 metric over the ``epochs`` of each history, and over
    every optimised tensor: the entries that differ, the largest relative
    difference."""
    out = {key: bit_diff(np.asarray([m[key] for m in a.history[epochs]]),
                         np.asarray([m[key] for m in b.history[epochs]]))
           for key in ("net", "recon", "nll", "gp")}
    diffs = [bit_diff(x, y) for x, y in zip(vi_state_arrays(a), vi_state_arrays(b))]
    out["params"] = {"differ": sum(d["differ"] for d in diffs),
                     "rel": max(d["rel"] for d in diffs)}
    return out


def vi_graph_vs_eager(root: str, run: dict, vi: dict, device: str = "cuda") -> dict:
    """From the VI CLI run's ``model_vi.ckpt``, with cuDNN's deterministic
    algorithms: VI_GVE_EPOCHS phase-1 epochs replayed against the same
    steps run eagerly (one state, one set of draws), the launches of each
    replay; a resume (1 epoch, a checkpoint loaded into a new trainer
    through the state setter, the rest) against the run straight through;
    then VI_PRED_STEPS phase-2 steps replayed against eager ones. All held
    bit-equal; the host clock of each run."""
    with deterministic_cudnn():
        return _vi_graph_vs_eager(root, run, vi, device)


def _vi_graph_vs_eager(root: str, run: dict, vi: dict, device: str) -> dict:
    pipe, graph = vi_pipeline(root, run, vi, "vi_graph", device)
    _, eager = vi_pipeline(root, run, vi, "vi_eager", device)
    per_step, times = [], {}
    graph._run_step = counted(graph._run_step, per_step)
    for name, tr in (("graph", graph), ("eager", eager)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with eager_steps() if tr is eager else contextlib.nullcontext():
            tr.fit(VI_GVE_EPOCHS, log_every=0, chunk=VI_GVE_EPOCHS)
        torch.cuda.synchronize()
        times[f"phase1_{name}_ms"] = (time.perf_counter() - t0) * 1e3
    del graph._run_step
    if len(graph._graphs) != (device == "cuda") or eager._graphs:
        raise AssertionError(f"graphs: {len(graph._graphs)} replayed, {len(eager._graphs)} eager")
    res = {"phase1": compare_vi_runs(graph, eager), "per_step": per_step,
           "per_replay": [graph_launches(g) for g in graph._graphs.values()]}

    _, first = vi_pipeline(root, run, vi, "vi_first", device)
    first.fit(1, log_every=0)
    path = save_checkpoint(os.path.join(root, "vi_resume.ckpt"), first.state)
    _, resumed = vi_pipeline(root, run, vi, "vi_resumed_gve", device)
    resumed.fit(1, log_every=0)  # a graph on the state it started from
    resumed.state = load_checkpoint(path, like=resumed.state)
    if resumed._graphs:
        raise AssertionError("the VI state setter kept the graphs")
    resumed.fit(VI_GVE_EPOCHS - 1, log_every=0)
    res["resume"] = compare_vi_runs(resumed, graph, slice(1, None))

    pred = {}
    for name, tr in (("graph", graph), ("eager", eager)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with eager_steps() if tr is eager else contextlib.nullcontext():
            pred[name] = tr.optimize_prediction_set(pipe.prediction_dataset,
                                                    epochs=VI_PRED_STEPS, log_every=0)
        times[f"phase2_{name}_ms"] = (time.perf_counter() - t0) * 1e3
    res["phase2"] = {key: bit_diff(np.asarray([m[key] for m in graph.pred_history]),
                                   np.asarray([m[key] for m in eager.pred_history]))
                     for key in ("net", "recon", "gp")}
    res["phase2"]["mu_pred"] = bit_diff(pred["graph"][0], pred["eager"][0])
    res["phase2"]["log_var_pred"] = bit_diff(pred["graph"][1], pred["eager"][1])
    res["times"] = times
    for part in ("phase1", "resume", "phase2"):
        if any(d["differ"] for d in res[part].values()):
            raise AssertionError(f"VI {part} graph vs eager on the card: {json.dumps(res)}")
    for got in per_step:
        if got["b_chain"] != 1 or got["chol_inv"] != 1:
            raise AssertionError(f"a replayed VI step counted {json.dumps(got)}")
    return res


def host_ms(fn, reps: int) -> list:
    """The host clock of ``reps`` calls of ``fn``, each ending in a
    synchronise, after one warm call."""
    fn()
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def host_median_ms(fn, reps: int) -> float:
    """Median host clock of ``reps`` calls of ``fn`` (:func:`host_ms`)."""
    return statistics.median(host_ms(fn, reps))


def capture_ms(program, inputs, eager_call, inference: bool = False) -> dict:
    """The cost of capturing ``program`` on ``inputs`` (a fresh graph with
    its warm-up call, in a pool of its own), less an eager call: the least
    of 2."""
    with_warmup, beyond = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CapturedStep(program, inputs, inference=inference)
        torch.cuda.synchronize()
        c = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        eager_call()
        torch.cuda.synchronize()
        with_warmup.append(c)
        beyond.append(c - (time.perf_counter() - t0) * 1e3)
    return {"capture_ms": min(beyond), "with_warmup_ms": with_warmup}


TRACED_REPLAYS = 5  # replayed requests, VI phase-1 epochs, whose kernels the trace counts


def traced_launches(fn, names=("b_chain", "chol_inv")) -> dict:
    """The launches of the kernels ``names`` (K1's and K2's by default) in
    one call of ``fn``, counted by kernel name in a trace of the card
    (:func:`epoch_kernel_names`) and by the launch counters (which add a
    graph's launches after each replay)."""
    before = launch_counts()
    traced = epoch_kernel_names(fn, names)
    after = launch_counts()
    return {"traced": traced, "counted": {k: after[k] - before[k] for k in traced}}


def check_traced(got: dict, want: dict, where: str) -> None:
    """The trace shows ``want``'s launches, and the counters agree."""
    if got["traced"] != want or got["counted"] != want:
        raise AssertionError(f"{where}: launches {json.dumps(got)}, expected {json.dumps(want)} "
                             "in the trace and on the counters")


def serving_replay_times(world: World) -> dict:
    """The serving bundle in a fresh process: the host clock and the
    profile of a replayed and of an eager K-subject request, 256-frame
    impute and basis fold, each program's capture cost, the launches the
    trajectory graph records and the kernels of TRACED_REPLAYS replayed
    requests, of a replayed impute and of a replayed fold, by name in a
    trace."""
    model = world.model()
    mu, _ = encode_dataset(model, world.frames, device="cuda")
    pred = LVAEPredictor(model=model, gp_params=world.gp, noise=world.noise, spec0=world.spec0,
                         spec1=world.spec1, z=world.z, id_covariate=world.cfg.id_covariate,
                         basis_labels=world.labels, basis_mu=mu, eps=world.cfg.eps, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bundle = pred.aot_compile(batch_size=BATCH, t_obs=T_OBS, n_query=N_QUERY,
                              k_subjects=K_SUBJECTS)
    torch.cuda.synchronize()
    out = {"aot_compile_ms": (time.perf_counter() - t0) * 1e3,
           "trajectory_replay_launches": graph_launches(bundle._graphs["trajectory"])}

    def request():
        bundle.predict_trajectories(world.obs_frames, world.obs_labels, world.query_labels)

    def impute():
        bundle.impute(world.impute_frames, world.impute_mask)

    def requests():
        for _ in range(TRACED_REPLAYS):
            request()

    fold = copy.copy(bundle)  # its own basis, so the bundle's buffers stay
    out["traced"] = {"requests": traced_launches(requests), "impute": traced_launches(impute),
                     "fold": traced_launches(fold._fold_basis)}
    for name in ("replayed", "eager"):
        with eager_steps() if name == "eager" else contextlib.nullcontext():
            out[name] = {"request_ms": host_median_ms(request, 10),
                         "impute_ms": host_median_ms(impute, 5),
                         "fold_ms": host_median_ms(fold._fold_basis, 3),
                         "request_profile": profile_window(request, 5),
                         "impute_profile": profile_window(impute, 3),
                         "fold_profile": profile_window(fold._fold_basis, 3)}
    captures = {}
    with torch.inference_mode():
        for name, g in bundle._graphs.items():
            inputs = [x.clone() for x in g.inputs]
            captures[name] = capture_ms(bundle._program(name), inputs,
                                        lambda: bundle._program(name)(*inputs), inference=True)
    out["captures"] = captures
    return out


def vi_replay_times(world: World) -> dict:
    """The VI programs at full width in a fresh process (a trainer made from
    the world): a replayed and an eager phase-1 step (host clock, profile),
    the capture's cost, the launches the graph records, a replayed chunk of
    epochs; phase 2's replayed and eager runs of VI_PROFILE_PRED_STEPS; the
    kernels of a chunk of TRACED_REPLAYS replayed epochs and of a replayed
    phase 2, by name in a trace."""
    trainer = world.vi_trainer("cuda")
    eps = torch.randn(trainer.state.mu.shape, generator=torch.Generator().manual_seed(1)).cuda()
    out_row = torch.empty(4, device="cuda")
    trainer._run_step(eps, out_row)  # the capture
    (graph,) = trainer._graphs.values()
    res = {"replay_launches": graph_launches(graph)}

    def replayed():
        trainer._run_step(eps, out_row)

    def eager():
        trainer._step(eps)

    res["replayed"] = {"step_ms": host_median_ms(replayed, 6),
                       "profile": profile_window(replayed, 3)}
    res["eager"] = {"step_ms": host_median_ms(eager, 4), "profile": profile_window(eager, 2)}
    res["capture"] = capture_ms(trainer._step, (eps,), eager)
    res["fit_ms_an_epoch"] = host_median_ms(lambda: trainer.fit(5, log_every=0, chunk=5), 1) / 5
    res["traced"] = {"phase1": traced_launches(
        lambda: trainer.fit(TRACED_REPLAYS, log_every=0, chunk=TRACED_REPLAYS))}
    if len(trainer._graphs) != 1:
        raise AssertionError(f"the traced epochs captured again: {len(trainer._graphs)} graphs")
    pred_ds = ArrayDataset(data=world.new_frames, labels=world.new_labels,
                           mask=np.ones((len(world.new_labels), world.cfg.num_dim), np.float32))

    def phase2():
        trainer.optimize_prediction_set(pred_ds, epochs=VI_PROFILE_PRED_STEPS, log_every=0)

    res["traced"]["phase2"] = traced_launches(phase2)
    res["phase2_replayed"] = {"run_ms": host_median_ms(phase2, 2),
                              "profile": profile_window(phase2, 1)}
    with eager_steps():
        res["phase2_eager"] = {"run_ms": host_median_ms(phase2, 2),
                               "profile": profile_window(phase2, 1)}
    return res



# --------------------------------------------------------------------- RNN
RNN_CELLS = ("lstm", "gru")
RNN_EPOCHS = 1  # Hensman epochs (5 steps) of each cell on the card and on the CPU


def serve_rnn(world: World, model, device: str) -> dict:
    """One K-subject trajectory request (whole T-frame sequences) through
    ``LVAEPredictor`` with the RNN model on ``device``; returns the frames,
    the fold's and the request's K2 launches and host-clock ms."""
    cfg = world.cfg
    mu, _ = encode_dataset(model, world.frames, device=device)
    pred = LVAEPredictor(model=model, gp_params=world.gp, noise=world.noise, spec0=world.spec0,
                         spec1=world.spec1, z=world.z, id_covariate=cfg.id_covariate,
                         basis_labels=world.labels, basis_mu=mu, eps=cfg.eps, device=device)
    before = k2.cholesky_inverse.launches
    bundle = pred.aot_compile(batch_size=BATCH, t_obs=cfg.T, n_query=N_QUERY,
                              k_subjects=K_SUBJECTS)
    fold_launches = k2.cholesky_inverse.launches - before
    times = []
    for _ in range(3 if device == "cuda" else 1):
        before = k2.cholesky_inverse.launches
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = bundle.predict_trajectories(world.req_frames, world.req_labels,
                                          world.query_labels)
        times.append((time.perf_counter() - t0) * 1e3)
        request_launches = k2.cholesky_inverse.launches - before
    shape = (K_SUBJECTS, N_QUERY, cfg.num_dim)
    if out.shape != shape or not np.isfinite(out).all():
        raise AssertionError(f"RNN trajectories: shape {out.shape}, expected {shape}")
    return {"out": out, "fold_launches": fold_launches, "request_launches": request_launches,
            "request_ms": times}


def run_rnn(world: World, cell: str, device: str = "cuda") -> dict:
    """RNN_EPOCHS Hensman epochs with the RNN encoder on the card and on the
    CPU from H + H_SHIFT·I (launches checked per step, card held against
    the CPU), then one request served from the card-trained model on both."""
    card, cpu = (train(world, dev, H_SHIFT, cell=cell, epochs=RNN_EPOCHS)
                 for dev in (device, "cpu"))
    if any(n1 != 1 or n2 < 2 for n1, n2 in card["per_step"]):
        raise AssertionError(f"an RNN ({cell}) step did not launch K1 once and K2 at least "
                             f"twice: {card['per_step']}")
    if any(step != (0, 0) for step in cpu["per_step"]):
        raise AssertionError("a CPU RNN run launched a CUDA kernel")
    for r in (card, cpu):
        check_training(r)
    errs = {"steps": compare_losses(card["steps"], cpu["steps"]),
            "end_state": compare_variational(card, cpu)}
    trained = card["trainer"].model
    served = {"card": serve_rnn(world, copy.deepcopy(trained), device),
              "cpu": serve_rnn(world, copy.deepcopy(trained), "cpu")}
    if served["card"]["fold_launches"] < 1 or served["card"]["request_launches"] < 1:
        raise AssertionError(f"RNN serving launched K2 {served['card']['fold_launches']} "
                             f"times in the fold, {served['card']['request_launches']} a request")
    errs["serving"] = {"trajectories": float(np.abs(served["card"]["out"] -
                                                    served["cpu"]["out"]).max())}
    if not errs["serving"]["trajectories"] <= FRAME_ATOL:
        raise AssertionError(f"RNN serving card vs CPU {errs['serving']} > {FRAME_ATOL}")
    check_within({k: v for k, v in errs.items() if k != "serving"})
    return {"card": card, "errs": errs, "served": served["card"]}


def tf32_gradient_effect(world: World) -> dict:
    """How far cuDNN's TF32 switch moves the encoders' gradients on the card
    (their forward passes run under ``full_precision``): per model, the
    largest per-tensor max |Δ| over max |ref| between two passes with
    ``cudnn.allow_tf32`` off, and between on and off; the switch is left
    off."""
    x = torch.as_tensor(world.frames[:K_SUBJECTS * world.cfg.T], device="cuda")
    out = {}
    models = {cell: world.rnn_model(cell) for cell in RNN_CELLS}
    models["conv"] = world.model()
    for name, model in models.items():
        model = model.cuda().eval()
        grads = []
        for tf32 in (False, False, True):
            torch.backends.cudnn.allow_tf32 = tf32
            model.zero_grad()
            mu, lv = model.encode(x)
            (mu.square().sum() + lv.sum()).backward()
            grads.append([p.grad.clone() for p in model.parameters() if p.grad is not None])
        torch.backends.cudnn.allow_tf32 = False
        rel = [max(float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))
                   for a, b in zip(g, grads[0])) for g in grads[1:]]
        out[name] = {"off_twice": rel[0], "on_vs_off": rel[1]}
    return out


# ------------------------------------------------------------------ export
# -------------------------------------------------------------------- bf16
BF16 = torch.bfloat16
# The bf16 phase: the VAE computes in bf16 over f32 parameters, the GP side
# stays f32. Card vs CPU, both in bf16: latents max |Δ| over max |CPU|,
# frames abs (2.5 bf16 ulps at 0.5), losses and the final m/H relative;
# each conv and GEMM output is rounded to bf16, after sums taken in other
# orders on the two devices.
BF16_LATENT_RTOL = 2e-2
BF16_FRAME_ATOL = 1e-2
BF16_LOSS_RTOL = 2e-2
BF16_VARIATIONAL_RTOL = 2e-2
BF16_PAR_SHAPE = (2, 1)  # the mesh of the sharded bf16 run
BF16_PAR_EPOCHS = 1  # its epochs (5 steps), against one process
BF16_CLI_EPOCHS = 2
BF16_SCALE_P = 1000  # the paper's cohort: a replayed epoch of 50 steps, bf16 against f32
CONV_MARKERS = ("conv", "fprop", "dgrad", "wgrad")
BF16_MARKERS = ("bf16", "bfloat16")


def flat_errs(errs: dict, prefix: str = ""):
    for key, value in errs.items():
        if isinstance(value, dict):
            yield from flat_errs(value, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", value


def check_below(errs: dict, tol: float, where: str) -> None:
    """Every number in the nested ``errs`` at most ``tol``."""
    bad = {k: v for k, v in flat_errs(errs) if not v <= tol}
    if bad:
        raise AssertionError(f"{where}: {json.dumps(bad)} > {tol:g}")


def held_bit_equal(diff: dict, where: str) -> int:
    """The entries that differ over a ``compare_runs``/``bit_diff`` table;
    raises unless 0."""
    n = sum(v["differ"] for k, v in flat_dicts(diff))
    if n:
        raise AssertionError(f"{where}: {n} entries differ: {json.dumps(diff)}")
    return n


def flat_dicts(d: dict):
    for key, value in d.items():
        if isinstance(value, dict) and "differ" in value:
            yield key, value
        elif isinstance(value, dict):
            yield from flat_dicts(value)


def rel_np(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def bf16_hensman(world: World, card_f32: dict, device: str = "cuda") -> dict:
    """TRAIN_EPOCHS replayed Hensman epochs (10 steps) with the VAE in bf16
    from H + H_SHIFT·I on the card, K1 once and K2 three times a step, and
    the same steps on the CPU in bf16, held against each other; the card's
    against its f32 run (``card_f32``, printed); then, with cuDNN
    deterministic, replayed against the same steps run eagerly, held
    bit-equal."""
    t0 = time.perf_counter()
    card = train(world, device, H_SHIFT, compute=BF16)
    if device == "cuda" and any(step != (1, 3) for step in card["per_step"]):
        raise AssertionError(f"a bf16 step did not launch K1 once and K2 3 times: "
                             f"{card['per_step']}")
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cpu = train(world, "cpu", H_SHIFT, compute=BF16)
    cpu_s = time.perf_counter() - t0
    for run in (card, cpu):
        check_training(run)
    errs = {"steps": compare_losses(card["steps"], cpu["steps"]),
            "end_state": compare_variational(card, cpu)}
    check_below(errs["steps"], BF16_LOSS_RTOL, "bf16 Hensman card vs CPU, losses")
    check_below(errs["end_state"], BF16_VARIATIONAL_RTOL, "bf16 Hensman card vs CPU, m/H")
    vs_f32 = {"steps": compare_losses(card["steps"], card_f32["steps"]),
              "end_state": compare_variational(card, card_f32)}
    with deterministic_cudnn():
        graph = train(world, device, H_SHIFT, compute=BF16)
        eager = train(world, device, H_SHIFT, compute=BF16, eager=True)
    gve = compare_runs(graph, eager)
    held_bit_equal({k: v for k, v in gve.items() if k != "first_difference"},
                   "bf16 Hensman graph vs eager")
    return {"card": card, "errs": errs, "vs_f32": vs_f32, "graph_vs_eager": gve,
            "seconds": {"card": card_s, "cpu": cpu_s}}


def bf16_table(world: World, device: str = "cuda") -> dict:
    """One epoch with the frame table in bf16 (``use_bf16_table``, as
    ``LVAE_TABLE_BF16=1`` sets it) against the bf16 model over the f32
    table, from one state and one set of draws: the first step's net loss
    and a replayed step's host clock."""
    res = {}
    prev = hensman_mod.use_bf16_table
    try:
        for name, switch in (("f32_table", False), ("bf16_table", True)):
            hensman_mod.use_bf16_table = switch
            run = train(world, device, H_SHIFT, compute=BF16, epochs=1)
            trainer = run["trainer"]
            if (trainer.tdata.data.dtype == BF16) != switch or \
                    trainer.tdata.labels.dtype != torch.float32:
                raise AssertionError(f"{name}: tables {trainer.tdata.data.dtype}, "
                                     f"labels {trainer.tdata.labels.dtype}")
            res[name] = {"net": run["steps"][0]["net"],
                         "host_ms": replayed_host_ms(trainer)[0] if device == "cuda" else None}
    finally:
        hensman_mod.use_bf16_table = prev
    res["net_rel"] = rel(res["bf16_table"]["net"], res["f32_table"]["net"])
    check_below({"net": res["net_rel"]}, BF16_LOSS_RTOL, "bf16 table vs f32 table")
    return res


def scale_world(world: World, p: int) -> World:
    """``world`` with a training cohort of ``p`` subjects (from its seed)."""
    big = copy.copy(world)
    cfg = world.cfg
    rng = np.random.default_rng(world.seed + 1)
    big.frames, big.labels = make_cohort(rng, range(p), cfg.T, world.hw)
    big.pixmask = (rng.uniform(size=(big.labels.shape[0], cfg.num_dim)) > 0.1).astype(
        np.float32)
    big.blocks = build_subject_blocks(big.labels, cfg.id_covariate)
    big.z = init_inducing_points(big.labels, cfg.M, seed=world.seed)
    return big


def bf16_scale(world: World, p: int = BF16_SCALE_P) -> dict:
    """A replayed Hensman epoch at ``p`` subjects (``p / 20`` steps), f32
    and bf16 trainers from one state, in turns (f32, bf16, bf16, f32, ...):
    the host clock of each epoch, which ends in the metrics' host copy."""
    big = scale_world(world, p)
    trainers = {name: big.trainer("cuda", big.model(compute=compute))
                for name, compute in (("f32", None), ("bf16", BF16))}
    ms = {name: [] for name in trainers}
    for name, tr in trainers.items():
        with uncounted(name == "f32"):
            tr.run_epochs(1)  # the capture, then the epoch's replays
    for name in ("f32", "bf16", "bf16", "f32", "f32", "bf16"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with uncounted(name == "f32"):
            m = trainers[name].run_epochs(1)[-1]
        ms[name].append((time.perf_counter() - t0) * 1e3)
        if not all(math.isfinite(v) for v in m):
            raise AssertionError(f"P={p} {name} epoch: {m}")
    steps = trainers["f32"].steps_per_epoch
    return {"steps": steps, "epoch_ms": {k: statistics.median(v) for k, v in ms.items()},
            "all_ms": ms}


def serve_dtype(world: World, device: str, compute=None) -> dict:
    """A predictor and bundle of the seed's ConvVAE computing in ``compute``
    on ``device``, and its answers: the basis, a K-subject request, the
    256-frame impute and an eager latent trajectory."""
    model = world.model(compute=compute)
    mu, _ = encode_dataset(model, world.frames, device=device)
    pred = LVAEPredictor(model=model, gp_params=world.gp, noise=world.noise, spec0=world.spec0,
                         spec1=world.spec1, z=world.z, id_covariate=world.cfg.id_covariate,
                         basis_labels=world.labels, basis_mu=mu, eps=world.cfg.eps, device=device)
    bundle = pred.aot_compile(batch_size=BATCH, t_obs=T_OBS, n_query=N_QUERY,
                              k_subjects=K_SUBJECTS)
    out = {"basis_mu": mu,
           "trajectories": bundle.predict_trajectories(world.obs_frames, world.obs_labels,
                                                       world.query_labels),
           "impute": bundle.impute(world.impute_frames, world.impute_mask),
           "latent_trajectory": pred.predict_latent_trajectory(
               world.obs_frames[0], world.obs_labels[0], world.query_labels[0])}
    for name, got in out.items():
        if got.dtype != np.float32 or not np.isfinite(got).all():
            raise AssertionError(f"bf16 serving {name}: {got.dtype}, finite "
                                 f"{np.isfinite(got).all()}")
    return {"pred": pred, "bundle": bundle, "out": out}


def bf16_serving(world: World, device: str = "cuda") -> dict:
    """The serving bundle of a bf16 ConvVAE on the card against the CPU's;
    a replayed K=8 request and the 256-frame impute, host clock, beside an
    f32 bundle's in turns; the replayed programs held bit-equal to the same
    programs run eagerly (:func:`serving_graph_vs_eager`)."""
    card, cpu = serve_dtype(world, device, BF16), serve_dtype(world, "cpu", BF16)
    if card["pred"].model.compute_dtype != BF16:
        raise AssertionError("the bf16 predictor lost its compute dtype")
    errs = {name: rel_np(card["out"][name], cpu["out"][name])
            for name in ("basis_mu", "latent_trajectory")}
    check_below(errs, BF16_LATENT_RTOL, "bf16 serving card vs CPU, latents")
    frames = {name: float(np.abs(card["out"][name] - cpu["out"][name]).max())
              for name in ("trajectories", "impute")}
    check_below(frames, BF16_FRAME_ATOL, "bf16 serving card vs CPU, frames")
    res = {"errs": errs | frames}
    if device != "cuda":
        return res
    with uncounted():
        bundles = {"f32": serve_dtype(world, device)["bundle"], "bf16": card["bundle"]}
    times = {name: {"request_ms": [], "impute_ms": []} for name in bundles}
    for name in ("f32", "bf16", "bf16", "f32"):
        b = bundles[name]
        with uncounted(name == "f32"):
            times[name]["request_ms"].append(host_median_ms(lambda: b.predict_trajectories(
                world.obs_frames, world.obs_labels, world.query_labels), 10))
            times[name]["impute_ms"].append(host_median_ms(
                lambda: b.impute(world.impute_frames, world.impute_mask), 5))
    res["times"] = {name: {k: statistics.median(v) for k, v in t.items()}
                    for name, t in times.items()}
    gve = serving_graph_vs_eager(world, card["pred"])
    res["graph_vs_eager"] = gve["deterministic"]["graph_vs_eager"]
    held_bit_equal(res["graph_vs_eager"], "bf16 serving graph vs eager")
    return res


def bf16_vi(world: World, device: str = "cuda") -> dict:
    """One VI phase-1 step with the decoder in bf16 from the world's state:
    on the card (the capture's warm-up) against the CPU, each metric and
    the state after it; the replayed step's host clock beside an f32
    trainer's; the graph's recorded launches (K1 and K2 once); with cuDNN
    deterministic, 3 replayed steps against 3 eager ones, bit-equal."""
    cfg = world.cfg
    eps = torch.randn((world.labels.shape[0], cfg.latent_dim),
                      generator=torch.Generator().manual_seed(1))
    card = world.vi_trainer(device, BF16)
    row = torch.empty(4, device=device)
    card._run_step(eps.to(device), row)
    cpu = world.vi_trainer("cpu", BF16)
    want = cpu._step(eps)
    errs = {"metrics": {k: rel(float(a), float(b)) for k, a, b in
                        zip(("net", "recon", "nll", "gp"), row.cpu(), want)},
            "state": {name: rel_np(getattr(card.state, name).detach().cpu().numpy(),
                                   getattr(cpu.state, name).detach().numpy())
                      for name in ("mu", "log_var")}}
    check_below(errs, BF16_LOSS_RTOL, "bf16 VI card vs CPU")
    res = {"errs": errs}
    if device != "cuda":
        return res
    (graph,) = card._graphs.values()
    res["replay_launches"] = graph_launches(graph)
    if res["replay_launches"]["b_chain"] != 1 or res["replay_launches"]["chol_inv"] != 1:
        raise AssertionError(f"the bf16 VI graph records {res['replay_launches']}")
    e = eps.to(device)
    with uncounted():
        f32 = world.vi_trainer(device)
        f32._run_step(e, row)
    res["step_ms"] = {}
    for name, tr in (("f32", f32), ("bf16", card)):
        with uncounted(name == "f32"):
            res["step_ms"][name] = host_median_ms(lambda: tr._run_step(e, row), 6)
    with deterministic_cudnn():
        runs = []
        for eager in (False, True):
            tr = world.vi_trainer(device, BF16)
            rows = torch.empty((3, 4), device=device)
            with eager_steps() if eager else contextlib.nullcontext():
                for i in range(3):
                    tr._run_step(e, rows[i])
            runs.append([rows.cpu().numpy()] + vi_state_arrays(tr))
    res["graph_vs_eager"] = {"metrics": bit_diff(runs[0][0], runs[1][0]),
                             "params": {"differ": sum(int(np.count_nonzero(a != b))
                                                      for a, b in zip(runs[0][1:], runs[1][1:]))}}
    held_bit_equal(res["graph_vs_eager"], "bf16 VI graph vs eager")
    return res


def rnn_compaction_warnings(world: World) -> dict:
    """For each cell, the warnings cuDNN gives in one bf16 encode with its
    gradient that the weights are not one contiguous buffer (it then
    copies them into one at every call), held at 0; then the witness: the
    LSTM's weights cast one by one and passed to the same call, which must
    warn. Run before any other recurrence of its process, in case the
    warning is given once a process."""
    x = torch.as_tensor(world.frames[:K_SUBJECTS * world.cfg.T], device="cuda")
    out = {}
    for cell in (*RNN_CELLS, "witness"):
        model = world.rnn_model("lstm" if cell == "witness" else cell, BF16).cuda()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if cell == "witness":
                h = torch.zeros(K_SUBJECTS, world.cfg.T, world.cfg.hidden_dim, device="cuda",
                                dtype=BF16)
                h0 = torch.zeros(2, K_SUBJECTS, world.cfg.hidden_dim, device="cuda", dtype=BF16)
                torch._VF.lstm(h, (h0, h0), [w.to(BF16) for w in model.rnn._flat_weights],
                               True, 1, 0.0, True, True, True)
            else:
                sum(t.float().sum() for t in model.encode(x)).backward()
        out[cell] = sum("contiguous chunk of memory" in str(w.message) for w in caught)
    if out["lstm"] or out["gru"] or not out["witness"]:
        raise AssertionError(f"cuDNN's weight-compaction warnings in bf16: {out}")
    out["lstm_layout"] = cudnn_layout("lstm", world.cfg.hidden_dim, BF16, x.device)
    return out


def bf16_rnn(world: World, device: str = "cuda") -> dict:
    """One bf16 LSTM Hensman epoch (5 steps) on the card and on the CPU from
    H + H_SHIFT·I, then one K-subject request served from the card-trained
    model on both."""
    card, cpu = (train(world, dev, H_SHIFT, cell="lstm", epochs=RNN_EPOCHS, compute=BF16)
                 for dev in (device, "cpu"))
    if device == "cuda" and any(n1 != 1 or n2 < 2 for n1, n2 in card["per_step"]):
        raise AssertionError(f"a bf16 LSTM step launched {card['per_step']}")
    for r in (card, cpu):
        check_training(r)
    errs = {"steps": compare_losses(card["steps"], cpu["steps"]),
            "end_state": compare_variational(card, cpu)}
    trained = card["trainer"].model
    served = {dev: serve_rnn(world, copy.deepcopy(trained), dev) for dev in (device, "cpu")}
    errs["trajectories"] = float(np.abs(served[device]["out"] - served["cpu"]["out"]).max())
    check_below({k: errs[k] for k in ("steps", "end_state")}, BF16_LOSS_RTOL,
                "bf16 LSTM card vs CPU")
    check_below({"trajectories": errs["trajectories"]}, BF16_FRAME_ATOL,
                "bf16 LSTM serving card vs CPU")
    return {"errs": errs, "request_ms": served[device]["request_ms"]}


def rnn_replayed_steps(world: World) -> dict:
    """The RNN encoder's replayed Hensman step with each cell, in f32 and
    in bf16: its host clock (:func:`replayed_host_ms`, cuDNN's default
    algorithms) and, with cuDNN deterministic, one epoch replayed against
    the same steps run eagerly, held bit-equal."""
    res = {}
    for cell in RNN_CELLS:
        for name, compute in (("f32", None), ("bf16", BF16)):
            with deterministic_cudnn():
                graph = train(world, "cuda", H_SHIFT, cell=cell, epochs=1, compute=compute)
                eager = train(world, "cuda", H_SHIFT, cell=cell, epochs=1, compute=compute,
                              eager=True)
            gve = compare_runs(graph, eager)
            differ = held_bit_equal({k: v for k, v in gve.items() if k != "first_difference"},
                                    f"RNN {cell} {name} graph vs eager")
            timed = train(world, "cuda", H_SHIFT, cell=cell, epochs=1, compute=compute)
            res[f"{cell}_{name}"] = {"replayed_ms": replayed_host_ms(timed["trainer"])[0],
                                     "graph_vs_eager_differ": differ}
    return res


def run_pipeline_bf16(world: World, root: str, run: dict, device: str = "cuda") -> dict:
    """``lvae_torch.cli.main`` with ``--model_dtype=bfloat16`` on the
    pipeline's data: BF16_CLI_EPOCHS epochs from the f32 run's pre-trained
    VAE with validation, tests, generation and checkpoints (the launches of
    each step and validation checked), then a run resumed from its
    checkpoint for one epoch."""
    results = os.path.join(root, "results_bf16")
    cfg = write_flags(os.path.join(root, "bf16.txt"), pipeline_flags(
        run["data"], results, "--model_dtype=bfloat16", f"--epochs={BF16_CLI_EPOCHS}",
        f"--test_freq={BF16_CLI_EPOCHS}", f"--checkpoint_every={BF16_CLI_EPOCHS}",
        "--run_tests=True", "--run_validation=True", "--generate_images=True",
        f"--model_params={run['results']}/model_params_vae.ckpt", "--gp_model_folder=",
        f"--seed={world.seed}"))
    with PathCounter() as counter:
        seconds = cli_run([f"--f={cfg}"], device)
    if counter.pipeline.model.compute_dtype != BF16:
        raise AssertionError("the CLI run's model does not compute in bf16")
    if device == "cuda":
        counter.check("k1", BF16_CLI_EPOCHS * run["steps_per_epoch"], 2, "bf16 pipeline")
    out = check_pipeline_run(results, BF16_CLI_EPOCHS, world.hw,
                             artefacts=[a for a in PIPE_ARTEFACTS if "model_params" not in a])
    final = read_checkpoint(os.path.join(results, "model_final.ckpt"))
    if any(v.dtype != torch.float32 for v in final["vae"].values()):
        raise AssertionError("a bf16 run's checkpoint holds parameters other than f32")
    resumed = os.path.join(root, "resumed_bf16")
    resume_cfg = write_flags(os.path.join(root, "bf16_resume.txt"), pipeline_flags(
        run["data"], resumed, "--model_dtype=bfloat16", "--epochs=1", "--test_freq=1",
        "--checkpoint_every=1", f"--gp_model_folder={results}", f"--seed={world.seed}"))
    resume_s = cli_run([f"--f={resume_cfg}"], device)
    step = read_checkpoint(os.path.join(resumed, "model_final.ckpt"))["step"]
    if step != final["step"] + run["steps_per_epoch"]:
        raise AssertionError(f"the resumed bf16 run ended at step {step}, not at "
                             f"{final['step']} + {run['steps_per_epoch']}")
    return {"seconds": seconds, "resume_seconds": resume_s, "resumed_step": step, **out}


def bf16_profiles(world: World) -> dict:
    """Profiles of a replayed VI phase-1 step and of a replayed K-subject
    request, each with the VAE in f32 and in bf16 (in the fresh process)."""
    eps = torch.randn((world.labels.shape[0], world.cfg.latent_dim),
                      generator=torch.Generator().manual_seed(1)).cuda()
    row = torch.empty(4, device="cuda")
    out = {}
    for name, compute in (("f32", None), ("bf16", BF16)):
        tr = world.vi_trainer("cuda", compute)
        tr._run_step(eps, row)  # the capture
        out[f"vi_{name}"] = profile_window(lambda: tr._run_step(eps, row), 3)
        bundle = serve_dtype(world, "cuda", compute)["bundle"]
        out[f"request_{name}"] = profile_window(lambda: bundle.predict_trajectories(
            world.obs_frames, world.obs_labels, world.query_labels), 5)
    return out


def step_kernel_names(trainer: HensmanTrainer) -> list:
    """The names of the kernels one replayed step launches, from a trace of
    the card."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    draws = trainer._draws(1)
    rows, eps = draws[0][0][0, 0], draws[0][1][0, 0]
    out = torch.empty(5, dtype=trainer.dtype, device=trainer.device)
    trainer._run_step(0, rows, eps, out)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer._run_step(0, rows, eps, out)
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages() if e.device_type == DeviceType.CUDA})


def conv_kernels(names: dict) -> dict:
    """The convolution kernels of the f32 and the bf16 step (names with a
    marker of CONV_MARKERS), and those of the bf16 step that carry a bf16
    marker; the bf16 step must run its convolutions in bf16: at least one
    with a bf16 marker, and none of the f32 step's."""
    conv = {k: [n for n in v if any(m in n.lower() for m in CONV_MARKERS)]
            for k, v in names.items()}
    bf16 = [n for n in conv["bf16"] if any(m in n.lower() for m in BF16_MARKERS)]
    shared = sorted(set(conv["bf16"]) & set(conv["f32"]))
    return {"f32": conv["f32"], "bf16": conv["bf16"], "bf16_marked": bf16, "shared": shared}


GP_FILES = ("gp_model.pth", "zt_list.pth", "m.pth", "H.pth")
EXPORT_ATOL = 1e-5  # raw GP parameters back from the files: f32 rounding of constrain


def check_export(world: World, root: str, run: dict, pipe) -> dict:
    """The Hensman CLI run's reference GP files: written again from its
    final state (``pipe`` resumed from ``model_final.ckpt``) they are the
    same bits; read back, the parameters, z, m and H are the state's."""
    cfg = world.cfg
    spec = dict(id_covariate=cfg.id_covariate, **cfg.kernel_spec_kwargs())
    state, tdata = pipe.trainer.state, pipe.trainer.tdata
    again = os.path.join(root, "export")
    save_reference_gp_state(again, state.trainables.gp, tdata.z, state.m_nat, state.H_nat,
                            latent_dim=cfg.latent_dim, constrain_scales=cfg.constrain_scales,
                            **spec)
    for name in GP_FILES:
        a, b = (torch.load(os.path.join(d, name), map_location="cpu", weights_only=True)
                for d in (run["results"], again))
        pairs = [(a[k], b[k]) for k in a] if isinstance(a, dict) else [(a, b)]
        if (isinstance(a, dict) and sorted(a) != sorted(b)) or not all(
                x.dtype == torch.float64 and torch.equal(x, y) for x, y in pairs):
            raise AssertionError(f"{name}: the pipeline's file differs from a second export")
    kp0, kp1, noise, z, m, h = load_reference_gp_state(run["results"], cfg.latent_dim, **spec)
    errs = {}
    gp = state.trainables.gp
    for name, got, want, comps in (("kp0", kp0, gp.kp0, world.spec0.components),
                                   ("kp1", kp1, gp.kp1, world.spec1.components)):
        rbf = [c for c, comp in enumerate(comps) if comp.rbf_col >= 0]
        errs[f"{name}.raw_scale"] = float((got.raw_scale - want.raw_scale.detach().cpu()
                                           .double()).abs().max())
        errs[f"{name}.raw_lengthscale"] = float((got.raw_lengthscale[:, rbf] - want.raw_lengthscale
                                                 .detach().cpu().double()[:, rbf]).abs().max())
    want_noise = torch.ones(cfg.latent_dim, dtype=torch.float64) if cfg.constrain_scales else \
        kx.constrain(gp.raw_noise.detach().cpu()).double()
    errs["noise"] = float((noise - want_noise).abs().max())
    bad = [f"{k} {v:.3e}" for k, v in errs.items() if not v <= EXPORT_ATOL]
    for name, got, want in (("z", z, tdata.z), ("m", m, state.m_nat), ("H", h, state.H_nat)):
        if not torch.equal(got, want.detach().cpu().double()):
            bad.append(f"{name} not equal")
    if bad:
        raise AssertionError("reference GP files read back: " + "; ".join(bad))
    return errs


# ----------------------------------------------------------------- serving
def serve(world: World, device: str) -> dict:
    """The serving path on ``device``: returns every answer, the K2 launches
    of each step and the host-clock times."""
    cuda = device == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    model = world.model()
    mu, _ = encode_dataset(model, world.frames, device=device)
    pred = LVAEPredictor(
        model=model, gp_params=world.gp, noise=world.noise, spec0=world.spec0,
        spec1=world.spec1, z=world.z, id_covariate=world.cfg.id_covariate,
        basis_labels=world.labels, basis_mu=mu, eps=world.cfg.eps, device=device,
    )
    launches, times, out = {}, {}, {"basis_mu": mu}

    def step(name, fn):
        before = k2.cholesky_inverse.launches
        sync()
        t0 = time.perf_counter()
        result = fn()
        sync()
        times.setdefault(name, []).append(time.perf_counter() - t0)
        launches.setdefault(name, []).append(k2.cholesky_inverse.launches - before)
        return result

    def reps(n):
        return range(n if cuda else 1)

    fold_graphs = []  # the basis programs' graphs after each aot_compile
    for _ in reps(N_FOLDS):
        bundle = step("fold", lambda: pred.aot_compile(
            batch_size=BATCH, t_obs=T_OBS, n_query=N_QUERY, k_subjects=K_SUBJECTS))
        fold_graphs.append(basis_graphs(pred))
    # a copy: refresh_basis overwrites the bundle's basis buffers in place
    out["basis_c"] = bundle._basis.c.cpu().numpy().copy()
    for _ in range(3):
        out["impute"] = step("impute", lambda: bundle.impute(world.impute_frames, world.impute_mask))
    for _ in reps(N_REQUESTS):
        out["trajectories"] = step("predict_trajectories", lambda: bundle.predict_trajectories(
            world.obs_frames, world.obs_labels, world.query_labels))
    out["trajectory"] = step("predict_trajectory", lambda: bundle.predict_trajectory(
        world.obs_frames[0], world.obs_labels[0], world.query_labels[0]))
    for _ in reps(2):
        out["latent_trajectory"] = step("predict_latent_trajectory", lambda: (
            pred.predict_latent_trajectory(
                world.obs_frames[0], world.obs_labels[0], world.query_labels[0])))
    step("refresh_basis", lambda: bundle.refresh_basis(world.new_frames, world.new_labels))
    out["refreshed_c"] = bundle._basis.c.cpu().numpy()
    out["trajectories_after_refresh"] = step("predict_trajectories_after_refresh", lambda: (
        bundle.predict_trajectories(world.obs_frames, world.obs_labels, world.query_labels)))
    return {"out": out, "launches": launches, "times": times, "pred": pred, "bundle": bundle,
            "fold_graphs": fold_graphs}


def basis_graphs(pred: LVAEPredictor) -> dict:
    """The captured graphs of the basis fold and extension programs on
    ``pred``'s device, by key (the GP programs of ``evaluation/programs``):
    each entry the graph object's id."""
    return {repr(k[:2]): id(g) for k, g in eval_programs.graphs_of(None, pred.z.device).items()
            if k[0] in ("fold_basis", "extend_basis")}


def check_outputs(out: dict, world: World) -> None:
    cfg, hw = world.cfg, world.hw
    shapes = {
        "basis_mu": (cfg.P * cfg.T, cfg.latent_dim),
        "basis_c": (cfg.latent_dim, cfg.M),
        "impute": (BATCH, hw, hw, 1),
        "trajectories": (K_SUBJECTS, N_QUERY, hw, hw, 1),
        "trajectory": (N_QUERY, hw, hw, 1),
        "latent_trajectory": (N_QUERY, cfg.latent_dim),
        "refreshed_c": (cfg.latent_dim, cfg.M),
        "trajectories_after_refresh": (K_SUBJECTS, N_QUERY, hw, hw, 1),
    }
    for name, shape in shapes.items():
        got = out[name]
        if got.shape != shape:
            raise AssertionError(f"{name}: shape {got.shape}, expected {shape}")
        if not np.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite values")
    # masked imputation keeps the observed pixels exactly
    keep = world.impute_mask > 0
    if not np.array_equal(out["impute"][keep], world.impute_frames[keep]):
        raise AssertionError("impute changed observed pixels")


def compare(card: dict, cpu: dict) -> dict:
    errs = {}
    for name in ("basis_mu", "basis_c", "latent_trajectory", "refreshed_c"):
        want = cpu[name]
        errs[name] = float(np.abs(card[name] - want).max() / np.abs(want).max())
        if not errs[name] <= LATENT_RTOL:
            raise AssertionError(f"{name}: card vs CPU rel err {errs[name]:.3e} > {LATENT_RTOL}")
    for name in ("impute", "trajectories", "trajectory", "trajectories_after_refresh"):
        errs[name] = float(np.abs(card[name] - cpu[name]).max())
        if not errs[name] <= FRAME_ATOL:
            raise AssertionError(f"{name}: card vs CPU abs err {errs[name]:.3e} > {FRAME_ATOL}")
    return errs


# the runtime calls by which the host puts work on the card
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch", "cudaMemcpy",
                     "cudaMemset")


def profile_window(fn, reps: int, collectives: bool = False) -> dict:
    """Device time per call of ``fn`` from a ``torch.profiler`` trace of
    ``reps`` warm calls: wall ms (host clock, ending in a synchronise), the
    sum of device-kernel ms, the device's idle share of the wall time, the
    kernels launched per call, the host's launch calls per call (kernel and
    graph launches, copies and fills; by name), the device's copies per
    call by kind (``Memcpy HtoD (Pageable -> Device)``, ...), and the five
    kernels that take most time;
    with ``collectives``, also the host and device ms per call of the
    collective ops (``all_reduce``/``broadcast`` and what they launch)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    rows = [
        (e.self_device_time_total, e.count, e.key)
        for e in events
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    ]
    busy_us = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    host_calls = {e.key: e.count / reps for e in events
                  if e.device_type == DeviceType.CPU and e.key.startswith(HOST_LAUNCH_CALLS)}
    out = {
        "wall_ms": wall * 1e3 / reps,
        "device_ms": busy_us / 1e3 / reps,
        "idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernels_per_call": sum(r[1] for r in rows) / reps,
        "host_launches_per_call": sum(host_calls.values()),
        "host_launch_calls": host_calls,
        "copies": {key: n / reps for _, n, key in rows if key.startswith("Memcpy")},
        "top": [{"kernel": key[:70], "ms": us / 1e3 / reps, "per_call": n / reps}
                for us, n, key in rows[:5]],
    }
    if collectives:
        ops = [e for e in events
               if any(k in e.key.lower() for k in ("all_reduce", "allreduce", "broadcast"))
               and e.count]
        out["collectives"] = {
            "host_ms": sum(e.self_cpu_time_total for e in ops) / 1e3 / reps,
            "device_ms": sum(e.device_time_total for e in ops) / 1e3 / reps,
            "ops": sorted({e.key for e in ops})}
    return out


def hensman_step_times(trainer: HensmanTrainer) -> dict:
    """Warm Hensman steps on the card: the host clock of 6 steps ending in a
    synchronise (median of the last 5, and the first), then a profiler
    window of 3."""
    table = trainer.tables[0]
    rows = torch.arange(trainer.subjects_per_batch)
    step_ms = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(table, rows)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return {"host_ms": statistics.median(step_ms[1:]), "first_ms": step_ms[0],
            "profile": profile_window(lambda: trainer.train_step(table, rows), 3)}


def replayed_host_ms(trainer: HensmanTrainer):
    """The host clock of a warm replayed step of the epoch program (the
    median of the last 5 of 6, each ending in a synchronise), on the batch
    and noise of a fresh draw's first step; returns it and the step's
    inputs ``(rows, eps, out)``."""
    draws = trainer._draws(1)
    rows, eps = draws[0][0][0, 0], draws[0][1][0, 0]
    out = torch.empty(5, dtype=trainer.dtype, device=trainer.device)
    step_ms = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer._run_step(0, rows, eps, out)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(step_ms[1:]), (rows, eps, out)


def replayed_step_times(trainer: HensmanTrainer) -> dict:
    """Warm replayed steps of the epoch program on the card, the batch and
    noise of its last dispatched epoch's first step again: the host clock
    of 6 (median of the last 5) ending in a synchronise, a profiler window
    of 3, the capture's own cost (a fresh capture with its warm-up step,
    less an eager step) and a replayed epoch's wall time and profile, in
    which K1's and K2's kernels are counted by name."""
    host_ms, (rows, eps, out) = replayed_host_ms(trainer)
    res = {"host_ms": host_ms,
           "profile": profile_window(lambda: trainer._run_step(0, rows, eps, out), 3)}
    table = trainer.tables[0]
    capture_ms, eager_ms = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        CapturedStep(lambda r, e: trainer._step(table, r, e), (rows, eps), out)
        torch.cuda.synchronize()
        capture_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        trainer._step(table, rows, eps)
        torch.cuda.synchronize()
        eager_ms.append((time.perf_counter() - t0) * 1e3)
    res["capture_ms"] = min(c - e for c, e in zip(capture_ms, eager_ms))
    res["capture_with_warmup_ms"] = capture_ms
    epoch_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run_epoch()
        epoch_ms.append((time.perf_counter() - t0) * 1e3)
    res["epoch_ms"] = statistics.median(epoch_ms)
    epoch = profile_window(trainer.run_epoch, 2)
    res["epoch_profile"] = epoch
    res["epoch_kernels_by_name"] = traced_launches(trainer.run_epoch)
    return res


def epoch_kernel_names(fn, names=("b_chain", "chol_inv")) -> dict:
    """Launches in one call of ``fn`` of the kernels ``names`` (K1's
    ``b_chain_*``, K2's ``chol_inv_*``, K4's ``block_pair_*``), counted by
    kernel name in a profiler trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    counts = dict.fromkeys(names, 0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            for name in counts:
                if f"{name}_" in e.key:
                    counts[name] += e.count
    return counts


GRAPH_STEPS_RTOL = 1e-6  # graph vs eager on the card with cuDNN deterministic, predicted bit-equal


@contextlib.contextmanager
def deterministic_cudnn():
    """cuDNN restricted to deterministic algorithms inside the block (its
    default weight-gradient algorithm adds with atomics, in an order that
    changes from run to run)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


def bit_diff(a: np.ndarray, b: np.ndarray) -> dict:
    """Entries that differ and the largest relative difference."""
    scale = float(np.abs(b).max()) or 1.0
    return {"differ": int(np.count_nonzero(a != b)), "rel": float(np.abs(a - b).max()) / scale}


def compare_runs(a: dict, b: dict) -> dict:
    """Two ``train`` runs from one state and draws: per metric, the steps
    that differ and the largest relative difference over the steps; m_nat,
    H_nat and every parameter likewise; the first quantity that differs."""
    out, first = {}, None
    for key in ("net", "kld", "recon", "nll"):
        x = np.asarray([m[key] for m in a["steps"]])
        y = np.asarray([m[key] for m in b["steps"]])
        out[key] = bit_diff(x, y)
        if first is None and out[key]["differ"]:
            first = f"{key} at step {int(np.argmax(x != y)) + 1}"
    for key in ("m_nat", "H_nat"):
        out[key] = bit_diff(a[key], b[key])
    diffs = [bit_diff(x, y) for x, y in zip(a["params"], b["params"])]
    out["params"] = {"differ": sum(d["differ"] for d in diffs),
                     "rel": max(d["rel"] for d in diffs)}
    if first is None:
        first = next((k for k in ("m_nat", "H_nat", "params") if out[k]["differ"]), None)
    out["first_difference"] = first
    return out


def graph_vs_eager(world: World) -> dict:
    """TRAIN_EPOCHS epochs from H + H_SHIFT·I on the card through the
    captured graph and through the same step function run eagerly, on the
    same draws, with a second eager run as the witness of the eager path's
    own repeatability: with cuDNN's default algorithms (reported) and with
    its deterministic ones (held to GRAPH_STEPS_RTOL)."""
    res = {}
    for mode in ("default", "deterministic"):
        with (deterministic_cudnn() if mode == "deterministic" else contextlib.nullcontext()):
            graph = train(world, "cuda", H_SHIFT)
            eager = train(world, "cuda", H_SHIFT, eager=True)
            witness = train(world, "cuda", H_SHIFT, eager=True)
        res[mode] = {"graph_vs_eager": compare_runs(graph, eager),
                     "eager_vs_eager": compare_runs(witness, eager)}
        if graph["per_step"] != eager["per_step"]:
            raise AssertionError(f"graph and eager launches differ: {graph['per_step']} "
                                 f"{eager['per_step']}")
    held = res["deterministic"]["graph_vs_eager"]
    worst = max(v["rel"] for k, v in held.items() if k != "first_difference")
    if not worst <= GRAPH_STEPS_RTOL:
        raise AssertionError(f"graph vs eager on the card: {json.dumps(res)}")
    return res


def resume_vs_straight(world: World, root: str) -> dict:
    """Two one-epoch chunks straight through against one chunk, a saved
    checkpoint loaded into a new trainer through the state setter, and one
    more chunk, on the card (cuDNN deterministic): the second chunk's
    metrics, (m, H) and every parameter must be bit-equal."""
    with deterministic_cudnn():
        return _resume_vs_straight(world, root)


def _resume_vs_straight(world: World, root: str) -> dict:
    a = world.trainer("cuda")
    a.run_epochs(1)
    a.run_epochs(1)
    b = world.trainer("cuda")
    b.run_epochs(1)
    path = save_checkpoint(os.path.join(root, "resume.ckpt"), b.state)
    c = world.trainer("cuda")
    c.state = load_checkpoint(path, like=c.state)
    c.run_epochs(1)
    got = {"steps": [m._asdict() for m, _ in c.last_steps]}
    want = {"steps": [m._asdict() for m, _ in a.last_steps]}
    for run, tr in ((got, c), (want, a)):
        run.update(m_nat=tr.state.m_nat.cpu().double().numpy(),
                   H_nat=tr.state.H_nat.cpu().double().numpy(),
                   params=[p.detach().cpu().double().numpy()
                           for p in tr.state.trainables.parameters()])
    res = compare_runs(got, want)
    if res["first_difference"] is not None or c.state.step != a.state.step:
        raise AssertionError(f"resume vs straight through: {json.dumps(res)}")
    return res


def rollback_vs_replay(root: str, run: dict) -> dict:
    """One rollback through the pipeline's epoch callback on the card
    (``auto_recover``; the second epoch's state poisoned once, so the
    callback restores the first epoch's snapshot and reseeds the generator)
    against the same restore done by hand on a second trainer (cuDNN
    deterministic): the epochs after the rollback and the end state must
    be bit-equal."""
    with deterministic_cudnn():
        return _rollback_vs_replay(root, run)


def _rollback_vs_replay(root: str, run: dict) -> dict:
    results = os.path.join(root, "rollback")
    cfg, _ = parse_flag_lines(pipeline_flags(
        run["data"], results, "--epochs=3", "--checkpoint_every=1", "--test_freq=0",
        "--auto_recover=True", f"--model_params={run['results']}/model_params_vae.ckpt",
        "--gp_model_folder="))
    pipe = pipeline_mod.LVAEPipeline(cfg, device="cuda")
    trainer = pipe.build_trainer()
    real, poisoned = trainer.run_epochs, []

    def run_epochs(n):
        out = real(n)
        if len(trainer.history) == 2 and not poisoned:
            poisoned.append(True)
            with torch.no_grad():
                trainer.state.trainables.gp.kp0.raw_scale.fill_(float("nan"))
        return out

    trainer.run_epochs = run_epochs
    pipe.train()
    if pipe.recoveries != 1 or len(trainer.history) != 3:
        raise AssertionError(f"rollback: {pipe.recoveries} recoveries, "
                             f"{len(trainer.history)} epochs")
    cfg2, _ = parse_flag_lines(pipeline_flags(
        run["data"], os.path.join(root, "rollback_ref"), "--test_freq=0",
        f"--model_params={run['results']}/model_params_vae.ckpt", "--gp_model_folder="))
    ref = pipeline_mod.LVAEPipeline(cfg2, device="cuda").build_trainer()
    ref.run_epochs(1)
    path = save_checkpoint(os.path.join(root, "rollback_ref.ckpt"), ref.state)
    state = load_checkpoint(path, like=ref.state)
    seed = int(torch.randint(0, 2**62, (1,), generator=state.rng))
    state.rng.manual_seed(seed + 1)
    ref.state = state
    ref.run_epochs(2)
    got = {"steps": [{k: v for k, v in m._asdict().items()} for m in trainer.history[1:]]}
    want = {"steps": [{k: v for k, v in m._asdict().items()} for m in ref.history[1:]]}
    for r, tr in ((got, trainer), (want, ref)):
        r.update(m_nat=tr.state.m_nat.cpu().double().numpy(),
                 H_nat=tr.state.H_nat.cpu().double().numpy(),
                 params=[p.detach().cpu().double().numpy()
                         for p in tr.state.trainables.parameters()])
    res = compare_runs(got, want)
    if res["first_difference"] is not None:
        raise AssertionError(f"rollback vs replay: {json.dumps(res)}")
    return res


def pretrain_times(world: World) -> dict:
    """The pre-training epoch program on the card at the cohort's 2000
    frames (7 batches of 256): a warm epoch's wall time and profile, and
    the CPU's first epoch from the same weights and draws held to the
    card's within LOSS_RTOL."""
    class Cohort:
        data, mask = world.frames, world.pixmask

        def __len__(self):
            return len(world.frames)

    runs = {}
    for dev in ("cuda", "cpu"):
        pre = VAEPretrainer(world.model(), Cohort(), loss_function="nll", dropout=False,
                            seed=world.seed, device=dev)
        runs[dev] = (pre, pre.run_epoch())
    pre = runs["cuda"][0]
    errs = {k: rel(a, b) for k, a, b in zip(("loss", "recon", "nll", "kld"), runs["cuda"][1],
                                            runs["cpu"][1])}
    if not max(errs.values()) <= LOSS_RTOL:
        raise AssertionError(f"pretrain epoch card vs CPU: {errs}")
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pre.run_epoch()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"epoch_ms": statistics.median(ms), "steps": world.frames.shape[0] // pre.batch_size,
            "profile": profile_window(pre.run_epoch, 2), "card_vs_cpu": errs}


def replay_profiles(seed: int, data: str, results: str) -> dict:
    """Rank side of a world of one: the profiler's traces of CUDA graph
    replays, in a fresh process. In the long main process a traced replay
    crashed it (a segmentation fault in the replay, under the profiler,
    after the earlier phases' many profiler sessions), while each phase
    before it, followed by a traced replay in a fresh process, did not.
    Here: the Hensman run's eager and replayed step times, the capture's
    cost and a replayed epoch (:func:`replayed_step_times`), the
    pre-training epoch program (:func:`pretrain_times`), the serving
    bundle's replayed and eager requests (:func:`serving_replay_times`),
    the VI programs (:func:`vi_replay_times`), the bf16 recurrence's weight
    layout (:func:`rnn_compaction_warnings`), the bf16 Hensman run's
    replayed step and epoch, the names of the kernels of an f32 and a bf16
    replayed step, the f32 and bf16 profiles of a replayed VI step and
    request (:func:`bf16_profiles`), the standard runs' replayed and eager
    steps (:func:`standard_replay_times`), and one epoch of the CLI run's
    resumed pipeline (``data`` and ``results`` its folders)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = World(seed)
    compaction = rnn_compaction_warnings(world)
    trainer = train(world, "cuda")["trainer"]
    out = {"rnn_compaction_warnings": compaction, "eager": hensman_step_times(trainer),
           "replay": replayed_step_times(trainer), "pretrain": pretrain_times(world),
           "serving": serving_replay_times(world), "vi": vi_replay_times(world)}
    b16 = train(world, "cuda", compute=BF16)["trainer"]
    out["bf16"] = replayed_step_times(b16)
    out["kernel_names"] = {"f32": step_kernel_names(trainer), "bf16": step_kernel_names(b16)}
    out["bf16_profiles"] = bf16_profiles(world)
    t0 = time.perf_counter()
    out["standard"] = standard_replay_times(world)
    out["standard_seconds"] = time.perf_counter() - t0
    pipe = resumed_pipeline(PIPE_DIR, {"data": data, "results": results}, "cuda")
    out["pipeline_epoch"] = profile_window(pipe.trainer.run_epoch, 1)
    return out


GRAPH_DIR = os.path.join(ROOT, "build", "chip_smoke_graph")  # git-ignored


# ---------------------------------------------------------------- parallel
PAR_DIR = os.path.join(ROOT, "build", "chip_smoke_parallel")  # git-ignored
PAR_SHAPES = ((1, 2), (2, 1))  # (data, latent) meshes of 2 ranks sharing the card
PAR_TIMEOUT = 300  # seconds a world of ranks may take
PAR_CLI_EPOCHS = 2
# a request of 2 new subjects: the basis then holds P + 2 subjects, which
# divide the data axis, and the 2 query subjects split over it
PAR_REQUEST = 2
# sharded vs one process, both on the card in f32, are held to the
# card-vs-CPU limits (LOSS_TOLS, VARIATIONAL_RTOL, LATENT_RTOL). The same
# pair in f64 (the plain versions: the kernels take f32) is held to
# PAR_F64_RTOL on every step's net, KL and recon and on the final (m, H).
# f64 keeps the fixed 1e-6 jitter, so K0zz's condition number is near
# 3.5e7 (5.7e4 in f32, whose jitter is floored; printed by the phase) and
# f64 rounding reaches about 1e-8 over 10 steps; a term counted twice or
# dropped on a shard moves the KL by 1e-3 or more
PAR_F64_RTOL = 1e-6


class ShapeLog:
    """While active: the shape of every launch of K1, K2 and K3, read
    through the wrappers' private ``_launch`` (each public wrapper calls it
    once a launch; the launch counts stay the wrappers')."""

    def __enter__(self):
        self.shapes = {"b_chain": [], "chol_inv": [], "kernel_matrix": []}
        self._saved = (k1._launch, k2._launch, k3._launch)

        def record(name, fn, shape_of):
            def wrapped(*args, **kwargs):
                self.shapes[name].append(shape_of(*args))
                return fn(*args, **kwargs)
            return wrapped

        # K1: [latents, subjects, T]; K2: the stack; K3: [latents, N1, N2]
        k1._launch = record("b_chain", self._saved[0], lambda *a: [a[2].shape[0], *a[7].shape[:2]])
        k2._launch = record("chol_inv", self._saved[1], lambda a, p: list(a.shape))
        k3._launch = record("kernel_matrix", self._saved[2],
                            lambda spec, scale, g, x1, x2, *rest: [scale.shape[0], x1.shape[0],
                                                                   x2.shape[0]])
        return self

    def __exit__(self, *exc):
        k1._launch, k2._launch, k3._launch = self._saved
        return False

    def distinct(self) -> dict:
        return {name: sorted({tuple(s) for s in shapes}) for name, shapes in self.shapes.items()}


def run_ranks(nprocs: int, fn, args: tuple, name: str) -> list:
    """``fn(*args)`` on ``nprocs`` spawned ranks on the card
    (``parallel.distributed.spawn_ranks``); returns each rank's result. A
    rank that fails, or a world past PAR_TIMEOUT, raises."""
    out = os.path.join(PAR_DIR, name)
    return join_ranks(spawn_ranks(nprocs, fn, args, out), out, PAR_TIMEOUT)


def request_of(world: World, k: int = PAR_REQUEST):
    """The first ``k`` request subjects' observed frames and labels and
    their queries, flat."""
    def flat(a):
        return a[:k].reshape((-1,) + a.shape[2:])

    return flat(world.obs_frames), flat(world.obs_labels), flat(world.query_labels)


def par_step_times(trainer: HensmanTrainer) -> dict:
    """Warm sharded steps: the host clock of 6 steps ending in a
    synchronise (median of the last 5), then a profiler window of 3 with
    the device time of the whole step and of its collectives."""
    table = trainer.tables[0]
    rows = torch.arange(trainer.subjects_per_batch)
    step_ms = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.train_step(table, rows)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    window = profile_window(lambda: trainer.train_step(table, rows), 3, collectives=True)
    return {"host_ms": statistics.median(step_ms[1:]), "profile": window}


def sharded_epochs(world: World, mesh, dtype=torch.float32, compute=None,
                   epochs: int = TRAIN_EPOCHS) -> dict:
    """The single-process card run's Hensman epochs through
    ``ShardedHensmanTrainer`` on ``mesh`` (from H + H_SHIFT·I; the order and
    noise come from the same seeded generator on every rank; ``epochs``
    of them, the VAE computing in ``compute``): each step's
    metrics and kernel launches, the launch counts (set to 0 just before),
    the shapes launched, the final (m, H) and the trainer."""
    trainer = world.trainer(str(mesh.device), world.model(dtype, compute), dtype=dtype)
    h = trainer.state.H_nat
    trainer.state = trainer.state._replace(
        H_nat=h + H_SHIFT * torch.eye(h.shape[-1], dtype=h.dtype, device=h.device))
    sharded = ShardedHensmanTrainer(trainer, mesh)
    per_step, real_step = [], trainer._run_step

    def counted_step(b, rows, eps, out):
        before = launch_counts()
        real_step(b, rows, eps, out)
        per_step.append({k: v - before[k] for k, v in launch_counts().items()})

    trainer._run_step = counted_step
    reset_launch_counts()
    with ShapeLog() as log:
        sharded.run_epochs(epochs)
    trainer._run_step = real_step
    steps = [m._asdict() for m, _ in trainer.last_steps]
    return {"steps": steps, "per_step": per_step, "launches": launch_counts(),
            "shapes": log.distinct(),
            "m_nat": trainer.state.m_nat.detach().cpu().double().numpy(),
            "H_nat": trainer.state.H_nat.detach().cpu().double().numpy(),
            "trainer": trainer}


def par_hensman(world: World, shape) -> dict:
    """Rank side of a mesh: the single-process card run's Hensman epochs in
    f32 and in f64, then its serving request, and at (1, 2) the closed
    standard epochs, each with the kernels it launched and their shapes;
    the step's host time and its collectives; the seconds of each part."""
    seconds = {}
    t0 = time.perf_counter()
    mesh = make_mesh(*shape)
    dev = str(mesh.device)
    out = sharded_epochs(world, mesh)
    trainer = out.pop("trainer")
    seconds["hensman"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["timing"] = par_step_times(trainer)
    seconds["timing"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    f64 = sharded_epochs(world, mesh, torch.float64)
    out["f64"] = {k: f64[k] for k in ("steps", "m_nat", "H_nat")}
    seconds["f64"] = time.perf_counter() - t0
    if shape == BF16_PAR_SHAPE:
        t0 = time.perf_counter()
        b16 = sharded_epochs(world, mesh, compute=BF16, epochs=BF16_PAR_EPOCHS)
        out["bf16"] = {k: b16[k] for k in ("steps", "per_step", "m_nat", "H_nat", "launches")}
        seconds["bf16"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    model = world.model()
    mu, _ = encode_dataset(model, world.frames, device=dev)
    pred = LVAEPredictor(
        model=model, gp_params=world.gp, noise=world.noise, spec0=world.spec0,
        spec1=world.spec1, z=world.z, id_covariate=world.cfg.id_covariate,
        basis_labels=world.labels, basis_mu=mu, eps=world.cfg.eps, device=dev, mesh=mesh)
    reset_launch_counts()
    with ShapeLog() as log:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out["served"] = pred.predict_latent_trajectory(*request_of(world))
        torch.cuda.synchronize()
    out["serve"] = {"ms": (time.perf_counter() - t1) * 1e3, "launches": launch_counts(),
                    "shapes": log.distinct()}
    seconds["serve"] = time.perf_counter() - t0

    if shape == (1, 2):
        t0 = time.perf_counter()
        std = ShardedStandardTrainer(world.standard_trainer(dev, "closed"), mesh)
        reset_launch_counts()
        with ShapeLog() as log:
            out["closed"] = [std.run_epoch()._asdict() for _ in range(STD_EPOCHS)]
        out["closed_launches"] = {"launches": launch_counts(), "shapes": log.distinct()}
        seconds["closed"] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def par_meshes(seed: int, spawned_at: float) -> dict:
    """Rank side: :func:`par_hensman` at each mesh of PAR_SHAPES, in turn,
    over one process group (cuDNN's TF32 off, as in the parent), and the
    seconds from the spawn to the group."""
    started = time.time() - spawned_at
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = World(seed)
    out = {shape: par_hensman(world, shape) for shape in PAR_SHAPES}
    return {"meshes": out, "backend": torch.distributed.get_backend(),
            "start_s": started}


def k0zz_condition(world: World) -> dict:
    """The largest condition number over the latents of the initial K0zz
    with its jitter, in f32 (floored jitter) and in f64 (the fixed eps)."""
    spec0 = world.spec0
    out = {}
    for dtype in (torch.float32, torch.float64):
        kp0 = world.gp.kp0.to(device="cuda", dtype=dtype)
        z = torch.as_tensor(world.z, device="cuda", dtype=dtype)
        kzz = kx.add_adaptive_jitter(kx.kernel_matrix(spec0, kp0, z, z), world.cfg.eps)
        out[str(dtype).split(".")[-1]] = float(torch.linalg.cond(kzz.double()).max())
    return out


def nccl_world_of_one(seed: int) -> dict:
    """This process as a world of one rank on an NCCL group (its own card):
    one epoch of the sharded Hensman trainer on the trivial 1 x 1 mesh,
    whose gradient and metric sums cross NCCL; the group is torn down
    after."""
    env = dict(os.environ)
    initialize_distributed(f"localhost:{free_port()}", 1, 0)
    try:
        mesh = make_mesh(1, 1)
        world = World(seed)
        trainer = world.trainer(str(mesh.device))
        h = trainer.state.H_nat
        trainer.state = trainer.state._replace(
            H_nat=h + H_SHIFT * torch.eye(h.shape[-1], dtype=h.dtype, device=h.device))
        m = ShardedHensmanTrainer(trainer, mesh).run_epoch()
        out = {"epoch": m._asdict(), "group": repr(mesh.world_group),
               "backend": torch.distributed.get_backend()}
    finally:
        torch.distributed.destroy_process_group()
        os.environ.clear()
        os.environ.update(env)
    return out


def expected_par_shapes(world: World, shape) -> dict:
    """What each rank must launch at mesh ``(data, latent)``: K1 on
    ``[L/l, S/d, T]``; K2 on the stacked ``[2L/l, M, M]``, the natural
    gradient's ``[L/l, M, M]`` and, serving, the fold's ``[L/l, P'/d, T, T]``
    (P' = P + the request's subjects); K3 on ``[L/l, N, N]``."""
    cfg = world.cfg
    d, l = shape
    lat = cfg.latent_dim // l
    n = cfg.P * cfg.T
    return {"b_chain": [(lat, cfg.subjects_per_batch // d, cfg.T)],
            "chol_inv": [(2 * lat, cfg.M, cfg.M), (lat, cfg.M, cfg.M)],
            "serve": [(lat, (cfg.P + PAR_REQUEST) // d, cfg.T, cfg.T)],
            "kernel_matrix": [(lat, n, n)]}


def check_par_launches(world: World, shape, ranks: list) -> None:
    """Every rank launched K1 and K2 each step, at the per-rank shapes, K2
    at the fold's, and at (1, 2) K3 at ``[L/l, N, N]``."""
    want = expected_par_shapes(world, shape)
    for rank, r in enumerate(ranks):
        where = f"mesh {shape} rank {rank}"
        if r["backend"] != "gloo":
            raise AssertionError(f"{where}: backend {r['backend']}, expected gloo")
        if any(s["b_chain"] != 1 or s["chol_inv"] != 3 for s in r["per_step"]):
            raise AssertionError(f"{where}: a step did not launch K1 once and K2 three times: "
                                 f"{r['per_step']}")
        got = r["shapes"]
        if got["b_chain"] != want["b_chain"] or got["chol_inv"] != sorted(want["chol_inv"]):
            raise AssertionError(f"{where}: kernel shapes {got}, expected {want}")
        if tuple(want["serve"][0]) not in r["serve"]["shapes"]["chol_inv"]:
            raise AssertionError(f"{where}: serving launched K2 at {r['serve']['shapes']}, "
                                 f"expected {want['serve']}")
        if "closed" in r and r["closed_launches"]["shapes"]["kernel_matrix"] != \
                want["kernel_matrix"]:
            raise AssertionError(f"{where}: K3 at {r['closed_launches']['shapes']}, expected "
                                 f"{want['kernel_matrix']}")


def check_parallel(shape, ranks: list, single: dict, single64: dict, served_ref: np.ndarray,
                   closed_ref: list) -> dict:
    """Every rank: each f32 step within the card-vs-CPU limits of the
    single-process card run, the final (m, H), the served latents and, at
    (1, 2), the closed epochs; each f64 step and the f64 (m, H) within
    PAR_F64_RTOL of the single-process f64 run."""
    errs = {}
    for rank, r in enumerate(ranks):
        where = f"mesh {shape} rank {rank}"
        e = errs[f"rank{rank}"] = {
            "steps": compare_losses(r["steps"], single["steps"], keys=("net", "kld", "recon")),
            "end_state": compare_variational(r, single),
            "served": float(np.abs(r["served"] - served_ref).max() / np.abs(served_ref).max()),
            "f64": compare_losses(r["f64"]["steps"], single64["steps"],
                                  keys=("net", "kld", "recon"))
            | compare_variational(r["f64"], single64),
        }
        if "closed" in r:
            e["closed"] = compare_losses(r["closed"], closed_ref, keys=STD_LOSS_KEYS)
        check_within({k: e[k] for k in ("steps", "end_state", "closed") if k in e})
        if not e["served"] <= LATENT_RTOL:
            raise AssertionError(f"{where}: served latents rel {e['served']:.3e} > {LATENT_RTOL}")
        bad = {k: v for k, v in e["f64"].items() if not v <= PAR_F64_RTOL}
        if bad:
            raise AssertionError(f"{where}: f64 sharded vs one process {bad} > {PAR_F64_RTOL}")
    return errs


def run_parallel_cli(world: World, pipe_run: dict) -> dict:
    """``torchrun --nproc_per_node=2 -m lvae_torch.cli ... --data_mesh=2`` on
    the pipeline's data, from its pre-trained VAE, for PAR_CLI_EPOCHS
    epochs with validation and tests (generation off: the in-process CLI
    runs it). Each output line is stamped on arrival: the seconds to the
    ranks' process groups and to the first epoch are start-up."""
    import threading

    root = os.path.dirname(pipe_run["results"])
    results = os.path.join(root, "parallel_cli")
    flags = write_flags(os.path.join(root, "parallel.txt"), pipeline_flags(
        pipe_run["data"], results, f"--epochs={PAR_CLI_EPOCHS}",
        f"--test_freq={PAR_CLI_EPOCHS}", f"--checkpoint_every={PAR_CLI_EPOCHS}",
        "--run_tests=True", "--run_validation=True", "--generate_images=False",
        f"--model_params={pipe_run['results']}/model_params_vae.ckpt", "--gp_model_folder=",
        f"--seed={world.seed}"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=2",
           "-m", "lvae_torch.cli", f"--f={flags}", "--data_mesh=2"]
    env = dict(os.environ, PYTHONUNBUFFERED="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    timer = threading.Timer(PAR_TIMEOUT, proc.kill)
    timer.start()
    try:
        lines = [(time.perf_counter() - t0, line.rstrip("\n")) for line in proc.stdout]
        rc = proc.wait()
    finally:
        timer.cancel()
    seconds = time.perf_counter() - t0
    if rc != 0:
        print("\n".join(line for _, line in lines[-80:]), file=sys.stderr)
        raise AssertionError(f"torchrun CLI exited {rc}")
    out = check_pipeline_run(results, PAR_CLI_EPOCHS, world.hw, artefacts=[
        a for a in PIPE_ARTEFACTS if a != "model_params_vae.ckpt"
        and not a.startswith("recon_complete")])
    inits = [(s, line) for s, line in lines if line.startswith("initialize_distributed:")]
    groups = sorted({line.split(" on ")[0] + ": " + line.split("backend ")[1].split(",")[0]
                     for _, line in inits})
    if len(groups) != 2:
        raise AssertionError(f"torchrun: {len(groups)} ranks reported a process group")
    first_epoch = next((s for s, line in lines if line.startswith("Iter ")), None)
    return {"seconds": seconds, "groups": groups, "to_groups_s": max(s for s, _ in inits),
            "to_first_epoch_s": first_epoch, **out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    started = time.perf_counter()
    # phase 1: device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a GPU",
              file=sys.stderr)
        return 1
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", f"{card} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()} | TF32 off")

    # phase 2: build every kernel of the path from the checkout's sources
    t0 = time.perf_counter()
    logs = build.build_all()
    say("build", f"{sorted(logs)} built in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                say("build", f"{name}: {line.strip()}")

    world = World(args.seed)
    deferred = []  # checks raised at the end, after every phase has printed

    # phase 3: each kernel against its plain version, and its times
    entry = check_k2(world)
    entry["per_shape"] += check_k2_training(world)
    k1_entry = check_k1(world)
    k3_entry = check_k3(world)
    k4_entry = check_k4(world)
    k5_entry = check_k5(world)

    # phase 4: the serving path on the card; counts from 0 just before it
    reset_launch_counts()
    gpu = serve(world, "cuda")
    serve_counts = launch_counts()
    say("serving", f"K2 launches by call {json.dumps(gpu['launches'])}")
    for name, counts in gpu["launches"].items():
        if name != "impute" and min(counts) < 1:
            raise AssertionError(f"K2 was not launched during a call of {name}")
    check_outputs(gpu["out"], world)
    t = {name: [s * 1e3 for s in v] for name, v in gpu["times"].items()}
    say("serving", f"aot_compile (fold and 4 captures) cold {t['fold'][0]:.3f} ms, warm median "
        f"{statistics.median(t['fold'][1:]):.3f} ms over {N_FOLDS - 1} (P={world.cfg.P} "
        f"T={world.cfg.T} L={world.cfg.latent_dim} M={world.cfg.M})")
    say("serving", f"predict_trajectories K={K_SUBJECTS} median "
        f"{statistics.median(t['predict_trajectories']):.3f} ms over {N_REQUESTS} "
        f"(first {t['predict_trajectories'][0]:.3f}); "
        f"predict_trajectory {t['predict_trajectory'][0]:.3f} ms; "
        f"predict_latent_trajectory cold {t['predict_latent_trajectory'][0]:.3f} ms, "
        f"warm {t['predict_latent_trajectory'][1]:.3f} ms; "
        f"refresh_basis {t['refresh_basis'][0]:.3f} ms")
    say("serving", f"impute {BATCH * 1e3 / statistics.median(t['impute']):.1f} frames/s "
        f"(median of {len(t['impute'])})")
    fg = gpu["fold_graphs"]
    say("serving", f"basis programs' graphs after each of {N_FOLDS} aot_compile calls "
        f"{json.dumps(fg)}: the first captured the fold, the later ones replayed it")
    if len(fg[0]) != 1 or any(g != fg[0] for g in fg[1:]):
        raise AssertionError(f"a second aot_compile captured the basis fold again: {fg}")

    # the same calls on the CPU, through the plain versions
    before = k2.cholesky_inverse.launches
    cpu = serve(world, "cpu")
    if k2.cholesky_inverse.launches != before:
        raise AssertionError("the CPU run launched the CUDA kernel")
    check_outputs(cpu["out"], world)
    errs = compare(gpu["out"], cpu["out"])
    say("compare", f"card vs CPU {json.dumps(errs)} (latents rel <= {LATENT_RTOL}, "
        f"frames abs <= {FRAME_ATOL})")

    # the captured programs against the same programs run eagerly (their
    # traces are taken in a fresh process, below)
    say("serving", f"captured programs {sorted(gpu['bundle']._graphs)}; the trajectory graph "
        f"records {json.dumps(graph_launches(gpu['bundle']._graphs['trajectory']))}")
    t0 = time.perf_counter()
    s_gve = serving_graph_vs_eager(world, gpu["pred"])
    for mode in ("default", "deterministic"):
        say("compare", f"serving graph vs eager on the card, cuDNN {mode}: "
            f"{json.dumps(s_gve[mode]['graph_vs_eager'])}; sibling's entries that differ "
            f"across its parent's refresh {s_gve[mode]['sibling_across_refresh']}"
            + (" (held bit-equal)" if mode == "deterministic" else "")
            + f" ({time.perf_counter() - t0:.1f} s | {card})")

    # phase 5: the Hensman training path on the card; counts from 0 just before it
    reset_launch_counts()
    t0 = time.perf_counter()
    card_run = train(world, "cuda")
    train_s = time.perf_counter() - t0
    train_launches = launch_counts()
    steps = len(card_run["per_step"])
    say("training", f"{steps} steps in {train_s:.3f} s (first call included); launches "
        f"{json.dumps(train_launches)}; per step (K1, K2) {card_run['per_step']}")
    if any(step != (1, 3) for step in card_run["per_step"]):
        raise AssertionError("a training step did not launch K1 once and K2 3 times")
    check_training(card_run)
    for e, m in enumerate(card_run["epochs"]):
        say("training", f"card epoch {e + 1}: {json.dumps(m)}")
    if not all(card_run["ng_applied"]):
        raise AssertionError(f"the card refused a natural-gradient step: {card_run['ng_applied']}")

    # the same steps on the CPU, from the same state and randomness. At the
    # reference's init H = h hᵀ (h a square 60×60 Gaussian) is nearly
    # singular (smallest eigenvalue ~1e-8): in f32 its log-determinant and
    # whether iH_new factors are decided by rounding, so the card and the
    # CPU may differ in the KL term from the first step and take different
    # branches of the PSD-cone guard from the first update on. This run is
    # held to the card's first-step reconstruction losses, which do not read
    # H; a second pair of runs from H + H_SHIFT·I is held over every step's
    # losses and its end state.
    cpu_run = train(world, "cpu")
    check_training(cpu_run)
    say("training", f"natural-gradient updates applied per step: card "
        f"{card_run['ng_applied']}, CPU {cpu_run['ng_applied']}")
    for e, m in enumerate(cpu_run["epochs"]):
        say("training", f"CPU epoch {e + 1}: {json.dumps(m)}")
    t_errs = {"first_step": compare_losses(card_run["steps"][:1], cpu_run["steps"][:1],
                                           keys=("recon", "nll"))}
    kl_first = rel(card_run["steps"][0]["kld"], cpu_run["steps"][0]["kld"])
    card_c, cpu_c = train(world, "cuda", H_SHIFT), train(world, "cpu", H_SHIFT)
    for run in (cpu_run, cpu_c):
        if any(step != (0, 0) for step in run["per_step"]):
            raise AssertionError("a CPU training run launched a CUDA kernel")
    for run in (card_c, cpu_c):
        check_training(run)
    for e, (a, b) in enumerate(zip(card_c["epochs"], cpu_c["epochs"])):
        say("training", f"H+{H_SHIFT}I epoch {e + 1}: card {json.dumps(a)} CPU {json.dumps(b)}")
    t_errs["shifted_steps"] = compare_losses(card_c["steps"], cpu_c["steps"])
    t_errs["shifted_epochs"] = compare_losses(card_c["epochs"], cpu_c["epochs"])
    t_errs["shifted_end_state"] = compare_variational(card_c, cpu_c)
    say("compare", f"training card vs CPU {json.dumps(t_errs)} (tolerances "
        f"{json.dumps(LOSS_TOLS)}, m/H {VARIATIONAL_RTOL}); not held: first-step KL "
        f"at the raw init {kl_first:.3e}")
    check_within(t_errs)

    # the captured step against the same step run eagerly, from one state
    # and one set of draws; resume from a checkpoint against the run
    # straight through
    t0 = time.perf_counter()
    gve = graph_vs_eager(world)
    for mode in ("default", "deterministic"):
        say("compare", f"graph vs eager on the card, {steps} steps from H+{H_SHIFT}I, cuDNN "
            f"{mode}: {json.dumps(gve[mode]['graph_vs_eager'])}; eager vs eager (witness) "
            f"{json.dumps(gve[mode]['eager_vs_eager'])}"
            + (f" (held <= {GRAPH_STEPS_RTOL:g} rel)" if mode == "deterministic" else "")
            + f" | {card}")
    os.makedirs(GRAPH_DIR, exist_ok=True)
    try:
        res = resume_vs_straight(world, GRAPH_DIR)
    finally:
        shutil.rmtree(GRAPH_DIR, ignore_errors=True)
    say("compare", f"resume (1 epoch, save, load through the state setter, 1 epoch) vs 2 "
        f"epochs straight through on the card: {json.dumps(res)} "
        f"({time.perf_counter() - t0:.1f} s)")

    # warm steps on the card, eager and replayed in this call: host clock
    # per step, then a profiler window; the capture's cost; a replayed epoch
    trainer = card_run["trainer"]
    warm = warm_single = hensman_step_times(trainer)
    say("training", f"eager step (host clock, warm) median {warm['host_ms']:.3f} ms over 5, "
        f"first {warm['first_ms']:.3f} ms (S={trainer.subjects_per_batch} T={world.cfg.T} "
        f"L={world.cfg.latent_dim} M={world.cfg.M}) | {card}")
    say("profile", "train_step " + json.dumps(warm["profile"]))

    # phase 6: the standard training path on the card, each epoch a replay
    # of its captured step (the first the capture's warm-up); counts from 0
    # just before it
    reset_launch_counts()
    t0 = time.perf_counter()
    std_runs = standard_path(world)
    std_counts = launch_counts()
    say("standard", f"{sum(len(r['epochs']) for r in std_runs.values())} steps in "
        f"{time.perf_counter() - t0:.3f} s; launches {json.dumps(std_counts)}")
    for kernel in ("b_chain", "chol_inv", "kernel_matrix", "adam"):
        if std_counts[kernel] < 1:
            raise AssertionError(f"{kernel} was not launched on the standard path")

    # each run's captured step against the same steps run eagerly, from one
    # state on one noise (cuDNN deterministic); a fit that rolls back; fresh
    # dropout masks each replay (their traces are taken in a fresh process)
    t0 = time.perf_counter()
    std_gve = standard_graph_vs_eager(world)
    for name, r in std_gve.items():
        tm = r["times"]
        say("compare", f"standard {name} graph vs eager on the card "
            f"({STD_GVE_EPOCHS + STD_TIMED + 1} epochs from one state, cuDNN deterministic, "
            f"held bit-equal): {json.dumps(r['graph_vs_eager'])}")
        say("standard", f"{name}: a replayed step launched {json.dumps(r['per_step'])} (the "
            f"graph records {json.dumps(r['per_replay'])}); host clock a warm step replayed "
            f"{[round(x, 3) for x in tm['replayed_ms']]} ms, eager "
            f"{[round(x, 3) for x in tm['eager_ms']]} ms | {card}")
    mem = std_gve["closed"]["memory"]
    say("standard", f"closed step device memory (N={world.labels.shape[0]}): eager peak "
        f"{mem['eager_peak_gib']:.3f} GiB ({mem['eager_peak_above_state_gib']:.3f} above the "
        f"trainer's state), replayed with its capture peak {mem['replayed_peak_gib']:.3f} GiB "
        f"({mem['replayed_peak_above_state_gib']:.3f} above), kept after empty_cache: eager "
        f"{mem['eager_kept_gib']:.3f} GiB, replayed (the graph's pool) "
        f"{mem['replayed_kept_gib']:.3f} GiB | {card}")
    os.makedirs(STD_DIR, exist_ok=True)
    try:
        std_rb = standard_rollback(world, STD_DIR)
    finally:
        shutil.rmtree(STD_DIR, ignore_errors=True)
    say("compare", f"standard fit over 2 chunks of {STD_CHUNK} epochs, replayed, chunk 2 "
        f"rolled back once through the state setter, vs eager straight through (held "
        f"bit-equal): {json.dumps(std_rb)}")
    std_drop = standard_dropout_replays(world)
    say("standard", f"two replays from one state on one noise (GPapprox_closed), entries "
        f"that differ: {json.dumps(std_drop)} (dropout {STD_DROPOUT}: fresh masks each replay; "
        f"none: the same bits) ({time.perf_counter() - t0:.1f} s | {card})")

    s_errs = compare_standard(world)
    say("compare", f"standard card vs CPU {json.dumps(s_errs)} (tolerances "
        f"{json.dumps({k: LOSS_TOLS[k] for k in STD_LOSS_KEYS})})")
    check_within(s_errs)

    # warm replayed closed-KL steps on the card: host clock per step, then
    # an eager profiler window (the replayed step's is the fresh process's)
    trainer = std_runs["closed"]["trainer"]
    step_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run_epoch()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    say("standard", f"closed step (host clock, warm, replayed) median "
        f"{statistics.median(step_ms):.3f} ms over {len(step_ms)} (N={world.labels.shape[0]} "
        f"L={world.cfg.latent_dim}), peak device memory of the process so far "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    with eager_steps():
        say("profile", "standard_step " + json.dumps(profile_window(trainer.run_epoch, 3)))
    for run in std_runs.values():  # their graphs' pools go
        del run["trainer"]
    del trainer

    # phase 7: the reference-format CLI pipeline at full width through
    # lvae_torch.cli.main; counts from 0 just before the main run
    shutil.rmtree(PIPE_DIR, ignore_errors=True)
    os.makedirs(PIPE_DIR)
    try:
        pipe_run = run_pipeline(world, PIPE_DIR)
        per_epoch = pipe_run["steps_per_epoch"]
        main_run = pipe_run["counter"]
        main_run.check("k1", PIPE_EPOCHS * per_epoch, PIPE_EPOCHS // PIPE_TEST_FREQ + 1,
                       "pipeline")
        say("pipeline", f"stage seconds {json.dumps(pipe_run['times'])}")
        say("pipeline", f"main run ({PIPE_EPOCHS} epochs of {per_epoch} steps, validation every "
            f"{PIPE_TEST_FREQ}): launches {json.dumps(pipe_run['counts'])}; a step "
            f"{json.dumps(main_run.steps[0])}, a validation {json.dumps(main_run.validations[0])}")
        say("pipeline", f"last epoch {json.dumps(pipe_run['losses'])}; test MSEs (VAE, GP) "
            f"{json.dumps(pipe_run['test_mse'])}; resumed from step {pipe_run['final_step']} "
            f"to {pipe_run['resumed_step']}")

        # the K4 route: K1 off, the block-pair switch on; counts from 0 just before it
        k4_run = run_pipeline_k4(world, PIPE_DIR, pipe_run)
        k4_run["counter"].check("k4", K4_EPOCHS * per_epoch, K4_EPOCHS + 1, "pipeline K4 route")
        say("pipeline", f"K4 route: {K4_EPOCHS} epochs in {k4_run['seconds']:.3f} s, launches "
            f"{json.dumps(k4_run['counts'])}; a step {json.dumps(k4_run['counter'].steps[0])}, "
            f"a validation {json.dumps(k4_run['counter'].validations[0])}; last epoch "
            f"{json.dumps(k4_run['losses'])}")

        card_pipe = resumed_pipeline(PIPE_DIR, pipe_run, "cuda")
        route_errs = compare_routes(card_pipe)
        say("compare", f"pipeline batch_loss K4 route vs K1 route {json.dumps(route_errs)} "
            f"(KL, net and gradients <= {KL_RTOL}, recon and nll <= {LOSS_RTOL})")
        check_route_errs(route_errs)

        t0 = time.perf_counter()
        card_eval = evaluate_pipeline(card_pipe)
        cpu_pipe = resumed_pipeline(PIPE_DIR, pipe_run, "cpu")
        cpu_eval = evaluate_pipeline(cpu_pipe)
        p_errs = compare_pipeline(card_eval, cpu_eval)
        say("compare", f"pipeline card vs CPU from model_final.ckpt: card {json.dumps(card_eval)} "
            f"CPU {json.dumps(cpu_eval)} rel {json.dumps(p_errs)} (GP term and net <= "
            f"{KL_RTOL}, recon, nll and test MSEs <= {LOSS_RTOL}; "
            f"{time.perf_counter() - t0:.1f} s)")

        # the evaluation programs from model_final.ckpt, replayed against
        # eager; counts from 0 just before them (their traces are taken in
        # the fresh process, below)
        reset_launch_counts()
        t0 = time.perf_counter()
        ev = eval_phase(world, card_pipe, cpu_pipe, os.path.join(PIPE_DIR, "eval"))
        eval_counts = launch_counts()
        differ = {k: v for k, v in ev["graph_vs_eager"].items() if v}
        say("eval", f"replayed vs eager (cuDNN deterministic), entries that differ: "
            f"{json.dumps(ev['graph_vs_eager'])} ({len(ev['graph_vs_eager'])} answers, each "
            f"held bit-equal); launches of a replayed call {json.dumps(ev['launches'])}; phase "
            f"launches {json.dumps(eval_counts)} ({time.perf_counter() - t0:.1f} s | {card})")
        if differ:
            deferred.append(f"[eval] replayed answers differ from eager: {json.dumps(differ)}")
        vt = ev["validation_host_ms"]
        say("eval", "validation GPapprox_closed (host clock, each call) replayed vs eager: "
            + "; ".join(f"{c} {[round(x, 3) for x in t['replayed_ms']]} vs "
                        f"{[round(x, 3) for x in t['eager_ms']]} ms" for c, t in vt.items())
            + f"; {ev['graphs']} evaluation graphs | {card}")
        ex = ev["exact_compare"]
        say("compare", f"mse_test_exact card vs CPU at {EXACT_COMPARE_CAP} rows: card "
            f"{json.dumps(ex['card'])} CPU {json.dumps(ex['cpu'])} errs {json.dumps(ex['errs'])} "
            f"(latents <= {LATENT_RTOL} rel, frames <= {FRAME_ATOL} abs, MSEs <= {LOSS_RTOL})")
        ef = ev["exact_full"]
        say("eval", f"mse_test_exact on the card, eager by rule, at the {EXACT_CAP}-row cap "
            f"({ef['rows']} generated rows, 400 test rows): host ms "
            f"{[round(t, 3) for t in ef['host_ms']]}; results {json.dumps(ef['results'])} "
            f"| {card}")

        # the Hensman run's reference GP files, before the profile trains on
        export_errs = check_export(world, PIPE_DIR, pipe_run, card_pipe)
        say("export", f"gp_model.pth, zt_list.pth, m.pth, H.pth of the CLI run: a second "
            f"export from model_final.ckpt gives the same bits; read back, |raw param "
            f"difference| {json.dumps(export_errs)} (<= {EXPORT_ATOL:g}), z, m, H equal")

        t0 = time.perf_counter()
        rb = rollback_vs_replay(PIPE_DIR, pipe_run)
        say("compare", f"pipeline rollback (auto_recover, epoch 2 poisoned once) vs the same "
            f"restore by hand, 2 epochs after it on the card: {json.dumps(rb)} "
            f"({time.perf_counter() - t0:.1f} s)")

        # the profiler traces of graph replays, in a fresh process
        t0 = time.perf_counter()
        try:
            prof = run_ranks(1, replay_profiles, (args.seed, pipe_run["data"],
                                                  pipe_run["results"]), "replay")[0]
            t1 = time.perf_counter()
            # the evaluation programs' traces in a fresh process of their own
            evprof = run_ranks(1, eval_replay_profiles, (args.seed, pipe_run["data"],
                                                         pipe_run["results"]), "eval")[0]
            eval_fresh_s = time.perf_counter() - t1
        finally:
            shutil.rmtree(PAR_DIR, ignore_errors=True)
        replay, eager = prof["replay"], prof["eager"]
        say("training", f"in one fresh process: eager step (host clock, warm) median "
            f"{eager['host_ms']:.3f} ms, replayed step {replay['host_ms']:.3f} ms over 5; "
            f"capture {replay['capture_ms']:.3f} ms beyond an eager step (with its warm-up "
            f"step {[round(t, 3) for t in replay['capture_with_warmup_ms']]} ms); replayed "
            f"epoch ({steps // TRAIN_EPOCHS} steps) {replay['epoch_ms']:.3f} ms "
            f"({time.perf_counter() - t0:.1f} s) | {card}")
        b16r = prof["bf16"]
        say("bf16", "in one fresh process, replayed Hensman step f32 vs bf16: host "
            f"{replay['host_ms']:.3f} vs {b16r['host_ms']:.3f} ms, device "
            f"{replay['profile']['device_ms']:.3f} vs {b16r['profile']['device_ms']:.3f} ms, "
            f"host calls {replay['profile']['host_launches_per_call']:g} vs "
            f"{b16r['profile']['host_launches_per_call']:g}, idle "
            f"{replay['profile']['idle_share']:.3f} vs {b16r['profile']['idle_share']:.3f}; "
            f"replayed epoch {replay['epoch_ms']:.3f} vs {b16r['epoch_ms']:.3f} ms; capture "
            f"{b16r['capture_ms']:.3f} ms beyond an eager step | {card}")
        say("profile", "replayed_step_bf16 " + json.dumps(b16r["profile"]))
        say("bf16", "in one fresh process, cuDNN's warnings that the bf16 RNN weights are "
            "compacted at every call: encode and gradient "
            f"{json.dumps(prof['rnn_compaction_warnings'])} (the witness casts them one by one)")
        bp = prof["bf16_profiles"]
        say("bf16", "in one fresh process, device ms (idle share) f32 vs bf16: a replayed VI "
            f"phase-1 step {bp['vi_f32']['device_ms']:.3f} ({bp['vi_f32']['idle_share']:.3f}) vs "
            f"{bp['vi_bf16']['device_ms']:.3f} ({bp['vi_bf16']['idle_share']:.3f}); a replayed "
            f"K={K_SUBJECTS} request {bp['request_f32']['device_ms']:.3f} "
            f"({bp['request_f32']['idle_share']:.3f}) vs {bp['request_bf16']['device_ms']:.3f} "
            f"({bp['request_bf16']['idle_share']:.3f}) | {card}")
        for name, window in bp.items():
            say("profile", f"bf16_phase_{name} " + json.dumps(window))
        say("profile", "replayed_epoch_bf16 " + json.dumps(b16r["epoch_profile"]))
        convs = conv_kernels(prof["kernel_names"])
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out", "bf16_kernel_names.json"), "w") as f:
            json.dump({"names": prof["kernel_names"], "conv": convs}, f, indent=1)
        say("bf16", f"convolution kernels of a replayed step (by name in the trace): f32 "
            f"{len(convs['f32'])}, bf16 {len(convs['bf16'])} of which {len(convs['bf16_marked'])} "
            f"name bf16, shared with f32 {len(convs['shared'])}; bf16 "
            f"{json.dumps([n[:90] for n in convs['bf16']])}")
        if not convs["bf16_marked"] or convs["shared"]:
            deferred.append(f"the bf16 step's convolution kernels are not bf16 ones: "
                            f"{json.dumps(convs)}")
        say("profile", "train_step_fresh " + json.dumps(eager["profile"]))
        say("profile", "replayed_step " + json.dumps(replay["profile"]))
        say("profile", "replayed_epoch " + json.dumps(replay["epoch_profile"]))
        # the kernels of the replayed paths, by name in the fresh process's
        # traces, each held to its graph's launches and to the counters
        epoch_steps = steps // TRAIN_EPOCHS
        traced = {"hensman_epoch": (epoch_steps, replay["epoch_kernels_by_name"],
                                    {"b_chain": epoch_steps, "chol_inv": 3 * epoch_steps}),
                  "serving_requests": (TRACED_REPLAYS, prof["serving"]["traced"]["requests"],
                                       {"b_chain": 0, "chol_inv": TRACED_REPLAYS}),
                  "serving_impute": (1, prof["serving"]["traced"]["impute"],
                                     {"b_chain": 0, "chol_inv": 0}),
                  "vi_phase1_epochs": (TRACED_REPLAYS, prof["vi"]["traced"]["phase1"],
                                       {"b_chain": TRACED_REPLAYS, "chol_inv": TRACED_REPLAYS}),
                  # the run's first step is the capture's warm-up
                  "vi_phase2_run": (VI_PROFILE_PRED_STEPS - 1, prof["vi"]["traced"]["phase2"],
                                    {"b_chain": 1, "chol_inv": 1}),
                  "bf16_hensman_epoch": (epoch_steps, prof["bf16"]["epoch_kernels_by_name"],
                                         {"b_chain": epoch_steps, "chol_inv": 3 * epoch_steps}),
                  "eval_validate_k1": (TRACED_REPLAYS, evprof["traced"]["validate_k1"],
                                       {"b_chain": TRACED_REPLAYS, "chol_inv": TRACED_REPLAYS,
                                        "block_pair": 0}),
                  "eval_validate_k4": (TRACED_REPLAYS, evprof["traced"]["validate_k4"],
                                       {"b_chain": 0, "chol_inv": 2 * TRACED_REPLAYS,
                                        "block_pair": TRACED_REPLAYS}),
                  "eval_gp_predict": (TRACED_REPLAYS, evprof["traced"]["gp_predict"],
                                      {"b_chain": 0, "chol_inv": TRACED_REPLAYS}),
                  "serving_fold": (1, prof["serving"]["traced"]["fold"],
                                   {"b_chain": 0, "chol_inv": 1})}
        for name, r in prof["standard"].items():
            traced[f"standard_{name.replace(', ', '_').replace(' ', '_')}"] = (
                STD_TRACED, r["traced"], r["want"])
        for path, (replays, got, want) in traced.items():
            say("launches", f"{path} ({replays} replayed): by kernel name in the trace "
                f"{json.dumps(got['traced'])}, on the counters {json.dumps(got['counted'])}")
            check_traced(got, want, path)
        sv = prof["serving"]
        say("serving", f"in one fresh process: aot_compile (fold and 4 captures) "
            f"{sv['aot_compile_ms']:.3f} ms; K={K_SUBJECTS} request replayed "
            f"{sv['replayed']['request_ms']:.3f} ms, eager {sv['eager']['request_ms']:.3f} ms "
            f"(host clock, median of 10); impute {BATCH * 1e3 / sv['replayed']['impute_ms']:.1f} "
            f"frames/s replayed, {BATCH * 1e3 / sv['eager']['impute_ms']:.1f} eager; fold "
            f"{sv['replayed']['fold_ms']:.3f} ms; captures {json.dumps(sv['captures'])}; the "
            f"trajectory graph records {json.dumps(sv['trajectory_replay_launches'])} | {card}")
        for name in ("replayed", "eager"):
            for what in ("request", "impute", "fold"):
                say("profile", f"serving_{what}_{name} " + json.dumps(sv[name][f"{what}_profile"]))
        fr, fe = sv["replayed"]["fold_profile"], sv["eager"]["fold_profile"]
        say("serving", f"in one fresh process, the basis fold (P={world.cfg.P} T={world.cfg.T}) "
            f"replayed vs eager: host clock {sv['replayed']['fold_ms']:.3f} vs "
            f"{sv['eager']['fold_ms']:.3f} ms, device {fr['device_ms']:.3f} vs "
            f"{fe['device_ms']:.3f} ms, idle {fr['idle_share']:.3f} vs {fe['idle_share']:.3f}, "
            f"host calls {fr['host_launches_per_call']:g} vs {fe['host_launches_per_call']:g} "
            f"| {card}")
        say("standard", f"the fresh process's standard runs took "
            f"{prof['standard_seconds']:.1f} s")
        for name, r in prof["standard"].items():
            rp, ep = r["replayed"]["profile"], r["eager"]["profile"]
            say("standard", f"in one fresh process, {name} step replayed vs eager: host clock "
                f"{r['replayed']['step_ms']:.3f} vs {r['eager']['step_ms']:.3f} ms, device "
                f"{rp['device_ms']:.3f} vs {ep['device_ms']:.3f} ms, idle "
                f"{rp['idle_share']:.3f} vs {ep['idle_share']:.3f}, host calls "
                f"{rp['host_launches_per_call']:g} vs {ep['host_launches_per_call']:g}; the "
                f"graph records {json.dumps(r['replay_launches'])} | {card}")
            slug = name.replace(", ", "_").replace(" ", "_")
            say("profile", f"standard_{slug}_replayed " + json.dumps(rp))
            say("profile", f"standard_{slug}_eager " + json.dumps(ep))
        vr = prof["vi"]
        say("vi", f"in one fresh process: phase-1 step replayed {vr['replayed']['step_ms']:.3f} "
            f"ms, eager {vr['eager']['step_ms']:.3f} ms (host clock); capture "
            f"{json.dumps(vr['capture'])}; the graph records {json.dumps(vr['replay_launches'])}; "
            f"fit {vr['fit_ms_an_epoch']:.3f} ms an epoch; phase 2 ({VI_PROFILE_PRED_STEPS} "
            f"steps with its operators and capture) replayed "
            f"{vr['phase2_replayed']['run_ms']:.3f} ms, eager {vr['phase2_eager']['run_ms']:.3f} "
            f"ms | {card}")
        for name in ("replayed", "eager"):
            say("profile", f"vi_step_{name} " + json.dumps(vr[name]["profile"]))
            say("profile", f"vi_phase2_{name} " + json.dumps(vr[f"phase2_{name}"]["profile"]))
        say("profile", "pipeline_epoch " + json.dumps(prof["pipeline_epoch"]))
        pre = prof["pretrain"]
        say("pipeline", f"pre-training epoch program ({pre['steps']} steps of 256 frames, one "
            f"captured step) warm epoch {pre['epoch_ms']:.3f} ms; card vs CPU first epoch "
            f"{json.dumps(pre['card_vs_cpu'])} | {card}")
        say("profile", "pretrain_epoch " + json.dumps(pre["profile"]))
        with eager_steps():  # the replayed validation's trace is the fresh process's
            say("profile", "pipeline_validation " + json.dumps(
                profile_window(lambda: pipe_validate(card_pipe), 2)))
        evp = evprof["profiles"]
        say("eval", f"the fresh process of the evaluation traces took {eval_fresh_s:.1f} s, "
            f"of which {json.dumps({k: round(v, 1) for k, v in evprof['seconds'].items()})}")
        for name, window in evp.items():
            say("profile", f"eval_{name} " + json.dumps(window))
        for cohort in eval_cohorts(card_pipe):
            for type_kl, route, _ in EVAL_MODES:
                name = f"validate_{cohort}_{type_kl}_{route}"
                r, e = evp[f"{name}_replayed"], evp[f"{name}_eager"]
                say("eval", f"in one fresh process, {name} replayed vs eager: wall "
                    f"{r['wall_ms']:.3f} vs {e['wall_ms']:.3f} ms, device {r['device_ms']:.3f} vs "
                    f"{e['device_ms']:.3f} ms, idle {r['idle_share']:.3f} vs "
                    f"{e['idle_share']:.3f}, host calls {r['host_launches_per_call']:g} vs "
                    f"{e['host_launches_per_call']:g}, copies {json.dumps(r['copies'])} | {card}")
                to_host = sum(v for k, v in r["copies"].items() if k.startswith("Memcpy DtoH"))
                pageable = [k for k in r["copies"] if "Pageable" in k]
                if to_host != 1 or pageable:
                    deferred.append(f"{name}: a replayed validation copied {json.dumps(r['copies'])}"
                                    ", not one read to the host and no pageable copy")
        for name in ("encode_2000", "decode_2000", "recon_mse", "gp_predict"):
            r, e = evp[f"{name}_replayed"], evp[f"{name}_eager"]
            say("eval", f"in one fresh process, {name} replayed vs eager: wall "
                f"{r['wall_ms']:.3f} vs {e['wall_ms']:.3f} ms, device {r['device_ms']:.3f} vs "
                f"{e['device_ms']:.3f} ms, idle {r['idle_share']:.3f} vs {e['idle_share']:.3f}, "
                f"host calls {r['host_launches_per_call']:g} vs "
                f"{e['host_launches_per_call']:g} | {card}")
        x = evp["exact_full"]
        say("eval", f"in one fresh process, mse_test_exact at the {EXACT_CAP}-row cap: wall "
            f"{x['wall_ms']:.3f} ms, device {x['device_ms']:.3f} ms, idle {x['idle_share']:.3f}, "
            f"host calls {x['host_launches_per_call']:g} | {card}")

        # phase 8: the VI regime through lvae_torch.cli.main; counts from 0 just before it
        vi = run_vi(world, PIPE_DIR, pipe_run)
        say("vi", f"CLI run: {VI_EPOCHS} phase-1 epochs (P={world.cfg.P} x T={world.cfg.T}), "
            f"1000 phase-2 steps ({vi['n_pred']} rows), generation in {vi['seconds']:.3f} s, "
            f"resumed run ({VI_RESUME_EPOCHS} epochs) {vi['resume_seconds']:.3f} s | {card}; "
            f"launches {json.dumps(vi['counts'])}; a phase-1 step "
            f"{json.dumps(vi['counter'].steps[0])}, phase 2 "
            f"{json.dumps(vi['counter'].predictions[0])}; last epoch {json.dumps(vi['losses'])}")
        t0 = time.perf_counter()
        vi_card = vi_replay(world, PIPE_DIR, pipe_run, vi, "cuda")
        vi_cpu = vi_replay(world, PIPE_DIR, pipe_run, vi, "cpu")
        vi_errs = compare_vi(vi_card, vi_cpu)
        say("compare", f"VI card vs CPU from model_vi.ckpt ({VI_COMPARE_STEPS} phase-1 and "
            f"{VI_COMPARE_PRED_STEPS} phase-2 steps, one noise): {json.dumps(vi_errs)} "
            f"(tolerances {json.dumps(LOSS_TOLS)}, mu/log_var/mu_pred {VARIATIONAL_RTOL}; "
            f"{time.perf_counter() - t0:.1f} s | {card})")
        t0 = time.perf_counter()
        v_gve = vi_graph_vs_eager(PIPE_DIR, pipe_run, vi)
        vt = v_gve["times"]
        say("compare", f"VI graph vs eager on the card from model_vi.ckpt (cuDNN deterministic, "
            f"held bit-equal): phase 1 ({VI_GVE_EPOCHS} epochs) {json.dumps(v_gve['phase1'])}; "
            f"resume through the state setter {json.dumps(v_gve['resume'])}; phase 2 "
            f"({VI_PRED_STEPS} steps) {json.dumps(v_gve['phase2'])} "
            f"({time.perf_counter() - t0:.1f} s | {card})")
        say("vi", f"phase 1 counters per step {json.dumps(v_gve['per_step'])}, recorded per "
            f"replay {json.dumps(v_gve['per_replay'])}; host clock {VI_GVE_EPOCHS} epochs "
            f"replayed {vt['phase1_graph_ms']:.3f} ms (capture included), eager "
            f"{vt['phase1_eager_ms']:.3f} ms; phase 2 {VI_PRED_STEPS} steps replayed "
            f"{vt['phase2_graph_ms']:.3f} ms, eager {vt['phase2_eager_ms']:.3f} ms | {card}")
        vi_warm = vi_step_times(vi["trainer"])
        say("vi", f"phase-1 step (host clock, warm) median {vi_warm['host_ms']:.3f} ms over 3 "
            f"(N={world.cfg.P * world.cfg.T} rows, L={world.cfg.latent_dim}) | {card}")
        say("profile", f"vi_step {json.dumps(vi_warm['profile'])} | {card}")

        # the CLI with bf16 VAE compute; counts from 0 just before it
        reset_launch_counts()
        b16_cli = run_pipeline_bf16(world, PIPE_DIR, pipe_run)
        bf16_counts = launch_counts()
        say("bf16", f"CLI --model_dtype=bfloat16: {BF16_CLI_EPOCHS} epochs with validation, "
            f"tests and generation in {b16_cli['seconds']:.3f} s, resumed for 1 epoch "
            f"{b16_cli['resume_seconds']:.3f} s (to step {b16_cli['resumed_step']}); last epoch "
            f"{json.dumps(b16_cli['losses'])}; test MSEs {json.dumps(b16_cli['test_mse'])}; "
            f"launches {json.dumps(bf16_counts)} | {card}")

        # the CLI on a mesh of 2 ranks sharing the card, through torchrun
        par_cli = run_parallel_cli(world, pipe_run)
        say("parallel", f"torchrun --nproc_per_node=2 -m lvae_torch.cli --data_mesh=2: "
            f"{PAR_CLI_EPOCHS} epochs, validation and tests in {par_cli['seconds']:.3f} s "
            f"(the ranks' groups at {par_cli['to_groups_s']:.1f} s, the first epoch's line at "
            f"{par_cli['to_first_epoch_s']} s); groups {par_cli['groups']}; last epoch "
            f"{json.dumps(par_cli['losses'])}; test MSEs {json.dumps(par_cli['test_mse'])} "
            f"| {card}")
    finally:
        shutil.rmtree(PIPE_DIR, ignore_errors=True)

    # phase 9: the RNN encoder, Hensman steps and serving; counts from 0 just before it
    reset_launch_counts()
    rnn = {cell: run_rnn(world, cell) for cell in RNN_CELLS}
    rnn_counts = launch_counts()
    for cell, r in rnn.items():
        say("rnn", f"{cell} (hidden {world.cfg.hidden_dim}, T={world.cfg.T}): {RNN_EPOCHS} "
            f"epoch(s), per step (K1, K2) {r['card']['per_step']}; request K={K_SUBJECTS} "
            f"host ms {[round(t, 3) for t in r['served']['request_ms']]} (K2 {r['served']['fold_launches']} "
            f"in the fold, {r['served']['request_launches']} a request) | {card}")
        say("compare", f"RNN {cell} card vs CPU {json.dumps(r['errs'])} (tolerances "
            f"{json.dumps(LOSS_TOLS)}, m/H {VARIATIONAL_RTOL}, frames {FRAME_ATOL})")
    say("rnn", f"launches {json.dumps(rnn_counts)}")
    warm = hensman_step_times(rnn["lstm"]["card"]["trainer"])
    say("rnn", f"lstm Hensman step (host clock, warm) median {warm['host_ms']:.3f} ms over 5 "
        f"| {card}")
    say("profile", f"rnn_train_step {json.dumps(warm['profile'])} | {card}")
    say("rnn", "cuDNN TF32 switch, encoder gradients rel (the script keeps it off): "
        f"{json.dumps(tf32_gradient_effect(world))} | {card}")

    # phase 10: bf16 VAE compute (model_dtype=bfloat16) through training,
    # serving, VI and the RNN encoder; counts from 0 just before it, the f32
    # runs it times or compares against left out (uncounted)
    reset_launch_counts()
    t_b16 = time.perf_counter()
    b16_parts, mark = {"cli": bf16_counts}, launch_counts()

    def part(name: str) -> None:  # the K1 and K2 launches of one bf16 part
        nonlocal mark
        now = launch_counts()
        b16_parts[name] = {k: now[k] - mark[k] for k in now}
        mark = now

    b16 = {"hensman": bf16_hensman(world, card_c)}
    part("hensman")
    h = b16["hensman"]
    say("bf16", f"Hensman, 10 replayed steps from H+{H_SHIFT}I (K1, K2 a step "
        f"{h['card']['per_step'][0]}): card {h['seconds']['card']:.1f} s, CPU "
        f"{h['seconds']['cpu']:.1f} s; card vs CPU {json.dumps(h['errs'])} (losses <= "
        f"{BF16_LOSS_RTOL}, m/H <= {BF16_VARIATIONAL_RTOL}); card bf16 vs card f32 (not held) "
        f"{json.dumps(h['vs_f32'])}; replayed vs eager (cuDNN deterministic) entries that differ "
        f"{sum(v['differ'] for k, v in h['graph_vs_eager'].items() if k != 'first_difference')}")
    for e, (a, b) in enumerate(zip(h["card"]["epochs"], card_c["epochs"])):
        say("bf16", f"epoch {e + 1}: bf16 {json.dumps(a)} f32 {json.dumps(b)}")
    t0 = time.perf_counter()
    b16["serving"] = sv = bf16_serving(world)
    part("serving")
    t = sv["times"]
    say("bf16", f"serving card vs CPU {json.dumps(sv['errs'])} (latents <= {BF16_LATENT_RTOL} "
        f"rel, frames <= {BF16_FRAME_ATOL} abs); replayed K={K_SUBJECTS} request f32 "
        f"{t['f32']['request_ms']:.3f} ms vs bf16 {t['bf16']['request_ms']:.3f} ms; impute "
        f"{BATCH * 1e3 / t['f32']['impute_ms']:.1f} vs {BATCH * 1e3 / t['bf16']['impute_ms']:.1f} "
        f"frames/s; replayed vs eager (cuDNN deterministic) entries that differ "
        f"{sum(d['differ'] for d in sv['graph_vs_eager'].values())} "
        f"({time.perf_counter() - t0:.1f} s | {card})")
    t0 = time.perf_counter()
    b16["vi"] = v = bf16_vi(world)
    part("vi")
    say("bf16", f"VI phase-1 step card vs CPU {json.dumps(v['errs'])} (<= {BF16_LOSS_RTOL}); "
        f"replayed step f32 {v['step_ms']['f32']:.3f} ms vs bf16 {v['step_ms']['bf16']:.3f} ms; "
        f"the graph records {json.dumps(v['replay_launches'])}; 3 replayed vs 3 eager steps "
        f"(cuDNN deterministic) {json.dumps(v['graph_vs_eager'])} "
        f"({time.perf_counter() - t0:.1f} s | {card})")
    t0 = time.perf_counter()
    b16["rnn"] = r = bf16_rnn(world)
    part("rnn")
    say("bf16", f"LSTM bf16, one Hensman epoch and a K={K_SUBJECTS} request, card vs CPU "
        f"{json.dumps(r['errs'])} (losses, m/H <= {BF16_LOSS_RTOL}, frames <= "
        f"{BF16_FRAME_ATOL}); request host ms {[round(x, 3) for x in r['request_ms']]} "
        f"({time.perf_counter() - t0:.1f} s | {card})")
    t0 = time.perf_counter()
    b16["table"] = tb = bf16_table(world)
    part("table")
    say("bf16", f"bf16 frame table (LVAE_TABLE_BF16=1) vs f32 table under the bf16 model: first "
        f"step net {tb['bf16_table']['net']:.6f} vs {tb['f32_table']['net']:.6f} (rel "
        f"{tb['net_rel']:.3e} <= {BF16_LOSS_RTOL}); replayed step "
        f"{tb['bf16_table']['host_ms']:.3f} vs {tb['f32_table']['host_ms']:.3f} ms ({time.perf_counter() - t0:.1f} s | {card})")
    t0 = time.perf_counter()
    b16["scale"] = sc = bf16_scale(world)
    part("scale")
    say("bf16", f"P={BF16_SCALE_P}: a replayed Hensman epoch ({sc['steps']} steps of "
        f"{world.cfg.subjects_per_batch} subjects) f32 {sc['epoch_ms']['f32']:.3f} ms vs bf16 "
        f"{sc['epoch_ms']['bf16']:.3f} ms (medians of 3 in turns {json.dumps(sc['all_ms'])}) "
        f"({time.perf_counter() - t0:.1f} s | {card})")
    bf16_counts = {k: bf16_counts[k] + v for k, v in launch_counts().items()}
    say("bf16", f"phase {time.perf_counter() - t_b16:.1f} s; launches of the bf16 runs (with "
        f"the CLI run; the f32 runs beside them not counted) {json.dumps(bf16_counts)}; K1, K2 "
        f"by part {json.dumps({k: [v['b_chain'], v['chol_inv']] for k, v in b16_parts.items()})}")
    for kernel in ("b_chain", "chol_inv"):
        if bf16_counts[kernel] < 1:
            raise AssertionError(f"{kernel} was not launched on the bf16 paths")

    # the RNN encoder's replayed step, each cell in f32 and in bf16; counts
    # from 0 just before it
    reset_launch_counts()
    t0 = time.perf_counter()
    rnn_rep = rnn_replayed_steps(world)
    rnn_rep_counts = launch_counts()
    say("rnn", f"replayed Hensman step (host clock, warm, median of 5) "
        f"{json.dumps({k: round(v['replayed_ms'], 3) for k, v in rnn_rep.items()})} ms; one "
        f"epoch replayed vs eager (cuDNN deterministic) entries that differ "
        f"{json.dumps({k: v['graph_vs_eager_differ'] for k, v in rnn_rep.items()})}; launches "
        f"{json.dumps(rnn_rep_counts)} ({time.perf_counter() - t0:.1f} s | {card})")

    # phase 11: subject- and latent-parallel training and serving, 2 gloo
    # ranks sharing the card at each mesh; each rank sets its counts to 0
    # just before its Hensman epochs and reads them just after. One process
    # on the card first: the f64 pair of the sharded runs, and the f32 run
    # with each batch's subject sums taken in another order
    served_ref = gpu["pred"].predict_latent_trajectory(*request_of(world))
    closed_ref = std_runs["closed"]["epochs"][:STD_EPOCHS]
    t0 = time.perf_counter()
    card_64 = train(world, "cuda", H_SHIFT, dtype=torch.float64)
    roll_errs = {}
    for name, base, dtype in (("f32", card_c, torch.float32), ("f64", card_64, torch.float64)):
        rolled = train(world, "cuda", H_SHIFT, dtype=dtype, roll=True)
        roll_errs[name] = compare_losses(rolled["steps"], base["steps"],
                                         keys=("net", "kld", "recon"))
        roll_errs[name] |= compare_variational(rolled, base)
    say("compare", f"one process on the card, each batch's subjects rolled by half a batch vs "
        f"in order (the same loss, its subject sums in another order; not held): "
        f"{json.dumps(roll_errs)}; K0zz's condition number at the start "
        f"{json.dumps(k0zz_condition(world))} ({time.perf_counter() - t0:.1f} s | {card})")
    b16_single = train(world, "cuda", H_SHIFT, compute=BF16, epochs=BF16_PAR_EPOCHS)
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    par_counts = {k: 0 for k in launch_counts()}
    try:
        t0 = time.perf_counter()
        meshes = run_ranks(2, par_meshes, (args.seed, time.time()), "meshes")
        say("parallel", f"2 gloo ranks on cuda:0 ran meshes {list(PAR_SHAPES)} in "
            f"{time.perf_counter() - t0:.1f} s: spawn to group "
            f"{[round(r['start_s'], 1) for r in meshes]} s a rank, then seconds a part "
            f"{json.dumps({str(sh): [{k: round(v, 1) for k, v in r['meshes'][sh]['seconds'].items()} for r in meshes] for sh in PAR_SHAPES})}")
        for shape in PAR_SHAPES:
            ranks = [r["meshes"][shape] | {"backend": r["backend"]} for r in meshes]
            check_par_launches(world, shape, ranks)
            errs = check_parallel(shape, ranks, card_c, card_64, served_ref, closed_ref)
            for r in ranks:  # each count set to 0 just before its run in the rank
                runs = [r["launches"], r["serve"]["launches"]]
                runs += [r["closed_launches"]["launches"]] if "closed" in r else []
                runs += [r["bf16"]["launches"]] if "bf16" in r else []
                for counts in runs:
                    for k, v in counts.items():
                        par_counts[k] += v
            r0 = ranks[0]
            say("parallel", f"mesh (data, latent) = {shape}, 2 gloo ranks on cuda:0: "
                f"{len(r0['steps'])} Hensman steps each; launches a rank "
                f"{json.dumps([r['launches'] for r in ranks])}; kernel shapes "
                f"{json.dumps(r0['shapes'])}; serving K2 {json.dumps(r0['serve']['shapes'])}"
                + (f"; closed K3 {json.dumps(r0['closed_launches']['shapes'])}"
                   if "closed" in r0 else "") + f" | {card}")
            say("compare", f"parallel {shape} vs one process on the card: {json.dumps(errs)} "
                f"(tolerances {json.dumps(LOSS_TOLS)}, m/H {VARIATIONAL_RTOL}, served latents "
                f"{LATENT_RTOL}, f64 {PAR_F64_RTOL})")
            if shape == BF16_PAR_SHAPE:
                b16_errs = {}
                for rank, r in enumerate(ranks):
                    steps_ = r["bf16"]["per_step"]
                    if any(x["b_chain"] != 1 or x["chol_inv"] != 3 for x in steps_):
                        raise AssertionError(f"a sharded bf16 step launched {steps_}")
                    b16_errs[f"rank{rank}"] = {
                        "steps": compare_losses(r["bf16"]["steps"], b16_single["steps"],
                                                keys=("net", "kld", "recon")),
                        "end_state": compare_variational(r["bf16"], b16_single)}
                check_below(b16_errs, BF16_LOSS_RTOL, f"sharded bf16 {shape} vs one process")
                say("compare", f"parallel {shape}, bf16 VAE, {len(ranks[0]['bf16']['steps'])} "
                    f"steps vs one process on the card: {json.dumps(b16_errs)} (<= "
                    f"{BF16_LOSS_RTOL}); launches a rank "
                    f"{json.dumps([r['bf16']['launches'] for r in ranks])} | {card}")
            coll = [r["timing"]["profile"]["collectives"] for r in ranks]
            say("parallel", f"mesh {shape}: step host median "
                f"{[round(r['timing']['host_ms'], 3) for r in ranks]} ms a rank (one process "
                f"{warm_single['host_ms']:.3f} ms); device "
                f"{[round(r['timing']['profile']['device_ms'], 3) for r in ranks]} ms a step, "
                f"collectives host {[round(c['host_ms'], 3) for c in coll]} ms and device "
                f"{[round(c['device_ms'], 3) for c in coll]} ms a step ({coll[0]['ops']}); "
                f"serving request {[round(r['serve']['ms'], 3) for r in ranks]} ms | {card}")
        for kernel in ("b_chain", "chol_inv", "kernel_matrix"):
            if par_counts[kernel] < 1:
                raise AssertionError(f"{kernel} was not launched on the parallel paths")
        t0 = time.perf_counter()
        nccl = nccl_world_of_one(args.seed)
        if nccl["backend"] != "nccl":
            raise AssertionError(f"the world of one rank ran on {nccl['backend']}, not nccl")
        n_errs = compare_losses([nccl["epoch"]], card_c["epochs"][:1])
        say("parallel", f"world of 1 on NCCL ({nccl['group']}), trivial mesh: epoch 1 "
            f"{json.dumps(nccl['epoch'])}; vs one process {json.dumps(n_errs)} "
            f"({time.perf_counter() - t0:.1f} s | {card})")
        check_within({"nccl": n_errs})
    finally:
        shutil.rmtree(PAR_DIR, ignore_errors=True)

    # phase 12: the kernels line
    say("done", f"every phase in {time.perf_counter() - started:.1f} s | {card}")
    if deferred:
        raise AssertionError("; ".join(deferred))
    paths = {"serving": serve_counts, "training": train_launches, "standard": std_counts,
             "pipeline": pipe_run["counts"], "pipeline_k4": k4_run["counts"], "eval": eval_counts,
             "vi": vi["counts"], "rnn": rnn_counts, "bf16": bf16_counts,
             "rnn_replayed": rnn_rep_counts, "parallel": par_counts}
    for e, key in ((entry, "chol_inv"), (k1_entry, "b_chain"), (k3_entry, "kernel_matrix"),
                   (k4_entry, "block_pair"), (k5_entry, "adam")):
        e["launches_by_path"] = {path: counts[key] for path, counts in paths.items()}
        e["launches"] = sum(e["launches_by_path"].values())
    entry["launches_by_step"] = gpu["launches"]
    for e, key in ((entry, "chol_inv"), (k1_entry, "b_chain"), (k3_entry, "kernel_matrix"),
                   (k4_entry, "block_pair"), (k5_entry, "adam")):
        e["launches_traced"] = {path: {"replays": replays, "traced": got["traced"][key]}
                                for path, (replays, got, _) in traced.items()
                                if key in got["traced"]}
    print(json.dumps({"kernels": [entry, k1_entry, k3_entry, k4_entry, k5_entry]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        print(f"chip_smoke: failed after the line {last_said[0]!r}", file=sys.stderr)
        sys.exit(1)

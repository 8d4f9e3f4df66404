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
  ``predict_latent_trajectory`` and ``refresh_basis``;
* Hensman training with natural gradients, through ``HensmanTrainer``: two
  epochs of 5 steps (20 subjects, 400 frames a step);
* standard full-batch training, through ``StandardTrainer`` with
  ``hensman=False``: 5 epochs of ``type_KL=closed`` (one step each over all
  N = 2000 frames, K3 building the ``[32, 2000, 2000]`` prior once a step),
  2 each of ``GPapprox_closed``, ``GPapprox`` and the five-phase GPPVAE
  regime, and 2 closed epochs with the fused optimizer (K5 once a step);
* the reference-format CLI, through ``lvae_torch.cli.main`` on data from
  the port's generator: 2 pre-training epochs, 4 epochs with validation,
  tests, generation and checkpoints, a resumed run, and 2 epochs on the K4
  route (K1 off, the block-pair switch on), with the kernels each step and
  each validation launched checked on both routes; the run's reference GP
  files (``gp_model.pth``, ``zt_list.pth``, ``m.pth``, ``H.pth``) written
  again and read back;
* the VI regime through ``lvae_torch.cli.main`` with
  ``--variational_inference_training=True`` on the same data and
  pre-trained VAE: 3 phase-1 epochs over the whole cohort (K1 once and K2
  at least once a step, checked), 1000 phase-2 steps on the test split (K1
  and K2 once), generation, and a run resumed from ``model_vi.ckpt``;
* the RNN encoder (``type_nnet=rnn``, hidden 64) with each cell, LSTM and
  GRU: one Hensman epoch (5 steps, launches checked) and one K-subject
  request of whole 20-frame sequences through ``LVAEPredictor``.

Each path is replayed with ``device="cpu"`` (the plain versions) and the
card's answers are held against the CPU's; the standard regime at P=26
subjects (N = 520, still at K3's gate), since an N = 2000 replay is about a
TFLOP of f32 Cholesky work a step on the CPU; the CLI run's final
checkpoint through ``validate`` and ``mse_test_gp_approx``; VI from
``model_vi.ckpt`` (3 phase-1 and 4 phase-2 steps, one noise); the RNN runs
from H + 0.1·I with cuDNN's TF32 off. One ``batch_loss`` from the CLI
run's final checkpoint is held on the K4 route against the K1 route.

Phases print one line each. Any failure raises and exits non-zero; without
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
import copy
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

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from lvae_torch import cli  # noqa: E402
from lvae_torch import pipeline as pipeline_mod  # noqa: E402
from lvae_torch.config import load_flag_file, parse_flag_lines  # noqa: E402
from lvae_torch.data.blocks import build_subject_blocks  # noqa: E402
from lvae_torch.data.healthmnist import generate_healthmnist  # noqa: E402
from lvae_torch.evaluation.encode import encode_dataset  # noqa: E402
from lvae_torch.evaluation.testing import mse_test_gp_approx  # noqa: E402
from lvae_torch.inference import LVAEPredictor  # noqa: E402
from lvae_torch.kernels_cuda import adam as k5  # noqa: E402
from lvae_torch.kernels_cuda import b_chain as k1  # noqa: E402
from lvae_torch.kernels_cuda import block_pair as k4  # noqa: E402
from lvae_torch.kernels_cuda import build  # noqa: E402
from lvae_torch.kernels_cuda import chol_plan as cp  # noqa: E402
from lvae_torch.kernels_cuda import cholesky as k2  # noqa: E402
from lvae_torch.kernels_cuda import kernel_matrix as k3  # noqa: E402
from lvae_torch.kernels_cuda import km_plan  # noqa: E402
from lvae_torch.models.vae import make_vae  # noqa: E402
from lvae_torch.ops import kernels as kx  # noqa: E402
from lvae_torch.ops import linalg as la  # noqa: E402
from lvae_torch.train.hensman import HensmanConfig, HensmanTrainer  # noqa: E402
from lvae_torch.train.hensman import batch_loss as hensman_batch_loss  # noqa: E402
from lvae_torch.train.standard import StandardConfig, StandardTrainer  # noqa: E402
from lvae_torch.train.state import (  # noqa: E402
    init_gp_params, init_inducing_points, make_optimizer,
)
from lvae_torch.train.vi import VITrainer  # noqa: E402
from lvae_torch.utils.checkpoint import read_checkpoint  # noqa: E402
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


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


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

    def model(self):
        """A fresh ConvVAE with the seed's random weights, on the CPU."""
        cfg = self.cfg
        return make_vae(
            cfg.type_nnet, cfg.latent_dim, cfg.num_dim, vy_init=cfg.vy_init,
            dropout=cfg.dropout, dropout_input=cfg.dropout_input,
            generator=torch.Generator().manual_seed(self.seed),
        )

    def rnn_model(self, cell: str):
        """A fresh RNN encoder model (``type_nnet=rnn``, hidden 64, the
        config default) with the seed's random weights, on the CPU."""
        cfg = self.cfg
        return make_vae("rnn", cfg.latent_dim, cfg.num_dim, vy_init=cfg.vy_init, T=cfg.T,
                        hidden_dim=cfg.hidden_dim, type_rnn=cell,
                        generator=torch.Generator().manual_seed(self.seed))

    def trainer(self, device: str, model=None) -> HensmanTrainer:
        """A Hensman trainer at the config file's settings, on ``device``,
        for ``model`` (the ConvVAE by default); every trainer made here for
        one model kind starts from the same state."""
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
            seed=self.seed, t_buckets=cfg.T_buckets, device=device,
        )

    def standard_trainer(self, device: str, type_kl: str = "closed",
                         pseudo_minibatch: bool = False, optimizer: str = "adam",
                         subjects=None) -> StandardTrainer:
        """A full-batch trainer (``hensman=False``) at the config file's
        settings on the first ``subjects`` subjects (all by default), on
        ``device``; every trainer made here starts from the same state."""
        cfg = self.cfg
        p = subjects or cfg.P
        n = p * cfg.T
        scfg = StandardConfig(
            spec0=self.spec0, spec1=self.spec1, latent_dim=cfg.latent_dim, P_tot=p, T=cfg.T,
            weight=cfg.weight, loss_function=cfg.loss_function, type_KL=type_kl,
            num_samples=cfg.num_samples, constrain_scales=cfg.constrain_scales, eps=cfg.eps,
            dropout=cfg.dropout > 0, vy_fixed=cfg.vy_fixed,
        )

        class Cohort:
            data, labels, mask = self.frames[:n], self.labels[:n], self.pixmask[:n]

        trainer = StandardTrainer(
            self.model(), scfg, Cohort, build_subject_blocks(Cohort.labels, cfg.id_covariate),
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
    }


# ---------------------------------------------------------------- training
def train(world: World, device: str, h_shift: float = 0.0, cell=None,
          epochs: int = TRAIN_EPOCHS) -> dict:
    """``epochs`` Hensman epochs on ``device`` (the ConvVAE, or the RNN
    encoder with ``cell``), from the trainer's initial state with
    ``h_shift``·I added to H; returns the per-epoch and per-step metrics,
    the final (m_nat, H_nat), the kernels launched in each step, whether
    each step's natural-gradient update was applied (the PSD-cone guard
    keeps the old (m, H) otherwise) and the trainer."""
    trainer = world.trainer(device, world.rnn_model(cell) if cell else None)
    if h_shift:
        h = trainer.state.H_nat
        trainer.state = trainer.state._replace(
            H_nat=h + h_shift * torch.eye(h.shape[-1], dtype=h.dtype, device=h.device))
    per_step, step_metrics, applied = [], [], []
    real_step = trainer.train_step

    def counted_step(table, rows, eps=None):
        b1, b2 = k1.b_chain.launches, k2.cholesky_inverse.launches
        m_before = trainer.state.m_nat
        out = real_step(table, rows, eps)
        per_step.append((k1.b_chain.launches - b1, k2.cholesky_inverse.launches - b2))
        step_metrics.append(out)
        applied.append(trainer.state.m_nat is not m_before and not torch.equal(
            trainer.state.m_nat, m_before))
        return out

    trainer.train_step = counted_step
    metrics = [trainer.run_epoch() for _ in range(epochs)]
    trainer.train_step = real_step
    return {
        "epochs": [m._asdict() for m in metrics],
        "steps": [{k: float(v) for k, v in m._asdict().items()} for m in step_metrics],
        "m_nat": trainer.state.m_nat.detach().cpu().double().numpy(),
        "H_nat": trainer.state.H_nat.detach().cpu().double().numpy(),
        "per_step": per_step,
        "ng_applied": applied,
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


def reset_launch_counts() -> None:
    k1.b_chain.launches = 0
    k2.cholesky_inverse.launches = 0
    k3.kernel_matrix_fused.launches = 0
    k5.fused_adam_update.launches = 0
    k4.block_pair.launches = 0


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
    """Every standard run of STANDARD_RUNS at full width on the card."""
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
    """While active: the kernel launches of every Hensman ``train_step`` and
    every pipeline ``validate`` call, and the pipeline ``cli.main`` ran."""

    def __enter__(self):
        self.steps, self.validations, self.pipeline = [], [], None
        self._saved = (HensmanTrainer.train_step, pipeline_mod.validate,
                       pipeline_mod.LVAEPipeline.run)
        step, validate, run = self._saved
        counter = self

        def keep_run(pipe):
            counter.pipeline = pipe
            return run(pipe)

        HensmanTrainer.train_step = counted(step, self.steps)
        pipeline_mod.validate = counted(validate, self.validations)
        pipeline_mod.LVAEPipeline.run = keep_run
        return self

    def __exit__(self, *exc):
        (HensmanTrainer.train_step, pipeline_mod.validate,
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


def check_pipeline_run(results: str, epochs: int, hw: int) -> dict:
    """Every artefact present; losses, test MSEs and grids finite."""
    missing = [a for a in PIPE_ARTEFACTS if not os.path.exists(os.path.join(results, a))]
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


# ---------------------------------------------------------------------- VI
VI_EPOCHS = 3  # phase-1 steps of the CLI run (one an epoch, the whole cohort)
VI_RESUME_EPOCHS = 2
VI_COMPARE_STEPS = 3  # phase-1 steps replayed on the card and the CPU from model_vi.ckpt
VI_COMPARE_PRED_STEPS = 4  # phase-2 steps replayed likewise (the CLI run takes 1000)


class VICounter:
    """While active: the kernel launches of every ``VITrainer.train_step``
    and of each phase 2 (``optimize_prediction_set``), and the trainer."""

    def __enter__(self):
        self.steps, self.predictions, self.trainer = [], [], None
        self._saved = (VITrainer.train_step, VITrainer.optimize_prediction_set)
        step, pred = self._saved
        counter = self

        def keep(trainer, *args, **kwargs):
            counter.trainer = trainer
            return step(trainer, *args, **kwargs)

        VITrainer.train_step = counted(keep, self.steps)
        VITrainer.optimize_prediction_set = counted(pred, self.predictions)
        return self

    def __exit__(self, *exc):
        VITrainer.train_step, VITrainer.optimize_prediction_set = self._saved
        return False

    def check(self, n_steps: int, n_predictions: int, where: str) -> None:
        """``n_steps`` phase-1 steps, each K1 once and K2 at least once;
        ``n_predictions`` phase-2 runs, each K1 and K2 once (its operators
        are built once, its steps launch neither)."""
        if len(self.steps) != n_steps or len(self.predictions) != n_predictions:
            raise AssertionError(f"{where}: {len(self.steps)} steps and {len(self.predictions)} "
                                 f"phase-2 runs, expected {n_steps} and {n_predictions}")
        for got in self.steps:
            if got["b_chain"] != 1 or got["chol_inv"] < 1:
                raise AssertionError(f"{where}: a phase-1 step launched {json.dumps(got)}, "
                                     "expected K1 once and K2 at least once")
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


def vi_replay(world: World, root: str, run: dict, vi: dict, device: str) -> dict:
    """From ``model_vi.ckpt`` on ``device``: VI_COMPARE_STEPS phase-1 steps
    and VI_COMPARE_PRED_STEPS phase-2 steps with noise from one seeded CPU
    generator; returns the losses and the final moments."""
    cfg, _ = parse_flag_lines(vi_flags(run, os.path.join(root, f"vi_replay_{device}"),
                                       f"--gp_model_folder={vi['results']}"))
    pipe = pipeline_mod.LVAEPipeline(cfg, device=device)
    trainer = pipe.build_vi_trainer()
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

    for _ in reps(N_FOLDS):
        bundle = step("fold", lambda: pred.aot_compile(
            batch_size=BATCH, t_obs=T_OBS, n_query=N_QUERY, k_subjects=K_SUBJECTS))
    out["basis_c"] = bundle._basis.c.cpu().numpy()
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
    return {"out": out, "launches": launches, "times": times, "pred": pred, "bundle": bundle}


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


def profile_window(fn, reps: int) -> dict:
    """Device time per call of ``fn`` from a ``torch.profiler`` trace of
    ``reps`` warm calls: wall ms (host clock, ending in a synchronise), the
    sum of device-kernel ms, the device's idle share of the wall time, the
    kernels launched per call, and the five kernels that take most time."""
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
    rows = [
        (e.self_device_time_total, e.count, e.key)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation
    ]
    busy_us = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    return {
        "wall_ms": wall * 1e3 / reps,
        "device_ms": busy_us / 1e3 / reps,
        "idle_share": 1.0 - busy_us / 1e6 / wall,
        "kernels_per_call": sum(r[1] for r in rows) / reps,
        "top": [{"kernel": key[:70], "ms": us / 1e3 / reps, "per_call": n / reps}
                for us, n, key in rows[:5]],
    }


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

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
    say("serving", f"fold (aot_compile) cold {t['fold'][0]:.3f} ms, warm median "
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

    # the same calls on the CPU, through the plain versions
    before = k2.cholesky_inverse.launches
    cpu = serve(world, "cpu")
    if k2.cholesky_inverse.launches != before:
        raise AssertionError("the CPU run launched the CUDA kernel")
    check_outputs(cpu["out"], world)
    errs = compare(gpu["out"], cpu["out"])
    say("compare", f"card vs CPU {json.dumps(errs)} (latents rel <= {LATENT_RTOL}, "
        f"frames abs <= {FRAME_ATOL})")

    # where the device time goes, warm, after the main path's counts were read
    pred, bundle = gpu["pred"], gpu["bundle"]
    prof = {
        "fold": profile_window(lambda: pred.aot_compile(
            batch_size=BATCH, t_obs=T_OBS, n_query=N_QUERY, k_subjects=K_SUBJECTS), 3),
        "predict_trajectories": profile_window(lambda: bundle.predict_trajectories(
            world.obs_frames, world.obs_labels, world.query_labels), N_REQUESTS),
    }
    for name, row in prof.items():
        say("profile", f"{name} {json.dumps(row)}")

    # phase 5: the Hensman training path on the card; counts from 0 just before it
    reset_launch_counts()
    t0 = time.perf_counter()
    card_run = train(world, "cuda")
    train_s = time.perf_counter() - t0
    train_launches = launch_counts()
    steps = len(card_run["per_step"])
    say("training", f"{steps} steps in {train_s:.3f} s (first call included); launches "
        f"{json.dumps(train_launches)}; per step (K1, K2) {card_run['per_step']}")
    if any(n1 != 1 or n2 < 2 for n1, n2 in card_run["per_step"]):
        raise AssertionError("a training step did not launch K1 once and K2 at least twice")
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

    # warm steps on the card: host clock per step, then a profiler window
    trainer = card_run["trainer"]
    warm = hensman_step_times(trainer)
    say("training", f"step (host clock, warm) median {warm['host_ms']:.3f} ms over 5, first "
        f"{warm['first_ms']:.3f} ms (S={trainer.subjects_per_batch} T={world.cfg.T} "
        f"L={world.cfg.latent_dim} M={world.cfg.M})")
    say("profile", "train_step " + json.dumps(warm["profile"]))

    # phase 6: the standard training path on the card; counts from 0 just before it
    reset_launch_counts()
    t0 = time.perf_counter()
    std_runs = standard_path(world)
    std_counts = launch_counts()
    say("standard", f"{sum(len(r['epochs']) for r in std_runs.values())} steps in "
        f"{time.perf_counter() - t0:.3f} s; launches {json.dumps(std_counts)}")
    for kernel in ("b_chain", "chol_inv", "kernel_matrix", "adam"):
        if std_counts[kernel] < 1:
            raise AssertionError(f"{kernel} was not launched on the standard path")

    s_errs = compare_standard(world)
    say("compare", f"standard card vs CPU {json.dumps(s_errs)} (tolerances "
        f"{json.dumps({k: LOSS_TOLS[k] for k in STD_LOSS_KEYS})})")
    check_within(s_errs)

    # warm closed-KL steps on the card: host clock per step, then a profiler window
    trainer = std_runs["closed"]["trainer"]
    step_ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.run_epoch()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    say("standard", f"closed step (host clock, warm) median {statistics.median(step_ms):.3f} "
        f"ms over {len(step_ms)} (N={world.labels.shape[0]} L={world.cfg.latent_dim}), "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    say("profile", "standard_step " + json.dumps(profile_window(trainer.run_epoch, 3)))

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
        cpu_eval = evaluate_pipeline(resumed_pipeline(PIPE_DIR, pipe_run, "cpu"))
        p_errs = compare_pipeline(card_eval, cpu_eval)
        say("compare", f"pipeline card vs CPU from model_final.ckpt: card {json.dumps(card_eval)} "
            f"CPU {json.dumps(cpu_eval)} rel {json.dumps(p_errs)} (GP term and net <= "
            f"{KL_RTOL}, recon, nll and test MSEs <= {LOSS_RTOL}; "
            f"{time.perf_counter() - t0:.1f} s)")

        # the Hensman run's reference GP files, before the profile trains on
        export_errs = check_export(world, PIPE_DIR, pipe_run, card_pipe)
        say("export", f"gp_model.pth, zt_list.pth, m.pth, H.pth of the CLI run: a second "
            f"export from model_final.ckpt gives the same bits; read back, |raw param "
            f"difference| {json.dumps(export_errs)} (<= {EXPORT_ATOL:g}), z, m, H equal")

        say("profile", "pipeline_epoch " + json.dumps(profile_window(card_pipe.trainer.run_epoch, 1)))
        say("profile", "pipeline_validation " + json.dumps(
            profile_window(lambda: pipe_validate(card_pipe), 2)))

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
        vi_warm = vi_step_times(vi["trainer"])
        say("vi", f"phase-1 step (host clock, warm) median {vi_warm['host_ms']:.3f} ms over 3 "
            f"(N={world.cfg.P * world.cfg.T} rows, L={world.cfg.latent_dim}) | {card}")
        say("profile", f"vi_step {json.dumps(vi_warm['profile'])} | {card}")
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

    # phase 10: the kernels line
    paths = {"serving": serve_counts, "training": train_launches, "standard": std_counts,
             "pipeline": pipe_run["counts"], "pipeline_k4": k4_run["counts"],
             "vi": vi["counts"], "rnn": rnn_counts}
    for e, key in ((entry, "chol_inv"), (k1_entry, "b_chain"), (k3_entry, "kernel_matrix"),
                   (k4_entry, "block_pair"), (k5_entry, "adam")):
        e["launches_by_path"] = {path: counts[key] for path, counts in paths.items()}
        e["launches"] = sum(e["launches_by_path"].values())
    entry["launches_by_step"] = gpu["launches"]
    print(json.dumps({"kernels": [entry, k1_entry, k3_entry, k4_entry, k5_entry]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

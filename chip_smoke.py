#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lvae_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Builds the port's CUDA kernels from ``lvae_torch/csrc``, holds each against
its plain PyTorch version on the card, then serves a random-weight L-VAE at
the full width of ``configs/healthmnist_lvae.txt`` (ConvVAE on 36×36 frames,
L=32 latent GPs, M=60 inducing points, a basis cohort of P=100 subjects ×
T=20 frames) through the user-facing entry points: ``LVAEPredictor``,
``aot_compile``, ``impute``, ``predict_trajectories``, ``predict_trajectory``,
``predict_latent_trajectory`` and ``refresh_basis``. The same calls are
replayed with ``device="cpu"`` (the plain versions) and the card's answers
are held against the CPU's.

Phases print one line each. Any failure raises and exits non-zero; without
CUDA the script exits non-zero before printing a result. The last lines
are a ``{"kernels": [...]}`` JSON object, the card's name and power limit,
and ``{"ok": true, "device": {...}}``.

Numbers: kernel times are CUDA-event averages over repeated launches on
warm (L2-resident) inputs; request times are host-clock medians of calls
that end in a host copy. ``bound_ms`` is the larger of bytes over 3.35 TB/s
and f32 operations over 67 TFLOP/s (H100 SXM data sheet).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from lvae_torch.config import load_flag_file  # noqa: E402
from lvae_torch.evaluation.encode import encode_dataset  # noqa: E402
from lvae_torch.inference import LVAEPredictor  # noqa: E402
from lvae_torch.kernels_cuda import build  # noqa: E402
from lvae_torch.kernels_cuda import cholesky as k2  # noqa: E402
from lvae_torch.models.vae import make_vae  # noqa: E402
from lvae_torch.ops import kernels as kx  # noqa: E402
from lvae_torch.train.state import init_gp_params, init_inducing_points  # noqa: E402

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

    def model(self):
        """A fresh ConvVAE with the seed's random weights, on the CPU."""
        cfg = self.cfg
        return make_vae(
            cfg.type_nnet, cfg.latent_dim, cfg.num_dim, vy_init=cfg.vy_init,
            dropout=cfg.dropout, dropout_input=cfg.dropout_input,
            generator=torch.Generator().manual_seed(self.seed),
        )

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

    # times, at the shapes the main path gives the kernel
    fold_b = cases[-1][1]
    per_shape = []
    for a in (fold_b, fold_b[:, :K_SUBJECTS].contiguous()):
        row = {
            "shape": list(a.shape),
            "ms": cuda_ms(k2.cholesky_inverse, a),
            "plain_ms": cuda_ms(k2.cholesky_inverse_reference, a),
            "library_ms": cuda_ms(library_chol_inv, a),
            **chol_inv_bound(a.shape),
        }
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
        "plain_ms": fold["plain_ms"],
        "bound_ms": fold["bound_ms"],
        "bound_by": fold["bound_by"],
        "library_ms": fold["library_ms"],
        "library_call": "torch.linalg.cholesky + torch.cholesky_inverse",
        "shape": fold["shape"],
        "bound_us": fold["bound_ms"] * 1e3,
        "max_rel_err": max(rel_err(l, lr), rel_err(inv, ir)),
        "per_shape": per_shape,
    }


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

    # phase 4: the main path on the card; counts from 0 just before it
    k2.cholesky_inverse.launches = 0
    gpu = serve(world, "cuda")
    main_launches = k2.cholesky_inverse.launches
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

    # phase 5: the kernels line
    entry["launches"] = main_launches
    entry["launches_by_step"] = gpu["launches"]
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

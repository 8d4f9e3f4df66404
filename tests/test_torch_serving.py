"""The port's whole serving slice against lvae_tpu's, on the CPU, and the
port's two guards (no JAX import; no quiet fall-back to the CPU).

Both predictors are built by hand from the same arrays: the flax ConvVAE's
``model.init`` params (carried to the port by ``utils/convert.py``), GP
params from ``init_gp_params(constrain_scales=True)`` with a seeded
perturbation, and inducing points from ``init_inducing_points``. The cohort
is P=6 subjects × T=5 frames in the HealthMNIST label layout with the
config file's kernel spec, L=4 and M=8.

Everything runs in float32, so answers are held by tolerances rather than
the f64 rtol 1e-8 of the module tests: decoded frames (sigmoid outputs in
[0, 1]) at atol 1e-6, and latents, whose GP algebra carries f32 rounding
through the M×M and T×T Cholesky solves in another summation order, at
max |Δ| over max |ref| ≤ 2e-5 (measured: about 1e-6 for the encoder's
means, 5e-7 for the GP answers, 6e-8 for frames).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvae_tpu import inference as jinf
from lvae_tpu.config import load_flag_file
from lvae_tpu.evaluation.encode import encode_dataset as j_encode_dataset
from lvae_tpu.models import vae as jv
from lvae_tpu.ops import kernels as jkx
from lvae_tpu.train import state as jst
from lvae_torch import inference as tinf
from lvae_torch.evaluation.encode import encode_dataset as t_encode_dataset
from lvae_torch.kernels_cuda import cholesky as k2
from lvae_torch.models import vae as tv
from lvae_torch.ops import kernels as tkx
from lvae_torch.utils.convert import gp_params_from_jax, vae_state_dict_from_jax

ROOT = Path(__file__).resolve().parents[1]
CONFIG = str(ROOT / "configs" / "healthmnist_lvae.txt")
L, M, P, T, HW = 4, 8, 6, 5, 36
T_OBS, N_QUERY, K = 3, 2, 2
FRAME_ATOL = 1e-6
LATENT_RTOL = 2e-5


def cohort(rng, subject_ids, t=T):
    """HealthMNIST-layout covariates [time_age, disease_time, subject,
    gender, disease, location] and uniform frames [N, 36, 36, 1]."""
    rows = []
    for s in subject_ids:
        sick, gender, loc = (int(v) for v in rng.integers(0, 2, 3))
        for i in range(t):
            rows.append([i, (i - t // 2) if sick else 0.0, s, gender, sick, loc])
    labels = np.asarray(rows, np.float32)
    frames = rng.uniform(size=(labels.shape[0], HW, HW, 1)).astype(np.float32)
    return frames, labels


def rel(got, want):
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(np.asarray(want)).max())


class World:
    """The same seeded arrays, handed to both packages."""

    def __init__(self, seed=0):
        cfg, _ = load_flag_file(CONFIG)
        rng = np.random.default_rng(seed)
        self.frames, self.labels = cohort(rng, range(P))
        new_f, new_l = cohort(rng, range(100, 100 + K))
        self.obs_frames = new_f.reshape(K, T, HW, HW, 1)[:, :T_OBS]
        self.obs_labels = new_l.reshape(K, T, -1)[:, :T_OBS]
        self.query_labels = new_l.reshape(K, T, -1)[:, T_OBS:T_OBS + N_QUERY]
        self.refresh_frames, self.refresh_labels = cohort(rng, range(200, 202))
        self.mask = (rng.uniform(size=(7, HW, HW, 1)) > 0.3).astype(np.float32)

        kw = cfg.kernel_spec_kwargs()
        self.j0, self.j1 = jkx.split_kernel_spec(id_covariate=cfg.id_covariate, **kw)
        self.t0, self.t1 = tkx.split_kernel_spec(id_covariate=cfg.id_covariate, **kw)
        gp = jst.init_gp_params(self.j0, self.j1, L, constrain_scales=True)
        # break the identical per-latent initial values, the same on both sides
        self.jgp = jax.tree_util.tree_map(
            lambda a: jnp.asarray(np.asarray(a) + 0.3 * rng.normal(size=a.shape), jnp.float32), gp
        )
        self.noise = np.ones(L, np.float32)  # constrain_scales: σ² = 1
        self.z = jst.init_inducing_points(self.labels, M, seed=seed)

        self.jmodel = jv.ConvVAE(latent_dim=L, num_dim=HW * HW, p=0.0)
        self.params = self.jmodel.init(
            jax.random.key(seed), jnp.zeros((2, HW, HW, 1), jnp.float32), deterministic=True
        )
        self.tmodel = tv.make_vae("conv", L, HW * HW, dropout=0.0)
        self.tmodel.load_state_dict(vae_state_dict_from_jax(self.params))

    def jax_predictor(self):
        mu, _ = j_encode_dataset(self.jmodel, self.params, self.frames)
        return jinf.LVAEPredictor(
            model=self.jmodel, vae_params=self.params, gp_params=self.jgp,
            noise=jnp.asarray(self.noise), spec0=self.j0, spec1=self.j1,
            z=jnp.asarray(self.z), id_covariate=2, basis_labels=self.labels,
            basis_mu=np.asarray(mu),
        )

    def torch_predictor(self):
        mu, _ = t_encode_dataset(self.tmodel, self.frames, device="cpu")
        return tinf.LVAEPredictor(
            model=self.tmodel, gp_params=gp_params_from_jax(self.jgp),
            noise=torch.from_numpy(self.noise), spec0=self.t0, spec1=self.t1,
            z=torch.from_numpy(self.z), id_covariate=2, basis_labels=self.labels,
            basis_mu=mu, device="cpu",
        )


@pytest.fixture(scope="module")
def world():
    return World()


def test_encode_and_impute_match(world):
    jp, tp = world.jax_predictor(), world.torch_predictor()
    assert rel(tp.basis_mu, jp.basis_mu) <= LATENT_RTOL
    frames = world.frames[:7]
    np.testing.assert_allclose(tp.impute(frames, world.mask), jp.impute(frames, world.mask),
                               atol=FRAME_ATOL, rtol=0)
    jb, tb = jp.aot_compile(batch_size=4), tp.aot_compile(batch_size=4)
    got = tb.impute(frames, world.mask)  # 7 rows: one full chunk and a padded one
    np.testing.assert_allclose(got, jb.impute(frames, world.mask), atol=FRAME_ATOL, rtol=0)
    keep = world.mask > 0
    np.testing.assert_array_equal(got[keep], frames[keep])


def test_predict_latent_trajectory_matches(world):
    jp, tp = world.jax_predictor(), world.torch_predictor()
    args = (world.obs_frames[0], world.obs_labels[0], world.query_labels[0])
    got = tp.predict_latent_trajectory(*args)
    assert got.shape == (N_QUERY, L)
    assert rel(got, jp.predict_latent_trajectory(*args)) <= LATENT_RTOL
    np.testing.assert_allclose(tp.predict_trajectory(*args), jp.predict_trajectory(*args),
                               atol=FRAME_ATOL, rtol=0)


def test_serving_bundle_requests_and_refresh_match(world):
    jp, tp = world.jax_predictor(), world.torch_predictor()
    kw = dict(batch_size=8, t_obs=T_OBS, n_query=N_QUERY, k_subjects=K)
    jb, tb = jp.aot_compile(**kw), tp.aot_compile(**kw)
    assert rel(tb._basis.h_nojit, jb._basis.h_nojit) <= LATENT_RTOL
    assert rel(tb._basis.c, jb._basis.c) <= LATENT_RTOL

    req = (world.obs_frames, world.obs_labels, world.query_labels)
    got = tb.predict_trajectories(*req)
    assert got.shape == (K, N_QUERY, HW, HW, 1)
    np.testing.assert_allclose(got, jb.predict_trajectories(*req), atol=FRAME_ATOL, rtol=0)
    one = (world.obs_frames[1], world.obs_labels[1], world.query_labels[1])
    np.testing.assert_allclose(tb.predict_trajectory(*one), jb.predict_trajectory(*one),
                               atol=FRAME_ATOL, rtol=0)

    jb.refresh_basis(world.refresh_frames, world.refresh_labels)
    tb.refresh_basis(world.refresh_frames, world.refresh_labels)
    assert rel(tb._basis.c, jb._basis.c) <= LATENT_RTOL
    assert tb.predictor.basis_labels.shape == (P * T + 2 * T, 6)
    np.testing.assert_allclose(tb.predict_trajectories(*req), jb.predict_trajectories(*req),
                               atol=FRAME_ATOL, rtol=0)
    with pytest.raises(ValueError, match="already in the basis"):
        tb.refresh_basis(world.refresh_frames, world.refresh_labels)

    sib = tb.for_k_subjects(1)
    np.testing.assert_allclose(
        sib.predict_trajectories(world.obs_frames[:1], world.obs_labels[:1], world.query_labels[:1]),
        jb.for_k_subjects(1).predict_trajectories(
            world.obs_frames[:1], world.obs_labels[:1], world.query_labels[:1]),
        atol=FRAME_ATOL, rtol=0,
    )


def test_cpu_serving_launches_no_kernel(world):
    tp = world.torch_predictor()
    before = k2.cholesky_inverse.launches
    tb = tp.aot_compile(batch_size=8, t_obs=T_OBS, n_query=N_QUERY, k_subjects=K)
    tb.predict_trajectories(world.obs_frames, world.obs_labels, world.query_labels)
    assert k2.cholesky_inverse.launches == before


def test_package_imports_no_jax():
    """Every module of lvae_torch imports in a fresh interpreter without
    pulling in jax, flax, optax or lvae_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import lvae_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(lvae_torch.__path__, 'lvae_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'lvae_tpu', 'tests'))\n"
        "assert len(names) >= 15, names\n"
        "for name in ('train.standard', 'kernels_cuda.adam', 'kernels_cuda.kernel_matrix',\n"
        "             'train.vi', 'models.rnn', 'utils.torch_compat', 'parallel.mesh',\n"
        "             'parallel.distributed', 'utils.checkpoint', 'utils.native_io'):\n"
        "    assert 'lvae_torch.' + name in names, name\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_entry_points_refuse_to_fall_back_to_cpu(world, monkeypatch):
    """Without CUDA, an entry point not told device='cpu' raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tp = world.torch_predictor()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tinf.LVAEPredictor(
            model=tp.model, gp_params=tp.gp_params, noise=tp.noise, spec0=tp.spec0,
            spec1=tp.spec1, z=tp.z, id_covariate=2, basis_labels=tp.basis_labels,
            basis_mu=tp.basis_mu,
        )
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_encode_dataset(tp.model, world.frames[:2])

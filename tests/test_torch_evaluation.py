"""The port's evaluation and pre-training (lvae_torch/evaluation/*.py,
lvae_torch/train/pretrain.py) against lvae_tpu's, on the CPU.

Both packages get one model: a float64 ConvVAE initialised by flax and
carried over with ``utils/convert.vae_state_dict_from_jax``, random float64
GP hyperparameters, and the same cohorts (HealthMNIST layout, T = 5; a
ragged validation cohort). The reparameterisation noise is injected: JAX's
``sample_latent`` is replaced by one that adds the test's noise for the
shape it is asked for, and the port is handed the same arrays. Tolerances
in float64: rtol 1e-8 for ``validate`` (DUBO, and GPapprox with two
samples), ``mse_test_gp_approx``, ``mse_test_exact`` (with the subsample
rule at a small cap), ``vae_test`` and the generation grid;
``VAEPretrainer``'s epoch sums at 1e-6 (their second step follows an Adam
update, whose 1/(√v̂ + eps) magnifies rounding of near-zero gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvae_tpu.data.datasets import ArrayDataset
from lvae_tpu.evaluation import generation as jgen
from lvae_tpu.evaluation import testing as jtest
from lvae_tpu.evaluation.validate import validate as jax_validate
from lvae_tpu.models import vae as jv
from lvae_tpu.ops import kernels as jkx
from lvae_tpu.train import pretrain as jpre
from lvae_tpu.train import state as jst
from lvae_torch.evaluation import generation as tgen
from lvae_torch.evaluation import testing as ttest
from lvae_torch.evaluation import validate as tval
from lvae_torch.models import vae as tv
from lvae_torch.ops import kernels as tkx
from lvae_torch.train import pretrain as tpre
from lvae_torch.train.state import GPParams
from lvae_torch.utils.convert import vae_state_dict_from_jax

L, T, M = 3, 5, 6
SPEC = dict(cat_kernel=[2], sqexp_kernel=[0],
            cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2},
                            {"cont_covariate": 1, "cat_covariate": 4}])


def cohort(subjects, seed, ragged=False, times=range(T)):
    rng = np.random.default_rng(seed)
    rows = []
    for s in subjects:
        sick, gender, loc = (int(v) for v in rng.integers(0, 2, 3))
        ts = list(times)[: len(times) - (s % 2)] if ragged else list(times)
        for i in ts:
            rows.append([i, (i - 1.0) if sick else 0.0, s, gender, sick, loc])
    labels = np.asarray(rows, np.float64)
    n = labels.shape[0]
    data = rng.uniform(size=(n, 36, 36, 1))
    mask = (rng.uniform(size=(n, 1296)) > 0.2).astype(np.float64)
    return ArrayDataset(data=data, labels=labels, mask=mask)


def noise_for(shape):
    """The injected standard-normal noise for a sample of ``shape``."""
    return np.random.default_rng(int(np.prod(shape)) * 7 + len(shape)).normal(size=shape)


@pytest.fixture(scope="module")
def world():
    jmodel = jv.ConvVAE(latent_dim=L, num_dim=1296, p=0.0, dtype=jnp.float64)
    train = cohort(range(4), 0)
    params = jmodel.init(jax.random.key(0), jnp.asarray(train.data[:2]), deterministic=True)
    params = jax.tree.map(lambda x: x.astype(jnp.float64), params)
    tmodel = tv.make_vae("conv", L, 1296, dropout=0.0, dtype=torch.float64)
    tmodel.load_state_dict(vae_state_dict_from_jax(params, np.float64))
    rng = np.random.default_rng(5)
    jspecs = jkx.split_kernel_spec(id_covariate=2, **SPEC)
    tspecs = tkx.split_kernel_spec(id_covariate=2, **SPEC)
    c0, c1 = (len(s.components) for s in jspecs)
    raw = [rng.normal(size=(L, c)) * 0.3 + off for c in (c0, c1) for off in (0.0, 1.0)]
    raw_noise = rng.normal(size=L) * 0.3
    jgp = jst.GPParams(kp0=jkx.KernelParams(*map(jnp.asarray, raw[:2])),
                       kp1=jkx.KernelParams(*map(jnp.asarray, raw[2:])),
                       raw_noise=jnp.asarray(raw_noise))
    tgp = GPParams(kp0=tkx.KernelParams(*map(torch.tensor, raw[:2])),
                   kp1=tkx.KernelParams(*map(torch.tensor, raw[2:])),
                   raw_noise=torch.tensor(raw_noise))
    noise = np.log1p(np.exp(raw_noise)) + 0.1
    z = jst.init_inducing_points(train.labels, M, seed=0, dtype=np.float64)
    pred_mu = rng.normal(size=(len(train), L))
    return dict(jmodel=jmodel, params=params, tmodel=tmodel, jspecs=jspecs, tspecs=tspecs,
                jgp=jgp, tgp=tgp, noise=noise, z=z, train=train, pred_mu=pred_mu,
                valid=cohort(range(10, 13), 1, ragged=True),
                test=cohort([0, 1, 20], 2, times=range(5, 8)))


@pytest.fixture
def inject(monkeypatch):
    """JAX's sample_latent with the noise of :func:`noise_for`. The jit
    caches are cleared on both sides: a program traced with either
    sample_latent must not serve a call made with the other."""
    def sample_latent(rng, mu, log_var):
        return mu + jnp.asarray(noise_for(mu.shape)) * jnp.exp(0.5 * log_var)

    jax.clear_caches()
    monkeypatch.setattr(jv, "sample_latent", sample_latent)
    yield
    jax.clear_caches()


@pytest.mark.parametrize("type_kl,loss", [("GPapprox_closed", "mse"), ("GPapprox", "nll")])
def test_validate_matches_jax(world, inject, type_kl, loss):
    w = world
    ds = w["valid"]
    want = jax_validate(
        w["jmodel"], w["params"], w["jgp"], jnp.asarray(w["noise"]), *w["jspecs"], ds,
        jnp.asarray(w["z"]), 2, 0.15, loss, L, 1e-5, type_kl=type_kl, num_samples=2,
        verbose=False)
    n, p = len(ds), 3
    t_max = int(np.max(np.unique(ds.labels[:, 2], return_counts=True)[1]))
    got = tval.validate(
        w["tmodel"], w["tgp"], torch.tensor(w["noise"]), *w["tspecs"], ds, w["z"], 2, 0.15,
        loss, L, 1e-5, type_kl=type_kl, num_samples=2, verbose=False,
        enc_eps=torch.tensor(noise_for((n, L))),
        gp_eps=torch.tensor(np.stack([noise_for((p, t_max, L))] * 2)), device="cpu")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-8)


def test_validate_prints_the_reference_line(world, capsys):
    w = world
    tval.validate(w["tmodel"], w["tgp"], torch.tensor(w["noise"]), *w["tspecs"], w["valid"],
                  w["z"], 2, 0.15, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Testing the model with a validation set"
    assert out[1].startswith("Validation set - Loss: ") and "  - GP loss: " in out[1]
    assert "  - NLL loss: " in out[1] and "  - Recon Loss: " in out[1]


def test_mse_test_gp_approx_matches_jax(world, inject, tmp_path):
    w = world
    ds = w["test"]
    want = jtest.mse_test_gp_approx(
        w["jmodel"], w["params"], w["jgp"], jnp.asarray(w["noise"]), *w["jspecs"], ds,
        w["train"].labels, w["pred_mu"], jnp.asarray(w["z"]), 2, 1e-5,
        results_path=str(tmp_path / "jax"), verbose=False)
    got = ttest.mse_test_gp_approx(
        w["tmodel"], w["tgp"], torch.tensor(w["noise"]), *w["tspecs"], ds, w["train"].labels,
        w["pred_mu"], w["z"], 2, 1e-5, results_path=str(tmp_path / "torch"), verbose=False,
        enc_eps=torch.tensor(noise_for((len(ds), L))), device="cpu")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-8)
    np.testing.assert_allclose(np.loadtxt(tmp_path / "torch" / "result_error.csv"),
                               np.loadtxt(tmp_path / "jax" / "result_error.csv"), rtol=1e-8)


@pytest.mark.parametrize("cap", [6040, 12])
def test_mse_test_exact_matches_jax(world, inject, cap):
    w = world
    ds = w["test"]
    jspec, jkp = jkx.join_specs(*w["jspecs"], w["jgp"].kp0, w["jgp"].kp1)
    tspec, tkp = tkx.join_specs(*w["tspecs"], w["tgp"].kp0, w["tgp"].kp1)
    want = jtest.mse_test_exact(w["jmodel"], w["params"], jkp, jspec, jnp.asarray(w["noise"]),
                                ds, w["train"].labels, w["pred_mu"], 1e-5,
                                max_prediction_rows=cap, verbose=False)
    got = ttest.mse_test_exact(w["tmodel"], tkp, tspec, torch.tensor(w["noise"]), ds,
                               w["train"].labels, w["pred_mu"], 1e-5, max_prediction_rows=cap,
                               verbose=False, enc_eps=torch.tensor(noise_for((len(ds), L))),
                               device="cpu")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-8)


def test_vae_test_matches_jax(world, inject):
    w = world
    want = jtest.vae_test(w["jmodel"], w["params"], w["test"], verbose=False)
    got = ttest.vae_test(w["tmodel"], w["test"], verbose=False, device="cpu",
                         enc_eps=torch.tensor(noise_for((len(w["test"]), L))))
    np.testing.assert_allclose(got, want, rtol=1e-8)


@pytest.mark.parametrize("epoch", [-1, 3])
def test_generation_grid_matches_jax(world, monkeypatch, tmp_path, epoch):
    """The grid the port saves equals the one JAX's plot is drawn from
    (its arguments captured and laid out by the port's grid function)."""
    w = world
    seen = {}
    monkeypatch.setattr(jgen, "gen_rotated_mnist_seqrecon_plot",
                        lambda x, recon_x, labels_recon, labels_train, save_file, num_sets:
                        seen.update(x=x, recon=recon_x, labels=labels_train, n=num_sets))
    ds = cohort(range(30, 33), 3)
    jgen.recon_complete_gen(ds, w["jmodel"], w["params"], w["jgp"], jnp.asarray(w["noise"]),
                            *w["jspecs"], w["train"].labels, w["pred_mu"], jnp.asarray(w["z"]),
                            2, str(tmp_path), epoch=epoch, eps=1e-5, verbose=False)
    path = tgen.recon_complete_gen(ds, w["tmodel"], w["tgp"], torch.tensor(w["noise"]),
                                   *w["tspecs"], w["train"].labels, w["pred_mu"], w["z"], 2,
                                   str(tmp_path), epoch=epoch, eps=1e-5, verbose=False,
                                   device="cpu")
    assert path.endswith("recon_complete.npz" if epoch == -1 else "recon_complete_best.npz")
    got = np.load(path)
    want_grid, want_filled = tgen.seqrecon_grid(seen["x"], seen["recon"], seen["labels"],
                                                num_sets=seen["n"])
    np.testing.assert_array_equal(got["filled"], want_filled)
    np.testing.assert_allclose(got["grid"], want_grid, rtol=1e-6, atol=1e-7)
    # the data row holds the generation cohort's frames, the others predictions
    assert got["filled"][0, :T].all() and got["filled"][1, :T].all()


def test_vae_output_grid(world, tmp_path):
    w = world
    path = tgen.vae_output(w["tmodel"], w["train"], 25, str(tmp_path), seq_length=T,
                           num_sets=2, device="cpu")
    assert path.endswith("recon_VAE_25.npz")
    got = np.load(path)
    assert got["grid"].shape == (4, 20, 36, 36) and got["filled"][:, :T].all()  # 2 sets


def test_pretrain_epoch_matches_jax(world, inject):
    """One pre-training epoch of two steps (batch 8 of 20 frames) from one
    state: JAX's own permutation, replayed from its key, handed to the
    port with the injected noise."""
    w = world
    ds = w["train"]
    jp = jpre.VAEPretrainer(w["jmodel"], ds, loss_function="nll", dropout=False, seed=0,
                            batch_size=8, dtype=jnp.float64)
    params = jax.tree.map(lambda x: x.astype(jnp.float64), jp.state.params)
    jp.state = jp.state._replace(params=params, opt_state=jp.optimizer.init(params))
    _, perm_key = jax.random.split(jp.state.rng)
    order = np.asarray(jax.random.permutation(perm_key, len(ds)))[:16].reshape(2, 8)
    tmodel = tv.make_vae("conv", L, 1296, dropout=0.0, dtype=torch.float64)
    tmodel.load_state_dict(vae_state_dict_from_jax(params, np.float64))
    tp = tpre.VAEPretrainer(tmodel, ds, loss_function="nll", dropout=False, seed=0,
                            batch_size=8, dtype=torch.float64, device="cpu")
    want = jp.run_epoch()
    got = tp.run_epoch(order=torch.tensor(order),
                       eps=torch.tensor(np.stack([noise_for((8, L))] * 2)))
    for name in ("loss", "recon", "nll", "kld"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-6,
                                   err_msg=name)
    assert tp.state.step == 2


def test_pretrainer_fit_prints_and_calls_back(capsys):
    ds = cohort(range(2), 4)
    model = tv.make_vae("conv", 2, 1296, dropout=0.0, generator=torch.Generator().manual_seed(0))
    pre = tpre.VAEPretrainer(model, ds, loss_function="mse", dropout=False, seed=1,
                             device="cpu")
    calls = []
    hist = pre.fit(3, chunk=2, callback=lambda tr, done, m: calls.append(done))
    assert calls == [2, 3] and len(hist) == 3
    assert all(np.isfinite(list(m)).all() for m in hist)
    assert capsys.readouterr().out.count("====> Epoch: ") == 3
    # the same seed gives the same draws
    again = tpre.VAEPretrainer(
        tv.make_vae("conv", 2, 1296, dropout=0.0, generator=torch.Generator().manual_seed(0)),
        ds, loss_function="mse", dropout=False, seed=1, device="cpu")
    assert again.run_epoch() == hist[0]

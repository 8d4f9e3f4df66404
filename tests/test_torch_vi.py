"""The port's VI regime (lvae_torch/train/vi.py, LVAEPipeline.run_vi)
against lvae_tpu's, on the CPU in float64.

Both packages start from one state: lvae_tpu's ``VITrainer`` makes it (its
VAE params cast to float64, one step taken so that Adam's moments are not
zero) and ``utils/convert.vi_state_from_jax`` carries it to the port. The
reparameterisation noise is JAX's own draws, rebuilt from its key chain
and injected into the port. Tolerances: one phase-1 loss value and every
gradient at rtol 1e-8 (summation order only); 3-step trajectories of both
phases at rtol 1e-6 (Adam's division by √v̂ + eps magnifies 1e-12-level
differences of near-zero gradients); the joint cohort's rows equal. The
cohort is P=4 subjects × T=3 frames of 20 pixels in the HealthMNIST label
layout, L=2, M=4; the prediction cohort has 3 subjects, one of them with
2 frames, so the joint cohort of phase 2 is ragged.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvae_tpu.data import blocks as jbk
from lvae_tpu.data.datasets import ArrayDataset
from lvae_tpu.models import vae as jv
from lvae_tpu.ops import elbo as jeb
from lvae_tpu.ops import kernels as jkx
from lvae_tpu.train import state as jst
from lvae_tpu.train import vi as jvi
from lvae_torch.config import LVAEConfig
from lvae_torch.data import blocks as tbk
from lvae_torch.models import vae as tv
from lvae_torch.ops import kernels as tkx
from lvae_torch.pipeline import LVAEPipeline
from lvae_torch.train import state as tst
from lvae_torch.train import vi as tvi
from lvae_torch.utils import checkpoint as ck
from lvae_torch.utils.convert import vae_state_dict_from_jax, vi_state_from_jax

P, T, L, M, D = 4, 3, 2, 4, 20
SPEC = dict(cat_kernel=[2], sqexp_kernel=[0],
            cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2},
                            {"cont_covariate": 1, "cat_covariate": 4}])
# regime name: (loss_function, constrain_scales)
REGIMES = {"mse_constrained": ("mse", True), "nll_free_noise": ("nll", False)}


def cohort(subjects, seed, t_lens=None, d=D):
    """Subject-major rows ``[time, disease_time, id, gender, disease,
    location]`` with uniform frames and a random observation mask."""
    rng = np.random.default_rng(seed)
    rows = []
    for i, s in enumerate(subjects):
        sick, gender, loc = (int(v) for v in rng.integers(0, 2, 3))
        for k in range(T if t_lens is None else t_lens[i]):
            rows.append([k + rng.uniform(), (k - 1.0) if sick else 0.0, s, gender, sick, loc])
    labels = np.asarray(rows)
    n = labels.shape[0]
    return ArrayDataset(data=rng.uniform(size=(n, d)), labels=labels,
                        mask=(rng.uniform(size=(n, d)) > 0.2).astype(np.float64))


TRAIN = cohort(range(P), 0)
PRED = cohort([10, 11, 12], 1, t_lens=[3, 2, 3])


def make_pair(regime):
    """(JAX trainer after one step, port trainer from its state)."""
    loss, constrain = REGIMES[regime]
    args = dict(latent_dim=L, weight=0.15, loss_function=loss, constrain_scales=constrain,
                eps=1e-5)
    jcfg = jvi.VIConfig(*jkx.split_kernel_spec(id_covariate=2, **SPEC), **args)
    tcfg = tvi.VIConfig(*tkx.split_kernel_spec(id_covariate=2, **SPEC), **args)
    z = jst.init_inducing_points(TRAIN.labels, M, seed=0, dtype=np.float64)
    jmodel = jv.SimpleVAE(latent_dim=L, num_dim=D, dtype=jnp.float64)
    params = jmodel.init(jax.random.key(3), jnp.zeros((2, D)))
    params = jax.tree.map(lambda x: x.astype(jnp.float64), params)
    gp = jst.init_gp_params(jcfg.spec0, jcfg.spec1, L, constrain_scales=constrain,
                            dtype=jnp.float64)
    jtr = jvi.VITrainer(jmodel, jcfg, TRAIN, jbk.build_subject_blocks(TRAIN.labels, 2), z,
                        params, gp, learning_rate=1e-2, seed=0, dtype=jnp.float64)
    jtr.state, _ = jtr.step_fn(jtr.state, *jax_inputs(jtr))
    tmodel = tv.make_vae("simple", L, D, dtype=torch.float64)
    tgp = tst.init_gp_params(tcfg.spec0, tcfg.spec1, L, constrain_scales=constrain,
                             dtype=torch.float64)
    ttr = tvi.VITrainer(tmodel, tcfg, TRAIN, tbk.build_subject_blocks(TRAIN.labels, 2), z, tgp,
                        learning_rate=1e-2, dtype=torch.float64, device="cpu")
    ttr.state = vi_state_from_jax(jtr.state, ttr.model, learning_rate=1e-2, dtype=torch.float64)
    return jtr, ttr


def jax_inputs(jtr):
    return jtr.data_ordered, jtr.pixmask_ordered, jtr.xb, jtr.block_mask, jtr.z_ind


def phase1_eps(jstate):
    """The noise JAX's next phase-1 step draws (vi.py step_fn)."""
    _, key = jax.random.split(jstate.rng)
    return np.asarray(jax.random.normal(key, jstate.mu.shape, dtype=jstate.mu.dtype))


def state_arrays(jstate, tstate):
    """Matching (name, JAX numpy, port numpy) triples of every optimised
    tensor of a VI state."""
    jsd = vae_state_dict_from_jax(jstate.vae, np.float64)
    out = [("mu", np.asarray(jstate.mu), tstate.mu), ("log_var", np.asarray(jstate.log_var),
                                                      tstate.log_var)]
    out += [(n, jsd[n].numpy(), p) for n, p in tstate.vae.named_parameters()]
    jgp = [*jstate.gp.kp0, *jstate.gp.kp1, jstate.gp.raw_noise]
    out += [(f"gp{i}", np.asarray(a), b) for i, (a, b) in enumerate(zip(jgp, tstate.gp.tensors()))]
    return out


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_phase1_loss_value_and_every_gradient_match_jax(regime):
    jtr, ttr = make_pair(regime)
    cfg, st = jtr.cfg, jtr.state
    eps = np.random.default_rng(7).normal(size=st.mu.shape)
    data, pixmask, xb, block_mask, z_ind = jax_inputs(jtr)

    def loss(tr):  # lvae_tpu/train/vi.py:108-140 with the test's noise
        mu, log_var, vae, gp = tr
        zs = mu + jnp.asarray(eps) * jnp.exp(0.5 * log_var)
        recon = jtr.model.apply(vae, zs, deterministic=True, method=type(jtr.model).decode)
        mse_i, nll_i = jv.vae_loss(vae["params"]["raw_log_vy"], recon, data, pixmask)
        noise = (jnp.ones_like(gp.raw_noise) if cfg.constrain_scales
                 else jkx.constrain(gp.raw_noise))
        ops = jeb.gp_block_operators(cfg.spec0, cfg.spec1, gp.kp0, gp.kp1, noise, xb, z_ind,
                                     block_mask, cfg.eps)
        gp_loss = jnp.sum(jeb.dubo(ops, mu.reshape(P, T, L), log_var.reshape(P, T, L))) / L
        net = (jnp.sum(mse_i) + cfg.weight * gp_loss if cfg.loss_function == "mse"
               else jnp.sum(nll_i) + gp_loss)
        return net, (jnp.sum(mse_i), jnp.sum(nll_i), gp_loss)

    (net, aux), grads = jax.value_and_grad(loss, has_aux=True)(
        (st.mu, st.log_var, st.vae, st.gp))
    tstate = ttr.state
    got = ttr.loss(tstate, torch.tensor(eps))
    got[0].backward()
    for g, w in zip(got, (net,) + aux):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-8)
    jgrads = jvi.VIState(*grads, opt_state=None, rng=None)
    for name, want, tensor in state_arrays(jgrads, tstate):
        # raw_noise under constrain_scales: no port gradient, JAX's is 0
        g = np.zeros_like(want) if tensor.grad is None else tensor.grad.numpy()
        np.testing.assert_allclose(g, want, rtol=1e-8, atol=1e-13 * np.abs(want).max(),
                                   err_msg=name)
    assert np.abs(np.asarray(grads[3].kp1.raw_scale)).max() > 0  # the GP term reaches kp1


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_phase1_three_step_trajectory_matches_jax(regime, capsys):
    jtr, ttr = make_pair(regime)
    for _ in range(3):
        eps = phase1_eps(jtr.state)
        jtr.state, want = jtr.step_fn(jtr.state, *jax_inputs(jtr))
        got = ttr.train_step(eps=torch.tensor(eps))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    for name, want, got in state_arrays(jtr.state, ttr.state):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-12,
                                   err_msg=name)
    # fit() logs in the reference's format and keeps the four terms
    ttr.fit(2, log_every=1)
    assert "Iter 2/2 - Loss: " in capsys.readouterr().out
    assert set(ttr.history[-1]) == {"net", "recon", "nll", "gp"}


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_phase2_three_step_trajectory_matches_jax(regime):
    jtr, ttr = make_pair(regime)
    want_mu, want_lv = jtr.optimize_prediction_set(PRED, epochs=3, learning_rate=1e-2,
                                                   log_every=0, seed=1)
    key = jax.random.key(1)  # vi.py:354-363: one split a chunk, then one a step
    _, sub = jax.random.split(key)
    eps = np.stack([np.asarray(jax.random.normal(k, (len(PRED), L), dtype=jnp.float64))
                    for k in jax.random.split(sub, 3)])
    mu, lv = ttr.optimize_prediction_set(PRED, epochs=3, learning_rate=1e-2, log_every=0,
                                         eps=torch.tensor(eps))
    np.testing.assert_allclose(mu, want_mu, rtol=1e-6, atol=1e-12)
    np.testing.assert_allclose(lv, want_lv, rtol=1e-6, atol=1e-12)
    assert len(ttr.pred_history) == 3


def test_joint_cohort_rows_equal_jax():
    jtr, ttr = make_pair("mse_constrained")
    mu_pred = np.random.default_rng(2).normal(size=(len(PRED), L))
    want = jtr.joint_cohort(PRED, mu_pred)
    got = ttr.joint_cohort(PRED, mu_pred)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    labels = got[0]
    jb = jbk.build_subject_blocks(labels, 2)
    tb = tbk.build_subject_blocks(labels, 2)
    assert not tb.mask.all()  # the joint cohort is ragged
    np.testing.assert_array_equal(tb.index, jb.index)
    np.testing.assert_array_equal(tb.mask, jb.mask)


def test_ragged_training_cohort_is_refused():
    ragged = cohort(range(3), 4, t_lens=[3, 2, 3])
    tcfg = tvi.VIConfig(*tkx.split_kernel_spec(id_covariate=2, **SPEC), latent_dim=L,
                        weight=0.15, loss_function="mse", constrain_scales=True, eps=1e-5)
    gp = tst.init_gp_params(tcfg.spec0, tcfg.spec1, L)
    with pytest.raises(ValueError, match="fixed-T"):
        tvi.VITrainer(tv.make_vae("simple", L, D), tcfg, ragged,
                      tbk.build_subject_blocks(ragged.labels, 2), ragged.labels[:M], gp,
                      device="cpu")


def test_vi_state_checkpoint_round_trip_continues_the_run(tmp_path):
    _, a = make_pair("nll_free_noise")
    path = ck.save_checkpoint(str(tmp_path / "vi.ckpt"), a.state)
    _, b = make_pair("mse_constrained")  # another state of the same shapes
    b.cfg = a.cfg
    b.state = ck.load_checkpoint(path, like=b.state)
    for x, y in zip(a.state.opt_state.param_groups[0]["params"],
                    b.state.opt_state.param_groups[0]["params"]):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    ma, mb = a.train_step(), b.train_step()  # drawn from the restored generator
    torch.testing.assert_close(ma, mb, rtol=0, atol=0)
    with pytest.raises(ValueError, match="does not restore"):
        ck.load_checkpoint(path, like={"mu_pred": None, "log_var_pred": None})


def conv_cohort(p, seed, first_id=0):
    ds = cohort(range(first_id, first_id + p), seed, d=36 * 36)
    return ArrayDataset(data=ds.data.reshape(-1, 36, 36, 1).astype(np.float32),
                        labels=ds.labels, mask=ds.mask.astype(np.float32))


def vi_cfg(out, **over):
    base = dict(dataset_type="HealthMNIST", type_nnet="conv", latent_dim=2, id_covariate=2,
                M=4, P=4, T=3, epochs=3, weight=0.15, num_dim=1296, hensman=False,
                natural_gradient=False, variational_inference_training=True,
                constrain_scales=True, cat_kernel=[2], sqexp_kernel=[0],
                cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2}],
                loss_function="mse", run_tests=False, run_validation=False,
                generate_images=False, save_path=out, results_path=out, dropout=0.0)
    base.update(over)
    return LVAEConfig(**base)


def test_run_vi_writes_both_checkpoints_generates_and_resumes(tmp_path):
    """As tests/test_review_fixes.py checks for lvae_tpu: run_vi writes
    model_vi.ckpt and vi_prediction.ckpt and the generation grid, and a
    second run through run() resumes the saved state."""
    out = str(tmp_path)
    train = conv_cohort(4, 0)
    datasets = {"train": train, "prediction": conv_cohort(3, 5, first_id=100),
                "generation": conv_cohort(2, 6, first_id=100)}
    pipe = LVAEPipeline(vi_cfg(out, generate_images=True), datasets, device="cpu")
    pipe.run_vi(pred_epochs=4)
    assert len(pipe.trainer.history) == 3 and np.isfinite(pipe.trainer.history[-1]["net"])
    saved = ck.read_checkpoint(os.path.join(out, "model_vi.ckpt"))
    assert saved["kind"] == "vi" and saved["opt"]["state"][0]["step"] == 3
    pred = ck.load_checkpoint(os.path.join(out, "vi_prediction.ckpt"),
                              like={"mu_pred": None, "log_var_pred": None})
    assert pred["mu_pred"].shape == (9, 2) and np.isfinite(pred["log_var_pred"]).all()
    grid = np.load(os.path.join(out, "recon_complete_best.npz"))  # epoch = cfg.epochs, as in JAX
    assert np.isfinite(grid["grid"]).all() and grid["filled"].any()

    pipe2 = LVAEPipeline(vi_cfg(out, epochs=2, gp_model_folder=out), {"train": train},
                         device="cpu")
    trainer = pipe2.build_vi_trainer()
    torch.testing.assert_close(trainer.state.mu, saved["mu"], rtol=0, atol=0)
    pipe2.trainer = None
    assert pipe2.run() is None
    resumed = ck.read_checkpoint(os.path.join(out, "model_vi.ckpt"))
    assert resumed["opt"]["state"][0]["step"] == 3 + 2  # continued, not restarted
    assert pipe2.trainer.history[0]["net"] < pipe.trainer.history[0]["net"]

"""Rank-side helpers of the port's parallel tests (imports torch and
lvae_torch only, so the spawned ranks never import JAX).

:func:`launch` starts a world of ``nprocs`` gloo ranks on the CPU
(``lvae_torch.parallel.distributed.spawn_ranks``), each of which runs one
of the ``world_*`` functions below and saves what it returns to
``<out>/rank<r>.pt``; :func:`collect` waits for them and loads the
results. The helpers below make the port's trainers on the tiny cohort of the
JAX package's sharding tests (P=8 subjects x T=4 frames, L=4, M=6, 4
subjects a batch, SimpleVAE, float64 unless asked), so that the test
process can build the same problem in both packages.
"""

from __future__ import annotations

import contextlib
import io
import os
import warnings
from typing import Optional

import numpy as np
import torch

from lvae_torch.data.blocks import build_subject_blocks
from lvae_torch.data.datasets import ArrayDataset
from lvae_torch.models import vae as tv
from lvae_torch.ops import kernels as tkx
from lvae_torch.ops.predict import build_predict_inputs, gp_predict, predict_latents
from lvae_torch.parallel import distributed as pdist
from lvae_torch.parallel import mesh as pm
from lvae_torch.train import hensman as tth
from lvae_torch.train import state as tst
from lvae_torch.train.standard import StandardConfig, StandardTrainer
from lvae_torch.train.vi import VIConfig, VITrainer
from lvae_torch.utils.checkpoint import load_checkpoint, save_checkpoint

P, T, L, M, S = 8, 4, 4, 6, 4
SPEC = dict(cat_kernel=[2], sqexp_kernel=[0],
            cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2}])


# ------------------------------------------------------------------- worlds
def _resolve(fn_name: str):
    """A function of this module, or ``module:function``."""
    if ":" not in fn_name:
        return globals()[fn_name]
    import importlib

    module, name = fn_name.split(":")
    return getattr(importlib.import_module(module), name)


def _traced(fn_name: str, args: tuple) -> dict:
    """A rank's run of ``fn_name(*args)``, with the warnings it raised."""
    torch.set_num_threads(1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        result = _resolve(fn_name)(*args)
    result["warnings"] = [str(w.message) for w in caught]
    return result


def launch(nprocs: int, fn_name: str, args: tuple, out: str, device: str = "cpu"):
    """Start ``fn_name(*args)`` on ``nprocs`` ranks on ``device`` (gloo on
    the CPU or one shared card); returns the context."""
    return pdist.spawn_ranks(nprocs, _traced, (fn_name, args), out, device=device)


def collect(ctx, out: str, timeout: float = 240.0) -> list:
    """Wait for a world and return each rank's result, in rank order."""
    return pdist.join_ranks(ctx, out, timeout)


# ----------------------------------------------------------------- problems
def cohort(p: int = P, t: int = T, seed: int = 0) -> ArrayDataset:
    """The JAX sharding tests' tiny cohort (``tests/test_training.tiny_cohort``)."""
    rng = np.random.default_rng(seed)
    n = p * t
    labels = np.stack([
        np.tile(np.arange(t), p).astype(float),
        np.repeat(rng.normal(size=p), t),
        np.repeat(np.arange(p), t).astype(float),
        np.repeat(rng.integers(0, 2, p), t).astype(float),
    ], axis=1)
    data = rng.uniform(size=(n, 20)).astype(np.float32)
    mask = (rng.uniform(size=(n, 20)) > 0.25).astype(np.float32)
    return ArrayDataset(data=data, labels=labels, mask=mask)


def specs():
    return tkx.split_kernel_spec(id_covariate=2, **SPEC)


def hensman_trainer(dtype=torch.float64, p: int = P, latent_dim: int = L,
                    subjects_per_batch: int = S, device="cpu") -> tth.HensmanTrainer:
    """The port's trainer at the JAX sharding tests' settings
    (``tests/test_training.make_cfg(True)``)."""
    ds = cohort(p)
    cfg = tth.HensmanConfig(*specs(), latent_dim=latent_dim, P_tot=p, N_tot=p * T, weight=0.5,
                            loss_function="mse", natural_gradient=True,
                            natural_gradient_lr=0.01, constrain_scales=True, eps=1e-5,
                            dropout=False)
    model = tv.make_vae("simple", latent_dim, 20, dropout=0.0, dtype=dtype,
                        generator=torch.Generator().manual_seed(0))
    z = tst.init_inducing_points(ds.labels, M, seed=0, dtype=np.float64)
    return tth.HensmanTrainer(model, cfg, ds, build_subject_blocks(ds.labels, 2), z,
                              subjects_per_batch=subjects_per_batch, seed=0, dtype=dtype,
                              device=device)


def hensman_steps(trainer, orders, eps) -> dict:
    """Train on explicit batches: ``orders [epochs, batches, S]`` table rows
    and ``eps [epochs, batches, S·T, L]``; the per-epoch mean metrics and
    the final (m, H)."""
    epochs, dtype = [], trainer.dtype
    for order, noise in zip(orders, eps):
        ms = [torch.stack(list(trainer.train_step(trainer.tables[0], torch.as_tensor(rows),
                                                  torch.as_tensor(e, dtype=dtype))))
              for rows, e in zip(order, noise)]
        epochs.append(torch.stack(ms).mean(0).tolist())
    st = trainer.state
    return {"epochs": np.asarray(epochs), "m": st.m_nat.detach().cpu().numpy().copy(),
            "H": st.H_nat.detach().cpu().numpy().copy()}


def standard_trainer(type_kl: str, p: int = P, dtype=torch.float64,
                     latent_dim: int = L) -> StandardTrainer:
    """The port's full-batch trainer at the JAX sharding tests' settings
    (``tests/test_sharding.build_standard_trainer``)."""
    ds = cohort(p)
    spec0, spec1 = specs()
    cfg = StandardConfig(spec0=spec0, spec1=spec1, latent_dim=latent_dim, P_tot=p, T=T,
                         weight=0.5, loss_function="mse", type_KL=type_kl, num_samples=2,
                         constrain_scales=True, eps=1e-6, dropout=False)
    model = tv.make_vae("simple", latent_dim, 20, dropout=0.0, dtype=dtype,
                        generator=torch.Generator().manual_seed(0))
    z = tst.init_inducing_points(ds.labels, M, seed=0, dtype=np.float64)
    return StandardTrainer(model, cfg, ds, build_subject_blocks(ds.labels, 2), z,
                           dtype=dtype, device="cpu")


def standard_noise(type_kl: str, p: int, epochs: int = 3, seed: int = 3):
    """Per-epoch ``(eps [P·T, L], gp_eps [2, P, T, L] or None)`` for a
    cohort of ``p`` subjects: the first ``p`` subjects' rows of one draw for
    10, so that a cohort and its ghost-padded copy get the same noise."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(epochs):
        eps = rng.normal(size=(10 * T, L))[: p * T]
        gp_eps = rng.normal(size=(2, 10, T, L))[:, :p] if type_kl == "GPapprox" else None
        out.append((eps, gp_eps))
    return out


def standard_epochs(trainer, noise) -> dict:
    hist = []
    for eps, gp_eps in noise:
        m = trainer.run_epoch(eps=torch.as_tensor(eps),
                              gp_eps=None if gp_eps is None else torch.as_tensor(gp_eps))
        hist.append(list(m))
    gp = trainer.state.trainables.gp
    return {"epochs": np.asarray(hist),
            "gp": [t.detach().numpy().copy() for t in gp.tensors()]}


def vi_trainer(latent_dim: int = 3, dtype=torch.float64) -> VITrainer:
    """The port's VI trainer at the JAX sharding test's settings
    (``tests/test_sharding.test_sharded_vi_matches_single_device``)."""
    ds = cohort(P)
    spec0, spec1 = specs()
    model = tv.make_vae("simple", latent_dim, 20, dropout=0.0, dtype=dtype,
                        generator=torch.Generator().manual_seed(0))
    gp = tst.init_gp_params(spec0, spec1, latent_dim, constrain_scales=True, dtype=dtype)
    cfg = VIConfig(spec0=spec0, spec1=spec1, latent_dim=latent_dim, weight=0.5,
                   loss_function="mse", constrain_scales=True, eps=1e-6)
    z = tst.init_inducing_points(ds.labels, M, seed=0, dtype=np.float64)
    return VITrainer(model, cfg, ds, build_subject_blocks(ds.labels, 2), z, gp, dtype=dtype,
                     device="cpu")


def vi_prediction_cohort() -> ArrayDataset:
    pred = cohort(4, seed=5)
    pred.labels[:, 2] += 100
    return pred


def vi_run(trainer, steps: int, pred_eps) -> dict:
    rng = np.random.default_rng(11)
    hist = [trainer.train_step(torch.as_tensor(rng.normal(size=(P * T, trainer.cfg.latent_dim))))
            .tolist() for _ in range(steps)]
    mu_pred, lv_pred = trainer.optimize_prediction_set(
        vi_prediction_cohort(), epochs=len(pred_eps), log_every=0, eps=torch.as_tensor(pred_eps))
    return {"steps": np.asarray(hist), "mu": trainer.state.mu.detach().numpy().copy(),
            "mu_pred": mu_pred, "lv_pred": lv_pred}


def predict_problem(dtype=np.float64, latent_dim: int = L, p_query: int = 4):
    """The JAX sharding tests' serving problem
    (``tests/test_sharding.test_sharded_gp_predict_matches_single_device``):
    ``(spec0, spec1, kp0, kp1, noise, train, test, mu, z)`` as numpy."""
    rng = np.random.default_rng(0)
    train = cohort(P, seed=0)
    test = cohort(p_query, seed=1)
    test.labels[:, 2] += 6  # ids 6, 7 align with training; the rest are unseen
    spec0, spec1 = specs()
    gp = tst.init_gp_params(spec0, spec1, latent_dim, dtype=torch.float64)
    kp0 = [rng.normal(0.5, 0.2, gp.kp0.raw_scale.shape), gp.kp0.raw_lengthscale.numpy()]
    kp1 = [gp.kp1.raw_scale.numpy(), gp.kp1.raw_lengthscale.numpy()]
    noise = rng.uniform(0.4, 0.9, (latent_dim,))
    mu = rng.normal(size=(len(train.labels), latent_dim))
    z = tst.init_inducing_points(train.labels, m_inducing=M, seed=0, dtype=np.float64)
    cast = [np.asarray(a, dtype) for a in (*kp0, *kp1, noise, mu, z)]
    return (spec0, spec1, cast[0:2], cast[2:4], cast[4], train, test, cast[5], cast[6])


def torch_predict(problem, mesh=None, flat: bool = False):
    """The posterior of :func:`predict_problem` in one process (``mesh``
    None) or on a mesh: the blocks ``[Pq, Tq, L]`` through ``gp_predict`` /
    ``sharded_gp_predict``, or the flat ``[N_test, L]`` through
    ``predict_latents``."""
    spec0, spec1, kp0, kp1, noise, train, test, mu, z = problem
    t = torch.as_tensor
    kp0 = tkx.KernelParams(t(kp0[0]), t(kp0[1]))
    kp1 = tkx.KernelParams(t(kp1[0]), t(kp1[1]))
    if flat:
        return predict_latents(spec0, spec1, kp0, kp1, t(noise), train.labels, mu, test.labels,
                               t(z), 2, 1e-6, mesh=mesh)
    inputs, _, _ = build_predict_inputs(train.labels, mu, test.labels, 2, dtype=mu.dtype)
    if mesh is None:
        out = gp_predict(spec0, spec1, kp0, kp1, t(noise), inputs, t(z), 1e-6)
    else:
        out = pm.sharded_gp_predict(spec0, spec1, kp0, kp1, t(noise), inputs, t(z), mesh, 1e-6)
    return out.numpy()


# ----------------------------------------------------- what a rank runs
def world_hensman(shape, ckpt: str, orders, eps, extra: Optional[dict] = None) -> dict:
    """The sharded Hensman trainer from the checkpoint ``ckpt`` on explicit
    batches, and, where ``extra`` asks, more of the slice at this mesh."""
    extra = extra or {}
    mesh = pm.make_mesh(*shape, device="cpu")
    trainer = hensman_trainer()
    trainer.state = load_checkpoint(ckpt, like=trainer.state)
    sharded = pm.ShardedHensmanTrainer(trainer, mesh)
    out = {"hensman": hensman_steps(sharded, orders, eps),
           "shard_shapes": {k: tuple(v.shape) for k, v in (
               ("H_nat", pm.shard_hensman_state(sharded.state, mesh, L).H_nat),
               ("raw_scale", pm.shard_hensman_state(sharded.state, mesh, L)
                .trainables.gp.kp0.raw_scale))}}
    if extra.get("save_to") and mesh.writer:
        save_checkpoint(extra["save_to"], sharded.state)
    mesh.barrier()
    if "odd_batch" in extra:  # 3 subjects a batch: one ghost pads it to the data axis
        trainer = hensman_trainer(subjects_per_batch=3)
        trainer.state = load_checkpoint(ckpt, like=trainer.state)
        out["odd_batch"] = hensman_steps(pm.ShardedHensmanTrainer(trainer, mesh),
                                         *extra["odd_batch"])
    if "predict" in extra:
        problem = predict_problem()
        out["predict"] = torch_predict(problem, mesh)
        out["predict_flat"] = torch_predict(problem, mesh, flat=True)
        out["predict_unaligned"] = torch_predict(predict_problem(p_query=3), mesh)
    if "f32" in extra:
        out["f32"] = f32_step(**extra["f32"], mesh=mesh)
    return out


STANDARD_P = 9  # subjects of the standard regime's cohort: 1 ghost on a 2-way data axis


def world_regimes(shape, vi: Optional[dict] = None) -> dict:
    """The sharded standard modes on the 9-subject cohort (3 epochs each),
    the GPPVAE refusal and, where ``vi`` asks, the sharded VI trainer and
    the facade's checks."""
    mesh = pm.make_mesh(*shape, device="cpu")
    out = {}
    for type_kl in ("closed", "GPapprox", "GPapprox_closed"):
        tr = standard_trainer(type_kl, p=STANDARD_P)
        said = io.StringIO()
        with contextlib.redirect_stdout(said):
            sharded = pm.ShardedStandardTrainer(tr, mesh)
        out[type_kl] = standard_epochs(sharded, standard_noise(type_kl, tr.block_mask.shape[0]))
        out[type_kl].update(subjects=tr.block_mask.shape[0], said=said.getvalue())
    tr = standard_trainer("GPapprox_closed")
    tr.pseudo_minibatch = True
    try:
        pm.ShardedStandardTrainer(tr, mesh)
        out["gppvae_refused"] = ""
    except ValueError as e:
        out["gppvae_refused"] = str(e)
    if vi is not None:
        out["vi"] = vi_run(pm.ShardedVITrainer(vi_trainer(), mesh), vi["steps"], vi["pred_eps"])
    if shape == (2, 1):
        out["facade"] = facade_checks(mesh)
    return out


def f32_step(ckpt: str, rows, eps, lr: float, mesh=None) -> dict:
    """One f32 Hensman step with natural-gradient rate ``lr`` from the
    checkpoint ``ckpt``, in one process or on ``mesh``: its metrics,
    whether the natural-gradient step was kept, and the new m."""
    trainer = hensman_trainer(dtype=torch.float32)
    trainer.state = load_checkpoint(ckpt, like=trainer.state)
    trainer.cfg = trainer.cfg._replace(natural_gradient_lr=lr)
    sharded = trainer if mesh is None else pm.ShardedHensmanTrainer(trainer, mesh)
    m0 = sharded.state.m_nat.clone()
    metrics = sharded.train_step(trainer.tables[0], torch.as_tensor(rows),
                                 torch.as_tensor(eps, dtype=torch.float32))
    return {"metrics": [float(v) for v in metrics],
            "kept": not torch.equal(sharded.state.m_nat, m0),
            "m": sharded.state.m_nat.numpy().copy()}


def facade_checks(mesh) -> dict:
    """State writes are placed, attribute writes reach the inner trainer,
    and ``fit`` hands the wrapper to its callback."""
    trainer = standard_trainer("GPapprox_closed")
    sharded = pm.ShardedStandardTrainer(trainer, mesh)
    seen = []
    sharded.fit(1, log_every=0, callback=lambda t, e, m: seen.append(t is sharded))
    new_mask = trainer.block_mask + 0
    sharded.block_mask = new_mask
    ht = hensman_trainer()
    hs = pm.ShardedHensmanTrainer(ht, mesh)
    written = ht.state._replace(H_nat=ht.state.H_nat.clone())
    hs.state = written
    return {"callback_got_wrapper": seen == [True],
            "write_reached_inner": trainer.block_mask is new_mask,
            "no_shadow": "block_mask" not in vars(sharded),
            "state_written": ht.state.H_nat is written.H_nat}


def world_pipeline(flag_file: str, results: str, extra_dir: str) -> dict:
    """The reference-format CLI with ``--data_mesh=2`` (its group is this
    world's), then the pipeline's other mesh routes: the predictor of a
    sharded pipeline, the standard regime and the VI regime."""
    import dataclasses

    from lvae_torch import cli
    from lvae_torch.config import LVAEConfig, parse_flag_lines
    from lvae_torch.inference import LVAEPredictor
    from lvae_torch.pipeline import LVAEPipeline

    mesh_flags = [f"--f={flag_file}", "--data_mesh=2", f"--save_path={results}",
                  f"--results_path={results}"]
    out = {"cli_rc": cli.main(["--device=cpu"] + mesh_flags)}

    cfg, _ = parse_flag_lines(mesh_flags, LVAEConfig)
    pred = LVAEPredictor.from_checkpoint(os.path.join(results, "model_final.ckpt"), cfg,
                                         device="cpu")
    obs = pred.basis_labels[:5].copy()
    obs[:, 2] = 777.0
    frames = np.random.default_rng(9).uniform(size=(5, 36, 36, 1)).astype(np.float32)
    query = obs.copy()
    query[:, 0] += 0.5
    out["predictor_mesh"] = repr(pred.mesh)
    out["predict_mesh"] = pred.predict_latent_trajectory(frames, obs, query)
    out["predict_single"] = dataclasses.replace(pred, mesh=None).predict_latent_trajectory(
        frames, obs, query)

    routes = {
        "standard": ["--hensman=False", "--natural_gradient=False", "--epochs=1"],
        "vi": ["--hensman=False", "--natural_gradient=False",
               "--variational_inference_training=True", "--epochs=2"],
    }
    for name, flags in routes.items():
        where = os.path.join(extra_dir, name)
        cfg, _ = parse_flag_lines(mesh_flags[:2] + flags + [
            f"--save_path={where}", f"--results_path={where}", "--run_tests=False",
            "--run_validation=False", "--generate_images=False"], LVAEConfig)
        pipe = LVAEPipeline(cfg, device="cpu")
        if name == "vi":
            pipe.run_vi(pred_epochs=2)
            last = pipe.trainer.history[-1]["net"]
        else:
            pipe.build_trainer()
            last = pipe.train()[-1].net
        out[name] = {"trainer": type(pipe.trainer).__name__, "last_net": float(last)}
    return out


def world_card_hensman(shape, orders, eps) -> dict:
    """f32 sharded Hensman epochs on the rank's card (``cuda:0`` shared by
    the ranks), with the K1 and K2 launches they made."""
    from lvae_torch.kernels_cuda import b_chain as k1
    from lvae_torch.kernels_cuda import cholesky as k2

    mesh = pm.make_mesh(*shape, device="cuda")
    trainer = hensman_trainer(dtype=torch.float32, device=mesh.device)
    sharded = pm.ShardedHensmanTrainer(trainer, mesh)
    before = (k1.b_chain.launches, k2.cholesky_inverse.launches)
    out = hensman_steps(sharded, orders, eps)
    out["launches"] = (k1.b_chain.launches - before[0], k2.cholesky_inverse.launches - before[1])
    return out

"""The port's CLI pipeline (lvae_torch/cli.py, pipeline.py) against the JAX
package's (lvae_tpu/cli.py, pipeline.py), driven on the same generated CSVs
with the same flag file, ``--device=cpu`` for the port.

What does not depend on randomness is compared:

* the schedule: the dispatch chunk (gcd of ``checkpoint_every`` and
  ``test_freq``), the epochs at which the callback validates, saves
  ``model_last``/``model_best``/``model_final`` (with the training step each
  holds), runs the best-model tests and generates the grid;
* best-model tracking from one stubbed sequence of validation losses, fed
  to both packages;
* the auto-recover rollback: a state poisoned once after epoch 2 is rolled
  back in both, with the same saves, records and replayed epochs, under
  each checkpoint backend (``pickle``; ``orbax`` and ``orbax_async``, whose
  snapshots are directories, the rollback reading the background save
  after waiting for it). The saves are recorded at each package's routed
  ``_save_ckpt``, which every backend goes through;
* JAX's orbax snapshot of epoch 1, restored by JAX's
  ``load_checkpoint_orbax`` and carried over by ``utils/convert.py``: the
  same layout as the port's directory snapshot of that epoch, and, written
  as a port directory checkpoint and resumed by the port's pipeline, the
  GP operators' ``gp_health`` of JAX's snapshot (float64, 1e-8);
* the records: ``metrics.jsonl`` steps and keys, ``diagnostics.pkl``
  entries and keys, the ``plot_values.pkl`` layout, the ``result_error*.csv``
  shapes and the artefact names (the port saves each PDF's grid also as
  ``.npz``), and the reference GP-state files' keys, shapes and dtypes;
* ``gp_health`` on the JAX run's final GP state, converted, on both routes.

Tiny sizes: 2 subjects × 5 frames, L = 2, M = 4, 6 epochs of 2 steps.
"""

import contextlib
import io
import json
import os
import pickle
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lvae_tpu.cli as jcli
import lvae_tpu.ops.kernels as jkx
import lvae_tpu.pipeline as jpipe
import lvae_tpu.train.hensman as jhen
import lvae_tpu.utils.checkpoint as jck
import lvae_torch.cli as tcli
import lvae_torch.ops.kernels as tkx
import lvae_torch.pipeline as tpipe
import lvae_torch.train.hensman as then
from lvae_tpu.config import parse_flag_lines as jparse
from lvae_torch.config import parse_flag_lines as tparse
from lvae_tpu.ops import elbo as jeb
from lvae_tpu.utils.debug import gp_health as jax_gp_health
from lvae_torch.data import healthmnist as thm
from lvae_torch.models.vae import make_vae
from lvae_torch.ops import elbo as teb
from lvae_torch.utils import checkpoint as tck
from lvae_torch.utils.convert import gp_params_from_jax, hensman_state_from_jax
from lvae_torch.utils.debug import gp_health

SPLITS = ("test", "prediction", "validation", "generation")
MODEL_FLAGS = ["--type_nnet=conv", "--latent_dim=2", "--num_dim=1296", "--dropout=0",
               "--id_covariate=2", "--M=4", "--weight=0.15", "--cat_kernel=[2]",
               "--sqexp_kernel=[0]", "--cat_int_kernel=[{'cont_covariate':0, 'cat_covariate':2}]",
               "--constrain_scales=True", "--hensman=True", "--natural_gradient=True",
               "--subjects_per_batch=1", "--type_KL=GPapprox_closed", "--loss_function=mse",
               "--T=5", "--gp_model_folder=", "--model_params="]
EVAL_FLAGS = ["--run_tests=True", "--run_validation=True", "--generate_images=True"]
# the reference GP-state export
GP_FILES = ("gp_model.pth", "zt_list.pth", "m.pth", "H.pth")
# validation losses handed out in call order: epochs 2, 4, 6, then run()'s
VAL_NETS = (3.0, 1.0, 2.0, 9.0)


def flag_file(root, results, extra):
    lines = [f"--data_source_path={root / 'data'}", f"--save_path={results}",
             f"--results_path={results}", "--dataset_type=HealthMNIST",
             "--csv_file_data=health_MNIST_data_masked.csv",
             "--csv_file_label=health_MNIST_label.csv", "--mask_file=mask.csv"]
    for split in SPLITS:
        lines += [f"--csv_file_{split}_data=health_MNIST_data_masked.csv",
                  f"--csv_file_{split}_label=health_MNIST_label.csv",
                  f"--{split}_mask_file=mask.csv"]
    path = root / f"{results.name}.txt"
    path.write_text("\n".join(lines + MODEL_FLAGS + list(extra)) + "\n")
    return str(path)


def instrument(mp, pipe_mod, trainer_cls, events, nets=None, poison=None, keep=None,
               wait=None):
    """Record the pipeline's schedule in ``events``: each ``fit`` with its
    chunk, each save (at the routed ``_save_ckpt``, whatever the backend)
    with its file, epoch and step, each validation, test and generation.
    ``nets``: the validation losses to hand out instead of validating.
    ``poison(trainer)``: called once, after the second epoch. ``keep``: a
    path where a copy of epoch 1's ``model_last.ckpt`` goes, once ``wait()``
    has waited for it."""
    real_save, real_test, real_gen = (pipe_mod.LVAEPipeline._save_ckpt,
                                      pipe_mod.mse_test_gp_approx, pipe_mod.recon_complete_gen)
    real_fit, real_run = trainer_cls.fit, trainer_cls.run_epochs

    def save_ckpt(self, path, state, metadata=None):
        epoch = (metadata or {}).get("epoch")
        events.append(("save", os.path.basename(path), epoch, int(state.step)))
        out = real_save(self, path, state, metadata=metadata)
        if keep is not None and epoch == 1 and not os.path.exists(keep):
            wait()
            (shutil.copytree if os.path.isdir(path) else shutil.copy)(path, keep)
        return out

    def validate(*args, **kwargs):
        events.append(("validate",))
        return types.SimpleNamespace(net=next(nets))

    def mse_test_gp_approx(*args, **kwargs):
        events.append(("test", kwargs["save_file"]))
        return real_test(*args, **kwargs)

    def recon_complete_gen(*args, **kwargs):
        events.append(("generate", kwargs["epoch"]))
        return real_gen(*args, **kwargs)

    def fit(self, epochs, **kwargs):
        events.append(("fit", epochs, kwargs["chunk"]))
        return real_fit(self, epochs, **kwargs)

    def run_epochs(self, n):
        out = real_run(self, n)
        if poison is not None and len(self.history) == 2 and not events.count(("poison",)):
            events.append(("poison",))
            poison(self)
        return out

    mp.setattr(pipe_mod.LVAEPipeline, "_save_ckpt", save_ckpt)
    mp.setattr(pipe_mod, "mse_test_gp_approx", mse_test_gp_approx)
    mp.setattr(pipe_mod, "recon_complete_gen", recon_complete_gen)
    if nets is not None:
        mp.setattr(pipe_mod, "validate", validate)
    mp.setattr(trainer_cls, "fit", fit)
    mp.setattr(trainer_cls, "run_epochs", run_epochs)


def poison_jax(trainer):
    tr = trainer.state.trainables
    kp0 = tr.gp.kp0._replace(raw_scale=tr.gp.kp0.raw_scale * jnp.nan)
    trainer.state = trainer.state._replace(trainables=tr._replace(gp=tr.gp._replace(kp0=kp0)))


def poison_torch(trainer):
    with torch.no_grad():
        trainer.state.trainables.gp.kp0.raw_scale.fill_(float("nan"))


def run_both(root, name, extra, nets=None, poison=False):
    """Run the same flag file through both CLIs; returns per package its
    events, standard output, results folder and the copy of epoch 1's
    snapshot (``kept``, where one was saved)."""
    out = {}
    for pkg, cli, pipe_mod, cls, poisoner, wait, argv in (
        ("jax", jcli, jpipe, jhen.HensmanTrainer, poison_jax, jck.wait_for_async_saves, []),
        ("torch", tcli, tpipe, then.HensmanTrainer, poison_torch, tck.wait_for_async_saves,
         ["--device=cpu"]),
    ):
        results = root / f"{name}_{pkg}"
        kept = root / f"{name}_{pkg}_epoch1.ckpt"
        cfg = flag_file(root, results, extra)
        events, stdout = [], io.StringIO()
        with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(stdout):
            instrument(mp, pipe_mod, cls, events, nets=iter(nets) if nets else None,
                       poison=poisoner if poison else None, keep=kept, wait=wait)
            assert cli.main(argv + [f"--f={cfg}"]) == 0
        out[pkg] = dict(events=events, stdout=stdout.getvalue(), results=results, cfg=cfg,
                        kept=kept)
    return out["jax"], out["torch"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("parity")
    thm.generate_healthmnist(1, 1, num_timepoints=5, seed=1, destination=str(root / "data"))
    return root


@pytest.fixture(scope="module")
def scheduled(root):
    """6 epochs, validation every 2 and checkpoints every 4 (so a chunk of
    2), with tests and generation; the validation losses are stubbed."""
    return run_both(root, "sched",
                    EVAL_FLAGS + ["--epochs=6", "--test_freq=2", "--checkpoint_every=4"],
                    nets=VAL_NETS)


def test_schedule_and_best_model_match_jax(scheduled):
    jax_run, torch_run = scheduled
    assert torch_run["events"] == jax_run["events"]
    # the schedule itself, read off the JAX package's run
    ev = jax_run["events"]
    assert ev[0] == ("fit", 6, 2)
    assert [e for e in ev if e[0] == "save" and e[1] == "model_best.ckpt"] == [
        ("save", "model_best.ckpt", 2, 4), ("save", "model_best.ckpt", 4, 8)]
    assert ev.count(("validate",)) == 4
    for run in (jax_run, torch_run):
        assert "Best results in epoch: 4" in run["stdout"]
        assert run["stdout"].count("Saving better model") == 2


def test_records_match_jax(scheduled):
    jax_run, torch_run = scheduled
    compare_records(jax_run["results"], torch_run["results"], epochs=6)


def compare_records(jres, tres, epochs):
    jnames = set(os.listdir(jres))
    # a directory checkpoint's snapshot sits beside its link, hidden
    assert tck.leftovers(str(tres)) == []
    tnames = {n for n in os.listdir(tres) if not n.startswith(".")}
    grids = {n for n in tnames if n.endswith(".npz")}
    assert tnames - grids == jnames
    for name in GP_FILES:  # both write the same tensors (their values follow each run)
        if name in jnames:
            want, got = (torch.load(d / name, map_location="cpu") for d in (jres, tres))
            if isinstance(want, dict):
                assert sorted(got) == sorted(want), name
                want, got = list(want.values()), [got[k] for k in want]
            else:
                want, got = [want], [got]
            assert [(g.shape, g.dtype) for g in got] == [(w.shape, w.dtype) for w in want]
    assert grids == {n[:-4] + ".npz" for n in jnames if n.endswith(".pdf")}
    for name in sorted(n for n in jnames if n.startswith("result_error")):
        assert np.loadtxt(tres / name).shape == np.loadtxt(jres / name).shape, name
    jrec = [json.loads(line) for line in open(jres / "metrics.jsonl")]
    trec = [json.loads(line) for line in open(tres / "metrics.jsonl")]
    assert [r["step"] for r in trec] == [r["step"] for r in jrec] == list(range(1, epochs + 1))
    assert [set(r) for r in trec] == [set(r) for r in jrec]
    jhist = pickle.load(open(jres / "diagnostics.pkl", "rb"))
    thist = pickle.load(open(tres / "diagnostics.pkl", "rb"))
    assert len(thist) == len(jhist) == epochs
    assert [list(m) for m in thist] == [list(m._asdict()) for m in jhist]
    jplot = pickle.load(open(jres / "plot_values.pkl", "rb"))
    tplot = pickle.load(open(tres / "plot_values.pkl", "rb"))
    assert len(tplot) == len(jplot) == 5
    np.testing.assert_array_equal(tplot[0], jplot[0])
    np.testing.assert_array_equal(tplot[4], jplot[4])
    for t_arr, j_arr in zip(tplot[1:4], jplot[1:4]):
        assert t_arr.shape == np.asarray(j_arr).shape and t_arr.dtype == np.asarray(j_arr).dtype


RECOVER_FLAGS = ["--auto_recover=True", "--epochs=3", "--checkpoint_every=1", "--test_freq=0"]


def check_rollback(jax_run, torch_run):
    assert torch_run["events"] == jax_run["events"]
    saves = [e for e in jax_run["events"] if e[0] == "save"]
    # epoch 2 is rolled back to epoch 1's snapshot and replayed
    assert [e[1:3] for e in saves] == [("model_last.ckpt", 1), ("model_last.ckpt", 2),
                                       ("model_last.ckpt", 3), ("model_final.ckpt", None)]
    assert [e[3] for e in saves] == [2, 4, 6, 6]
    for run in (jax_run, torch_run):
        assert "Recovered from non-finite state at epoch 2 (attempt 1" in run["stdout"]
    compare_records(jax_run["results"], torch_run["results"], epochs=3)


def test_auto_recover_rollback_matches_jax(root):
    check_rollback(*run_both(root, "recover", RECOVER_FLAGS, poison=True))


@pytest.fixture(scope="module", params=["orbax", "orbax_async"])
def recovered(root, request):
    """The rollback run under a directory backend."""
    backend = request.param
    return backend, run_both(root, f"recover_{backend}",
                             RECOVER_FLAGS + [f"--checkpoint_backend={backend}"], poison=True)


def test_auto_recover_rollback_matches_jax_under_each_directory_backend(recovered):
    _, (jax_run, torch_run) = recovered
    check_rollback(jax_run, torch_run)
    for run in (jax_run, torch_run):
        for name in ("model_last.ckpt", "model_final.ckpt"):
            assert os.path.isdir(run["results"] / name), name
    final = tck.read_checkpoint(str(torch_run["results"] / "model_final.ckpt"))
    assert final["step"] == 6 and final["metadata"] == {}
    assert tck.leftovers(str(torch_run["results"])) == []


def test_jax_orbax_snapshot_carries_over_to_the_port(recovered):
    """JAX's orbax snapshot of epoch 1 → ``load_checkpoint_orbax`` →
    ``hensman_state_from_jax``: the layout of the port's own snapshot of
    epoch 1 (every entry's shape and dtype, the step); the inducing points
    equal;
    written by the port as a directory checkpoint and resumed by the port's
    pipeline, its GP operators' ``gp_health`` matches JAX's on the snapshot
    (float64, 1e-8)."""
    _, (jax_run, torch_run) = recovered
    jcfg, _ = jparse([f"--f={jax_run['cfg']}"])
    jpipeline = jpipe.LVAEPipeline(jcfg)
    jtrainer = jpipeline.build_trainer()
    jstate = jck.load_checkpoint_orbax(str(jax_run["kept"]), jtrainer.state)
    assert int(jstate.step) == 2
    model = make_vae("conv", 2, 1296, dropout=0.0, generator=torch.Generator().manual_seed(0))
    carried = tck.state_payload(hensman_state_from_jax(jstate, model))
    port = tck.read_checkpoint(str(torch_run["kept"]))
    assert port["metadata"] == {"epoch": 1} and port["step"] == carried["step"] == 2

    def layout(x):
        if isinstance(x, torch.Tensor):
            return (tuple(x.shape), x.dtype)
        if isinstance(x, dict):
            return {k: layout(v) for k, v in x.items() if k not in ("format", "version",
                                                                     "metadata")}
        if isinstance(x, (list, tuple)):
            return [layout(v) for v in x]
        return type(x)

    assert layout(carried) == layout(port)

    folder = jax_run["kept"].parent / f"{jax_run['kept'].name}_carried"
    path = tck.save_checkpoint_dir(str(folder / "model_final.ckpt"),
                                   hensman_state_from_jax(jstate, model))
    tcfg, _ = tparse([f"--f={torch_run['cfg']}", f"--gp_model_folder={folder}"])
    tpipeline = tpipe.LVAEPipeline(tcfg, device="cpu")
    ttrainer = tpipeline.build_trainer()
    resumed = ttrainer.state
    assert resumed.step == 2 and os.path.isdir(path)
    xb = np.asarray(tpipeline.dataset.labels, np.float64).reshape(2, 5, -1)
    z = np.asarray(jtrainer.tdata.z, np.float64)
    np.testing.assert_array_equal(ttrainer.tdata.z.numpy(), np.asarray(jtrainer.tdata.z))
    noise = np.ones(2)
    jgp = jax.tree.map(lambda a: jnp.asarray(a, np.float64), jstate.trainables.gp)
    jops = jeb.gp_block_operators(jpipeline.spec0, jpipeline.spec1, jgp.kp0, jgp.kp1,
                                  jnp.asarray(noise), jnp.asarray(xb), jnp.asarray(z),
                                  eps=jcfg.eps)
    tgp = resumed.trainables.gp.to(dtype=torch.float64)
    with torch.no_grad():
        tops = teb.gp_block_operators(tpipeline.spec0, tpipeline.spec1, tgp.kp0, tgp.kp1,
                                      torch.tensor(noise), torch.tensor(xb), torch.tensor(z),
                                      eps=tcfg.eps)
    want = {k: np.asarray(v) for k, v in jax_gp_health(jops).items()}
    got = {k: v.numpy() for k, v in gp_health(tops).items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8, err_msg=k)


@pytest.mark.parametrize("route", ["plain", "k1"])
def test_gp_health_matches_jax_on_a_converted_state(scheduled, monkeypatch, route):
    """``gp_health`` of one batch's operators, built from the JAX run's
    final GP state (resumed from its ``model_final.ckpt``) and the same
    state converted: the plain route in float64 at 1e-8, the K1 route (no B,
    no LB, float32 only) at 1e-3, the float32 Cholesky of K0zz by two
    libraries."""
    jax_run, _ = scheduled
    folder = jax_run["results"]
    cfg, _ = jparse([f"--f={jax_run['cfg']}", f"--gp_model_folder={folder}"])
    pipe = jpipe.LVAEPipeline(cfg)
    trainer = pipe.build_trainer()
    dtype = np.float64 if route == "plain" else np.float32
    monkeypatch.setattr(jkx, "use_pallas_b_chain", route == "k1")
    monkeypatch.setattr(tkx, "use_b_chain_kernel", route == "k1")
    gp = trainer.state.trainables.gp
    xb = np.asarray(pipe.dataset.labels, dtype).reshape(2, 5, -1)
    z = np.asarray(trainer.tdata.z, dtype)
    noise = np.ones(2, dtype)
    jgp = jax.tree.map(lambda a: jnp.asarray(a, dtype), gp)
    jops = jeb.gp_block_operators(pipe.spec0, pipe.spec1, jgp.kp0, jgp.kp1,
                                  jnp.asarray(noise), jnp.asarray(xb), jnp.asarray(z),
                                  eps=cfg.eps)
    tgp = gp_params_from_jax(gp, dtype=torch.float64 if route == "plain" else torch.float32)
    tspec0, tspec1 = tkx.split_kernel_spec(id_covariate=cfg.id_covariate,
                                           **cfg.kernel_spec_kwargs())
    with torch.no_grad():
        tops = teb.gp_block_operators(tspec0, tspec1, tgp.kp0, tgp.kp1, torch.tensor(noise),
                                      torch.tensor(xb), torch.tensor(z), eps=cfg.eps)
    want = {k: np.asarray(v) for k, v in jax_gp_health(jops).items()}
    got = {k: v.numpy() for k, v in gp_health(tops).items()}
    assert set(got) == set(want)
    assert ("finite_iB" in got) == (route == "k1")
    rtol = 1e-8 if route == "plain" else 1e-3
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)

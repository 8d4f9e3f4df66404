"""The port's reference-format CLI pipeline (lvae_torch/cli.py,
lvae_torch/pipeline.py, utils/checkpoint.py, utils/metrics.py,
utils/debug.py, inference.LVAEPredictor.from_pipeline/from_checkpoint),
on the CPU with ``--device=cpu``.

* The reference's whole workflow through ``lvae_torch.cli.main``: generate
  → pre-train → Hensman training with validation, best model, tests and
  generation, with every artefact of ``tests/test_cli_real_formats.py``
  (each PDF's grid also as ``.npz``); the standard regime (closed KL, exact
  GP test); resume from ``gp_model_folder``.
* The callback's machinery: the auto-recover rollback, the metrics stream.
* Checkpoints: a full training state round trip (the continued run equals
  the uninterrupted one), a reference ``.pth`` VAE seeding the model.
* Serving a trained model: ``from_pipeline`` and ``from_checkpoint`` agree.
* The VI regime is routed to ``run_vi``; a configuration that waits
  raises ``NotImplementedError`` naming its item.

``tests/test_torch_pipeline_parity.py`` holds the pipeline's schedule,
rollback and records against lvae_tpu's on the same files.

Tiny sizes: 2 subjects × 20 frames from the CLI generator, 2 × 5 from the
generator function elsewhere, L = 2, M = 4, 1–2 epochs.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from lvae_torch import cli
from lvae_torch.config import parse_flag_lines
from lvae_torch.data import healthmnist as thm
from lvae_torch.inference import LVAEPredictor
from lvae_torch.models.vae import make_vae
from lvae_torch.ops import elbo as teb
from lvae_torch.pipeline import LVAEPipeline
from lvae_torch.utils import checkpoint as ck
from lvae_torch.utils.debug import assert_state_finite, gp_health
from lvae_torch.utils import metrics
from lvae_torch.utils.metrics import device_memory_stats

SPLITS = ("", "test", "prediction", "validation", "generation")


def data_flags(data, results):
    lines = [f"--data_source_path={data}", f"--save_path={results}",
             f"--results_path={results}", "--dataset_type=HealthMNIST",
             "--csv_file_data=health_MNIST_data_masked.csv",
             "--csv_file_label=health_MNIST_label.csv", "--mask_file=mask.csv"]
    for split in SPLITS[1:]:
        lines += [f"--csv_file_{split}_data=health_MNIST_data_masked.csv",
                  f"--csv_file_{split}_label=health_MNIST_label.csv",
                  f"--{split}_mask_file=mask.csv"]
    return lines


MODEL_FLAGS = ["--type_nnet=conv", "--latent_dim=2", "--num_dim=1296", "--dropout=0",
               "--id_covariate=2", "--M=4", "--weight=0.15", "--cat_kernel=[2]",
               "--sqexp_kernel=[0]", "--cat_int_kernel=[{'cont_covariate':0, 'cat_covariate':2}]",
               "--constrain_scales=True"]
HENSMAN_FLAGS = ["--hensman=True", "--natural_gradient=True", "--subjects_per_batch=1",
                 "--type_KL=GPapprox_closed", "--loss_function=mse"]
EVAL_FLAGS = ["--run_tests=True", "--run_validation=True", "--generate_images=True"]


def write(path, lines):
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The reference workflow through the port's CLI, on the CPU."""
    root = tmp_path_factory.mktemp("cli")
    data, results = root / "data", root / "results"
    assert cli.main(["--device=cpu", "generate", f"--destination={data}", "--num_3=1",
                     "--num_6=1", "--seed=0"]) == 0
    vae_cfg = write(root / "vae.txt", data_flags(data, results)[:2] + data_flags(
        data, results)[3:7] + ["--type_nnet=conv", "--latent_dim=2", "--num_dim=1296",
                               "--epochs=2", "--loss_function=nll", "--dropout=0"])
    assert cli.main(["pretrain", f"--f={vae_cfg}", "--device=cpu"]) == 0
    lvae_cfg = write(root / "lvae.txt", data_flags(data, results) + MODEL_FLAGS + HENSMAN_FLAGS
                     + EVAL_FLAGS + ["--T=20", "--epochs=2", "--test_freq=1",
                                     "--checkpoint_every=1",
                                     f"--model_params={results / 'model_params_vae.ckpt'}",
                                     "--gp_model_folder="])
    assert cli.main(["--device=cpu", f"--f={lvae_cfg}"]) == 0
    return dict(root=root, data=data, results=results, cfg=lvae_cfg)


def test_cli_reference_workflow_writes_every_artefact(trained):
    results = trained["results"]
    for artefact in ("model_params_vae.ckpt", "model_best.ckpt", "model_final.ckpt",
                     "model_last.ckpt", "result_error.csv", "result_error_best.csv",
                     "recon_complete.npz", "recon_complete_best.npz", "plot_values.pkl",
                     "diagnostics.pkl", "metrics.jsonl"):
        assert os.path.exists(results / artefact), artefact
    errs = np.loadtxt(results / "result_error.csv")
    assert errs.shape == (2,) and np.isfinite(errs).all()
    hist = pickle.load(open(results / "diagnostics.pkl", "rb"))
    assert len(hist) == 2 and all(np.isfinite(list(m.values())).all() for m in hist)
    recs = [json.loads(line) for line in open(results / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2] and set(recs[0]) >= {"t", "net", "kld"}
    labels, mu, log_var, z_sample, idx = pickle.load(open(results / "plot_values.pkl", "rb"))
    assert mu.shape == log_var.shape == z_sample.shape == (40, 2) and idx.shape == (40,)
    grid = np.load(results / "recon_complete.npz")
    assert grid["grid"].shape == (3, 20, 36, 36) and grid["filled"].sum() == 60
    final = ck.read_checkpoint(str(results / "model_final.ckpt"))
    assert final["kind"] == "hensman" and final["step"] == 2 * 2  # 2 epochs of 2 batches
    best = ck.read_checkpoint(str(results / "model_best.ckpt"))
    assert best["metadata"]["epoch"] in (1, 2) and np.isfinite(best["metadata"]["val"])


def test_resume_from_gp_model_folder(trained, capsys):
    cfg, _ = parse_flag_lines([f"--f={trained['cfg']}",
                               f"--gp_model_folder={trained['results']}"])
    pipe = LVAEPipeline(cfg, device="cpu")
    trainer = pipe.build_trainer()
    assert "Loaded GP models (resumed from" in capsys.readouterr().out
    final = ck.read_checkpoint(str(trained["results"] / "model_final.ckpt"))
    assert trainer.state.step == final["step"]
    torch.testing.assert_close(trainer.state.H_nat, final["H_nat"], rtol=0, atol=0)
    torch.testing.assert_close(trainer.state.trainables.gp.kp0.raw_scale,
                               final["gp"]["kp0.raw_scale"], rtol=0, atol=0)
    for name, p in trainer.model.state_dict().items():
        torch.testing.assert_close(p, final["vae"][name], rtol=0, atol=0)
    assert trainer.state.rng.get_state().equal(final["rng"])


def test_from_checkpoint_and_from_pipeline_serve_the_same_model(trained):
    cfg, _ = parse_flag_lines([f"--f={trained['cfg']}", "--gp_model_folder="])
    path = str(trained["results"] / "model_final.ckpt")
    served = LVAEPredictor.from_checkpoint(path, cfg, device="cpu")
    pipe = LVAEPipeline(cfg, device="cpu")
    trainer = pipe.build_trainer()
    trainer.state = ck.load_checkpoint(path, like=trainer.state)
    direct = LVAEPredictor.from_pipeline(pipe)
    ds = pipe.dataset
    obs, lab = ds.data[:5], ds.labels[:5]
    query = ds.labels[5:10].copy()
    query[:, 2] = 99  # a new subject
    lab = lab.copy()
    lab[:, 2] = 99
    a = served.predict_trajectory(obs, lab, query)
    b = direct.predict_trajectory(obs, lab, query)
    assert a.shape == (5, 36, 36, 1) and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)
    # the predictor is a copy: training on does not change it
    before = direct.encode(obs)
    pipe.trainer.run_epoch()
    np.testing.assert_array_equal(direct.encode(obs), before)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """2 subjects × 5 frames, every split the same cohort."""
    root = tmp_path_factory.mktemp("small")
    thm.generate_healthmnist(1, 1, num_timepoints=5, seed=1, destination=str(root / "data"))
    return root


def small_cfg(root, results, *extra):
    cfg, unknown = parse_flag_lines(data_flags(root / "data", results) + MODEL_FLAGS +
                                    ["--T=5", "--epochs=1", "--gp_model_folder=",
                                     "--model_params="] + list(extra))
    assert not unknown
    return cfg


def test_standard_regime_closed_kl_with_exact_tests(small):
    results = small / "std"
    cfg = small_cfg(small, results, "--hensman=False", "--type_KL=closed", "--epochs=2",
                    "--test_freq=1", *EVAL_FLAGS)
    result = LVAEPipeline(cfg, device="cpu").run()
    assert np.isfinite(np.asarray(result)).all()
    for name in ("model_final.ckpt", "model_best.ckpt", "result_error.csv",
                 "result_error_best.csv", "recon_complete.npz"):
        assert (results / name).exists(), name
    assert ck.read_checkpoint(str(results / "model_final.ckpt"))["kind"] == "standard"


def test_profile_writes_a_chrome_trace(small, capsys):
    """The trace holds the program's spans and the eager steps' phases; a
    line beside its path gives each span's total (no phase is timed on the
    CPU, which captures nothing)."""
    results = small / "profiled"
    cfg = small_cfg(small, results, *HENSMAN_FLAGS, "--profile=True", "--test_freq=0")
    pipe = LVAEPipeline(cfg, device="cpu")
    pipe.train()
    trace = json.load(open(results / "profile" / "trace.json"))
    assert trace["traceEvents"]
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"lvae.train.draws", "lvae.train.dispatch", "lvae.train.read", "lvae.train.callback",
            "lvae.pipeline.log", *metrics.PHASES} <= names
    line = next(x for x in capsys.readouterr().out.splitlines() if x.startswith("Profile phases"))
    assert "not marked" in line and "lvae.train.draws" in line and "lvae.pipeline.log" in line


def test_auto_recover_rolls_back_a_non_finite_chunk(small, capsys):
    cfg = small_cfg(small, small / "recover", *HENSMAN_FLAGS, "--auto_recover=True",
                    "--epochs=3", "--checkpoint_every=1", "--test_freq=0")
    pipe = LVAEPipeline(cfg, device="cpu")
    trainer = pipe.build_trainer()
    real = trainer.run_epochs
    poisoned = []

    def run_epochs(n):
        out = real(n)
        if len(trainer.history) == 2 and not poisoned:  # the second epoch goes bad once
            poisoned.append(True)
            with torch.no_grad():
                trainer.state.trainables.gp.kp0.raw_scale.fill_(float("nan"))
        return out

    trainer.run_epochs = run_epochs
    pipe.train()
    out = capsys.readouterr().out
    assert "Recovered from non-finite state at epoch 2 (attempt 1" in out
    assert len(trainer.history) == 3 and pipe.recoveries == 1
    assert bool(torch.isfinite(trainer.state.trainables.gp.kp0.raw_scale).all())
    pipe.metrics.flush()
    steps = [json.loads(line)["step"] for line in open(small / "recover" / "metrics.jsonl")]
    assert steps == [1, 2, 3]


def test_checkpoint_round_trip_continues_the_run(small, tmp_path):
    """A state saved and restored into a fresh trainer (through
    ``map_location='cpu'``) continues exactly as the uninterrupted run."""
    cfg = small_cfg(small, tmp_path, *HENSMAN_FLAGS, "--natural_gradient=False")
    a = LVAEPipeline(cfg, device="cpu").build_trainer()
    a.run_epoch()
    path = ck.save_checkpoint(str(tmp_path / "s.ckpt"), a.state, metadata={"epoch": 1})
    b = LVAEPipeline(cfg, device="cpu").build_trainer()
    b.state = ck.load_checkpoint(path, like=b.state)
    assert ck.read_checkpoint(path)["metadata"] == {"epoch": 1}
    assert b.state.step == a.state.step
    ma, mb = a.run_epoch(), b.run_epoch()
    assert ma == mb
    for pa, pb in zip(a.state.trainables.parameters(), b.state.trainables.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
    assert not os.path.exists(path + ".tmp")
    with pytest.raises(ValueError, match="does not restore"):
        ck.load_checkpoint(path, like=LVAEPipeline(
            small_cfg(small, tmp_path, "--hensman=False"), device="cpu").build_trainer().state)


def test_reference_pth_seeds_the_vae(small, tmp_path, capsys):
    model = make_vae("conv", 2, 1296, generator=torch.Generator().manual_seed(5))
    sd = {("_log_vy" if k == "raw_log_vy" else k): v for k, v in model.state_dict().items()}
    torch.save(sd, tmp_path / "model_params.pth")
    cfg = small_cfg(small, tmp_path, *HENSMAN_FLAGS,
                    f"--model_params={tmp_path / 'model_params.pth'}")
    pipe = LVAEPipeline(cfg, device="cpu")
    pipe.build_trainer()
    assert "Loaded pre-trained values." in capsys.readouterr().out
    for name, p in pipe.model.state_dict().items():
        torch.testing.assert_close(p, model.state_dict()[name], rtol=0, atol=0)


@pytest.mark.parametrize("flag,error,match", [
    ("--dtype=bfloat16", NotImplementedError, "item 13"),
    # a mesh needs as many processes as ranks: one process is a world of 1
    ("--data_mesh=2", ValueError, "world size is 1"),
    # every backend of the JAX package runs; another name is refused
    ("--checkpoint_backend=tensorstore", AssertionError, ""),
])
def test_waiting_configurations_raise(small, tmp_path, flag, error, match):
    with pytest.raises(error, match=match or None):
        LVAEPipeline(small_cfg(small, tmp_path, flag), device="cpu")


def test_vi_regime_raises(small, tmp_path, monkeypatch):
    """The VI regime no longer raises: ``run()`` routes it to ``run_vi``,
    which writes ``model_vi.ckpt`` (and the prediction set's checkpoint);
    ``build_trainer`` refuses it, as in JAX."""
    pipe = LVAEPipeline(small_cfg(small, tmp_path, "--variational_inference_training=True",
                                  "--hensman=False", "--epochs=2"), device="cpu")
    routed = []
    real = LVAEPipeline.run_vi
    monkeypatch.setattr(LVAEPipeline, "run_vi",
                        lambda self: routed.append(True) or real(self, pred_epochs=2))
    assert pipe.run() is None and routed == [True]
    state = ck.read_checkpoint(str(tmp_path / "model_vi.ckpt"))
    assert state["kind"] == "vi" and state["mu"].shape == (10, 2)
    assert len(pipe.trainer.history) == 2 and len(pipe.trainer.pred_history) == 2
    pred = ck.read_checkpoint(str(tmp_path / "vi_prediction.ckpt"))
    assert pred["mu_pred"].shape == (10, 2)
    with pytest.raises(RuntimeError, match="run_vi"):
        pipe.build_trainer()


def test_device_flag_is_split_off():
    assert cli.split_device(["--f=x", "--device=cpu"]) == ("cpu", ["--f=x"])
    assert cli.split_device(["pretrain", "--device=cpu", "--f=x"]) == (
        "cpu", ["pretrain", "--f=x"])
    assert cli.split_device(["--f=x"]) == ("cuda", ["--f=x"])


def test_cuda_is_the_default_device(small, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LVAEPipeline(small_cfg(small, tmp_path, *HENSMAN_FLAGS))


def test_debug_guards(small, tmp_path, monkeypatch):
    pipe = LVAEPipeline(small_cfg(small, tmp_path, *HENSMAN_FLAGS), device="cpu")
    trainer = pipe.build_trainer()
    tr = trainer.state.trainables
    assert_state_finite(tr)
    with torch.no_grad():
        tr.gp.raw_noise[0] = float("inf")
    with pytest.raises(FloatingPointError, match="gp.raw_noise"):
        assert_state_finite(tr, where="epoch 3")
    xb = torch.tensor(pipe.dataset.labels, dtype=torch.float32).reshape(2, 5, -1)
    for b_chain in (True, False):  # the K1 route (no B, LB) and the plain route
        monkeypatch.setattr("lvae_torch.ops.kernels.use_b_chain_kernel", b_chain)
        with torch.no_grad():
            ops = teb.gp_block_operators(pipe.spec0, pipe.spec1, tr.gp.kp0, tr.gp.kp1,
                                         torch.ones(2), xb, trainer.tdata.z, eps=1e-5)
        health = gp_health(ops)
        assert bool(health["finite_iK0zz"])
        assert ("finite_iB" in health) == b_chain and ("min_LB_pivot" in health) != b_chain


def test_metrics_helpers(tmp_path, monkeypatch):
    """``device_memory_stats``, and the span recorder's count and total per
    name (kept only while the profiler runs) and its summary."""
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}
    rec = metrics.Recorder()
    monkeypatch.setattr(metrics, "RECORDER", rec)
    with metrics.span("test.off"):
        pass
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):
            with metrics.span("test.a"):
                with metrics.span("test.b"):
                    pass
    assert dict(rec.counts) == {"test.a": 3, "test.b": 3}
    assert rec.total_ns["test.a"] >= rec.total_ns["test.b"] > 0
    rec.samples.append(metrics.PhaseSample("g", 5, {"update": 2.0}))
    rec.samples.append(metrics.PhaseSample("g", 6, {"update": 4.0}))
    summary = rec.summary()
    assert summary["phase_ms"] == {"update": 3.0}
    assert summary["spans"]["test.a"]["count"] == 3
    assert summary["spans"]["test.a"]["total_s"] == pytest.approx(rec.total_ns["test.a"] * 1e-9)
    assert rec.summary(since_ns=6)["phase_ms"] == {"update": 4.0}

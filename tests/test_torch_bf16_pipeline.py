"""The reference-format CLI pipeline with bf16 VAE compute
(``--model_dtype=bfloat16``), on the CPU with ``--device=cpu``.

Through ``lvae_torch.cli.main``: the Hensman regime with validation, tests
and generation, then a run resumed from its checkpoint; the GPPVAE
pseudo-minibatch regime; the VI regime (its 1000 phase-2 steps); the RNN
encoder. Each writes its artefacts with finite losses, and its model
computes in bf16 over f32 parameters. ``model_dtype=''`` resolves through
``models/vae.auto_model_dtype`` as lvae_tpu's pipeline does, and serving
packages the pipeline's bf16 model as it is. The GP dtype ``--dtype=
bfloat16`` still raises (``tests/test_torch_pipeline.py``).

Tiny sizes: 2 subjects x 20 frames from the CLI generator, L = 2, M = 4,
1-2 epochs.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from lvae_torch import cli
from lvae_torch.config import parse_flag_lines
from lvae_torch.inference import LVAEPredictor
from lvae_torch.models import vae as tv
from lvae_torch.pipeline import LVAEPipeline
from lvae_torch.utils import checkpoint as ck
from tests.test_torch_pipeline import EVAL_FLAGS, HENSMAN_FLAGS, MODEL_FLAGS, data_flags, write

BF16 = ["--model_dtype=bfloat16"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("bf16")
    assert cli.main(["--device=cpu", "generate", f"--destination={root / 'data'}",
                     "--num_3=1", "--num_6=1", "--seed=0"]) == 0
    return root / "data"


def run_cli(data, results, *flags, name="lvae.txt"):
    """``cli.main`` on a flag file of the data's splits and ``flags``;
    returns the flag file."""
    cfg = write(results.parent / name, data_flags(data, results) + MODEL_FLAGS
                + ["--T=20", "--gp_model_folder="] + list(flags))
    assert cli.main(["--device=cpu", f"--f={cfg}"]) == 0
    return cfg


def finite_history(results, epochs):
    hist = pickle.load(open(results / "diagnostics.pkl", "rb"))
    assert len(hist) == epochs and all(np.isfinite(list(m.values())).all() for m in hist)
    return hist


def test_cli_hensman_bf16_writes_every_artefact_and_resumes(data, tmp_path):
    results = tmp_path / "results"
    cfg = run_cli(data, results, *HENSMAN_FLAGS, *EVAL_FLAGS, *BF16, "--epochs=2",
                  "--test_freq=1", "--checkpoint_every=1")
    for artefact in ("model_best.ckpt", "model_final.ckpt", "result_error.csv",
                     "recon_complete.npz", "plot_values.pkl", "gp_model.pth", "H.pth"):
        assert os.path.exists(results / artefact), artefact
    finite_history(results, 2)
    assert np.isfinite(np.loadtxt(results / "result_error.csv")).all()
    _, mu, log_var, _, _ = pickle.load(open(results / "plot_values.pkl", "rb"))
    assert mu.dtype == log_var.dtype == np.float32 and np.isfinite(mu).all()
    final = ck.read_checkpoint(str(results / "model_final.ckpt"))
    assert all(v.dtype == torch.float32 for v in final["vae"].values())  # f32 parameters

    # resume through the pipeline: a bf16-compute model carrying the f32 state
    lines = open(cfg).read().splitlines()
    lines = [x for x in lines if not x.startswith(("--gp_model_folder", "--epochs"))]
    lines += [f"--gp_model_folder={results}", "--epochs=1", f"--save_path={tmp_path / 'r2'}",
              f"--results_path={tmp_path / 'r2'}"]
    cfg2, _ = parse_flag_lines(lines)
    pipe = LVAEPipeline(cfg2, device="cpu")
    trainer = pipe.build_trainer()
    assert pipe.model.compute_dtype == torch.bfloat16
    for name, p in trainer.state.trainables.vae.state_dict().items():
        assert p.dtype == torch.float32
        torch.testing.assert_close(p, final["vae"][name], rtol=0, atol=0)
    assert trainer.state.step == final["step"]
    pipe.train()
    assert trainer.state.step == final["step"] + trainer.steps_per_epoch
    assert np.isfinite(trainer.history[-1].net)

    # serving packages the pipeline's bf16 model as it is
    pred = LVAEPredictor.from_pipeline(pipe)
    assert pred.model.compute_dtype == torch.bfloat16
    frames = np.asarray(pipe.dataset.data[:20])
    out = pred.aot_compile(batch_size=8, t_obs=20, n_query=3).predict_trajectory(
        frames, pipe.dataset.labels[:20], pipe.dataset.labels[:3])
    assert out.dtype == np.float32 and out.shape == (3, 36, 36, 1) and np.isfinite(out).all()


def test_cli_gppvae_bf16(data, tmp_path):
    results = tmp_path / "results"
    run_cli(data, results, *BF16, "--hensman=False", "--mini_batch=True",
            "--type_KL=GPapprox_closed", "--epochs=2", "--run_tests=True",
            "--generate_images=False")
    finite_history(results, 2)
    assert np.isfinite(np.loadtxt(results / "result_error.csv")).all()


def test_cli_vi_bf16(data, tmp_path):
    results = tmp_path / "results"
    run_cli(data, results, *BF16, "--hensman=False", "--variational_inference_training=True",
            "--epochs=2", "--generate_images=True")
    state = ck.read_checkpoint(str(results / "model_vi.ckpt"))
    assert state["mu"].dtype == torch.float32 and torch.isfinite(state["mu"]).all()
    assert all(v.dtype == torch.float32 for v in state["vae"].values())
    pred = ck.read_checkpoint(str(results / "vi_prediction.ckpt"))
    assert np.isfinite(pred["mu_pred"].numpy()).all()
    assert np.isfinite(np.load(results / "recon_complete_best.npz")["grid"]).all()


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_cli_rnn_bf16(data, tmp_path, cell):
    results = tmp_path / "results"
    run_cli(data, results, *HENSMAN_FLAGS, *BF16, "--type_nnet=rnn", f"--type_rnn={cell}",
            "--hidden_dim=8", "--epochs=2", "--run_tests=True", "--generate_images=False")
    finite_history(results, 2)
    recs = [json.loads(line) for line in open(results / "metrics.jsonl")]
    assert [r["step"] for r in recs] == [1, 2]


def test_model_dtype_resolution(data, tmp_path, monkeypatch):
    """As tests/test_review_fixes.py holds lvae_tpu's pipeline: an explicit
    model_dtype pins the compute dtype both ways; '' follows the switch."""
    def model_of(*flags):
        lines = data_flags(data, tmp_path) + MODEL_FLAGS + HENSMAN_FLAGS + ["--T=20"]
        cfg, _ = parse_flag_lines(lines + list(flags))
        return LVAEPipeline(cfg, device="cpu").model

    monkeypatch.setattr(tv, "use_bf16_model", True)
    assert model_of("--model_dtype=float32").compute_dtype is None
    assert model_of().compute_dtype == torch.bfloat16
    assert model_of("--dtype=float64").compute_dtype is None  # never for an f64 GP dtype
    monkeypatch.setattr(tv, "use_bf16_model", False)
    model = model_of("--model_dtype=bfloat16")
    assert model.compute_dtype == torch.bfloat16 and model.fc1.weight.dtype == torch.float32
    assert model_of().compute_dtype is None

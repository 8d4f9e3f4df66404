"""The port's reference-format CLI and pipeline on a mesh
(``--data_mesh=2``), on the CPU over 2 gloo ranks, against one process.

The world (``tests/torch_parallel_worker.world_pipeline``) runs
``lvae_torch.cli.main`` with ``--data_mesh=2`` on the files of the port's
generator (4 subjects x 20 frames, ConvVAE, L=2, M=4, 2 subjects a batch,
2 Hensman epochs with validation, tests and generation every epoch, in
float64), while this process runs the same CLI without the flag. Rank 0
writes the files: ``metrics.jsonl`` (without its clock column),
``result_error*.csv`` and ``model_final.ckpt`` must match one process's
within 1e-6 relative (Adam's division by √v̂ magnifies the last digits of
near-zero gradients, as in ``tests/test_torch_hensman.py``). Then the
world serves the final model through ``LVAEPredictor.from_checkpoint``,
whose mesh-parallel posterior must equal its one-process recompute within
1e-6 (the predictor runs in float32), and builds the sharded standard and
VI trainers through the pipeline.
"""

import json
import os

import numpy as np
import pytest

from lvae_torch import cli
from lvae_torch.utils import checkpoint as ck
from tests import torch_parallel_worker as w
from tests.test_torch_pipeline import EVAL_FLAGS, HENSMAN_FLAGS, MODEL_FLAGS, data_flags, write


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_cli")
    data = root / "data"
    assert cli.main(["--device=cpu", "generate", f"--destination={data}", "--num_3=2",
                     "--num_6=2", "--seed=0"]) == 0
    hensman = [f for f in HENSMAN_FLAGS if not f.startswith("--subjects_per_batch")]
    flags = write(root / "lvae.txt", data_flags(data, root / "single") + MODEL_FLAGS + hensman
                  + EVAL_FLAGS + ["--subjects_per_batch=2", "--T=20", "--epochs=2",
                                  "--test_freq=1", "--checkpoint_every=1", "--dtype=float64",
                                  "--gp_model_folder="])
    mesh_dir = root / "mesh"
    ctx = w.launch(2, "world_pipeline", (flags, str(mesh_dir), str(root / "routes")),
                   str(root / "world"))
    assert cli.main(["--device=cpu", f"--f={flags}"]) == 0
    ranks = w.collect(ctx, str(root / "world"))
    return root / "single", mesh_dir, ranks


def test_mesh_cli_runs_on_every_rank(runs):
    _, _, ranks = runs
    assert [r["cli_rc"] for r in ranks] == [0, 0]


def metrics(path):
    return [{k: v for k, v in json.loads(line).items() if k != "t"} for line in open(path)]


def test_mesh_cli_writes_the_metrics_of_one_process(runs):
    single, mesh, _ = runs
    a, b = metrics(mesh / "metrics.jsonl"), metrics(single / "metrics.jsonl")
    assert [r["step"] for r in a] == [r["step"] for r in b] == [1, 2]
    for ra, rb in zip(a, b):
        np.testing.assert_allclose([ra[k] for k in sorted(rb)], [rb[k] for k in sorted(rb)],
                                   rtol=1e-6)


@pytest.mark.parametrize("name", ["result_error.csv", "result_error_best.csv"])
def test_mesh_cli_writes_the_test_errors_of_one_process(runs, name):
    single, mesh, _ = runs
    np.testing.assert_allclose(np.loadtxt(mesh / name), np.loadtxt(single / name), rtol=1e-6)


def test_mesh_cli_checkpoint_is_the_whole_state_of_one_process(runs):
    single, mesh, _ = runs
    a = ck.read_checkpoint(str(mesh / "model_final.ckpt"))
    b = ck.read_checkpoint(str(single / "model_final.ckpt"))
    assert a["kind"] == b["kind"] == "hensman" and a["step"] == b["step"] == 4
    assert a["rng"].equal(b["rng"])
    for key in ("m_nat", "H_nat"):
        np.testing.assert_allclose(a[key].numpy(), b[key].numpy(), rtol=1e-6, atol=1e-9)
    for group in ("vae", "gp"):
        assert set(a[group]) == set(b[group])
        for name in b[group]:
            np.testing.assert_allclose(a[group][name].numpy(), b[group][name].numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=name)


def test_only_rank_zero_wrote_and_every_artefact_exists(runs):
    single, mesh, _ = runs
    for artefact in ("model_best.ckpt", "model_final.ckpt", "model_last.ckpt",
                     "recon_complete.npz", "plot_values.pkl", "diagnostics.pkl",
                     "gp_model.pth", "m.pth", "H.pth"):
        assert os.path.exists(mesh / artefact), artefact
    assert sorted(os.listdir(mesh)) == sorted(os.listdir(single))


def test_predictor_of_a_mesh_pipeline_runs_mesh_parallel(runs):
    _, _, ranks = runs
    for r in ranks:
        assert r["predictor_mesh"].startswith("Mesh(data=2, latent=1")
        assert np.isfinite(r["predict_mesh"]).all()
        np.testing.assert_allclose(r["predict_mesh"], r["predict_single"], rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(ranks[0]["predict_mesh"], ranks[1]["predict_mesh"])


@pytest.mark.parametrize("route,trainer", [("standard", "ShardedStandardTrainer"),
                                           ("vi", "ShardedVITrainer")])
def test_pipeline_builds_the_sharded_trainer(runs, route, trainer):
    _, _, ranks = runs
    for r in ranks:
        assert r[route]["trainer"] == trainer
        assert np.isfinite(r[route]["last_net"])
    assert ranks[0][route]["last_net"] == ranks[1][route]["last_net"]

"""The port's checkpoint backends (lvae_torch/utils/checkpoint.py), on the CPU
in float64: ``pickle`` (one file), ``orbax`` (a directory committed in one
step) and ``orbax_async`` (the same directory written by a background
thread).

* A round trip through each backend of a Hensman state (with and without
  natural gradients), a standard state (torch's Adam, and the fused Adam's
  flat moments), a VI state and the VI prediction set: each restored
  bit-equal into a fresh state.
* A file and a directory of one state restore to the same tensors; a
  directory replaces a file at its path and a file a directory.
* The background save: its snapshot is taken at the call (a change made in
  place after it is not saved); a second save waits for the first; a
  failure in the writer is raised by ``wait_for_async_saves()`` or by the
  next save and leaves the earlier checkpoint at the path, loadable, with
  no temporary directory beside it.
* The CLI under each backend, and a resume from each form into a run of
  another backend (the resumed run reaches the step of the two runs
  together).

Tiny sizes: 2 subjects × 4 frames, L = 2, M = 4, one epoch.
"""

import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch

from lvae_torch import cli
from lvae_torch.config import parse_flag_lines
from lvae_torch.data import healthmnist as thm
from lvae_torch.pipeline import LVAEPipeline
from lvae_torch.utils import checkpoint as ck

BACKENDS = ("pickle", "orbax", "orbax_async")
KINDS = ("hensman_natural", "hensman_plain", "standard_adam", "standard_fused", "vi",
         "vi_prediction")
FLAGS = ["--dataset_type=HealthMNIST", "--csv_file_data=health_MNIST_data_masked.csv",
         "--csv_file_label=health_MNIST_label.csv", "--mask_file=mask.csv",
         "--csv_file_prediction_data=health_MNIST_data_masked.csv",
         "--csv_file_prediction_label=health_MNIST_label.csv",
         "--prediction_mask_file=mask.csv", "--type_nnet=conv", "--latent_dim=2",
         "--num_dim=1296", "--dropout=0", "--id_covariate=2", "--M=4", "--weight=0.15",
         "--cat_kernel=[2]", "--sqexp_kernel=[0]",
         "--cat_int_kernel=[{'cont_covariate':0, 'cat_covariate':2}]",
         "--constrain_scales=True", "--subjects_per_batch=1", "--loss_function=mse",
         "--T=4", "--dtype=float64", "--gp_model_folder=", "--model_params="]
KIND_FLAGS = {
    "hensman_natural": ["--hensman=True", "--natural_gradient=True",
                        "--type_KL=GPapprox_closed"],
    "hensman_plain": ["--hensman=True", "--natural_gradient=False",
                      "--type_KL=GPapprox_closed"],
    "standard_adam": ["--hensman=False", "--type_KL=closed"],
    "standard_fused": ["--hensman=False", "--type_KL=closed"],
    "vi": ["--hensman=False", "--variational_inference_training=True"],
}


def save(backend, path, state, metadata=None):
    """Write through ``backend``; a background save is waited for."""
    if backend == "orbax_async":
        ck.save_checkpoint_async(path, state, metadata=metadata)
        ck.wait_for_async_saves()
    elif backend == "orbax":
        ck.save_checkpoint_dir(path, state, metadata=metadata)
    else:
        ck.save_checkpoint(path, state, metadata=metadata)
    return path


def assert_same(got, want, where="payload"):
    """Two checkpoint dicts (or parts of them) hold the same bits."""
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor) and got.dtype == want.dtype, where
        assert got.shape == want.shape and torch.equal(got, want), where
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and np.array_equal(got.view(np.uint8),
                                                          want.view(np.uint8)), where
    elif isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    else:
        assert got == want, where


def checkpoints_in(folder):
    """The checkpoints in ``folder``, after checking that nothing else was
    left there (a directory checkpoint's snapshot sits beside it, hidden)."""
    assert ck.leftovers(str(folder)) == []
    return sorted(n for n in os.listdir(folder) if not n.startswith("."))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpt")
    thm.generate_healthmnist(1, 1, num_timepoints=4, seed=3, destination=str(root / "data"))
    return root


def config(root, kind, *extra):
    cfg, _ = parse_flag_lines([f"--data_source_path={root / 'data'}",
                               f"--save_path={root / kind}", f"--results_path={root / kind}",
                               *FLAGS, *KIND_FLAGS[kind], *extra])
    return cfg


def make_state(root, kind, monkeypatch, train=True):
    """The live state of ``kind`` after one epoch (or fresh), on the CPU."""
    if kind == "vi_prediction":
        rng = np.random.default_rng(1 if train else 2)
        return {"mu_pred": rng.normal(size=(10, 2)), "log_var_pred": rng.normal(size=(10, 2))}
    monkeypatch.setenv("LVAE_OPT", "fused" if kind == "standard_fused" else "adam")
    pipe = LVAEPipeline(config(root, kind, "--epochs=1"), device="cpu")
    if kind == "vi":
        trainer = pipe.build_vi_trainer()
        if train:
            trainer.fit(1, log_every=0)
    else:
        trainer = pipe.build_trainer()
        if train:
            trainer.run_epoch()
    return trainer.state


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("backend", BACKENDS)
def test_round_trip_through_each_backend(data, tmp_path, monkeypatch, backend, kind):
    state = make_state(data, kind, monkeypatch)
    want = ck.state_payload(state)
    path = save(backend, str(tmp_path / "s.ckpt"), state, metadata={"epoch": 1})
    assert os.path.isdir(path) == (backend != "pickle")
    assert ck.read_checkpoint(path)["metadata"] == {"epoch": 1}
    fresh = make_state(data, kind, monkeypatch, train=False)
    restored = ck.load_checkpoint(path, like=fresh)
    if kind == "vi_prediction":
        assert_same(restored, state)
        return
    assert restored is fresh or restored.opt_state is fresh.opt_state  # restored in place
    assert_same(ck.state_payload(restored), want)
    if kind == "standard_fused":
        assert type(restored.opt_state).__name__ == "FusedAdam"
    assert checkpoints_in(tmp_path) == ["s.ckpt"]


def test_file_and_directory_restore_the_same_tensors(data, tmp_path, monkeypatch):
    state = make_state(data, "hensman_natural", monkeypatch)
    as_file = save("pickle", str(tmp_path / "f.ckpt"), state, {"epoch": 3})
    as_dir = save("orbax", str(tmp_path / "d.ckpt"), state, {"epoch": 3})
    assert_same(ck.read_checkpoint(as_dir), ck.read_checkpoint(as_file))
    a = ck.load_checkpoint(as_file, like=make_state(data, "hensman_natural", monkeypatch, False))
    b = ck.load_checkpoint(as_dir, like=make_state(data, "hensman_natural", monkeypatch, False))
    assert_same(ck.state_payload(a), ck.state_payload(b))
    assert sorted(os.listdir(as_dir)) == [ck.META_FILE, ck.STATE_FILE]


@pytest.mark.parametrize("first,second", [("orbax", "pickle"), ("pickle", "orbax_async"),
                                          ("foreign directory", "orbax")])
def test_a_checkpoint_replaces_the_other_form_at_its_path(data, tmp_path, monkeypatch,
                                                          first, second):
    """A directory replaces a file at its path, a file a directory, and a
    directory the module did not write (a copy) is replaced too; the
    snapshot the path held before is removed."""
    state = make_state(data, "hensman_natural", monkeypatch)
    path = str(tmp_path / "s.ckpt")
    if first == "foreign directory":
        shutil.copytree(save("orbax", str(tmp_path.parent / f"{tmp_path.name}_x.ckpt"), state),
                        path)
    else:
        save(first, path, state, {"epoch": 1})
    state.H_nat.add_(1.0)
    save(second, path, state, {"epoch": 2})
    assert os.path.isdir(path) == (second != "pickle")
    got = ck.read_checkpoint(path)
    assert got["metadata"] == {"epoch": 2} and torch.equal(got["H_nat"], state.H_nat)
    assert checkpoints_in(tmp_path) == ["s.ckpt"]


def test_async_snapshot_is_taken_at_the_call(data, tmp_path, monkeypatch):
    state = make_state(data, "hensman_natural", monkeypatch)
    want = ck.state_payload(state)
    gate = threading.Event()
    real = ck._write_dir

    def held(*args):
        assert gate.wait(30)
        real(*args)

    monkeypatch.setattr(ck, "_write_dir", held)
    path = ck.save_checkpoint_async(str(tmp_path / "s.ckpt"), state, {"epoch": 1})
    with torch.no_grad():  # the next steps update the state in place
        for p in state.trainables.parameters():
            p.add_(1.0)
        state.m_nat.add_(1.0)
    state.rng.manual_seed(99)
    gate.set()
    ck.wait_for_async_saves()
    got = ck.read_checkpoint(path)
    got.pop("format"), got.pop("version"), got.pop("metadata")
    assert_same(got, want)
    assert not torch.equal(got["m_nat"], state.m_nat)


def test_back_to_back_saves_wait_for_each_other(data, tmp_path, monkeypatch):
    state = make_state(data, "hensman_natural", monkeypatch)
    events = []
    real = ck._write_dir

    def slow(path, payload, meta):
        events.append(("start", os.path.basename(path)))
        time.sleep(0.2)
        real(path, payload, meta)
        events.append(("end", os.path.basename(path)))

    monkeypatch.setattr(ck, "_write_dir", slow)
    ck.save_checkpoint_async(str(tmp_path / "a.ckpt"), state)
    ck.save_checkpoint_async(str(tmp_path / "b.ckpt"), state)
    assert events[:2] == [("start", "a.ckpt"), ("end", "a.ckpt")]
    ck.wait_for_async_saves()
    assert events == [("start", "a.ckpt"), ("end", "a.ckpt"), ("start", "b.ckpt"),
                      ("end", "b.ckpt")]
    assert_same(ck.read_checkpoint(str(tmp_path / "a.ckpt"))["H_nat"], state.H_nat)


@pytest.mark.parametrize("raised_by", ["wait", "next save"])
def test_writer_failure_is_raised_and_keeps_the_earlier_checkpoint(data, tmp_path, monkeypatch,
                                                                   raised_by):
    state = make_state(data, "hensman_natural", monkeypatch)
    path = str(tmp_path / "s.ckpt")
    save("orbax_async", path, state, {"epoch": 1})
    before = ck.read_checkpoint(path)

    def refuse(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", refuse)
    ck.save_checkpoint_async(path, state, {"epoch": 2})
    with pytest.raises(OSError, match="disk full"):
        if raised_by == "wait":
            ck.wait_for_async_saves()
        else:
            ck.save_checkpoint_async(str(tmp_path / "other.ckpt"), state, {"epoch": 3})
    monkeypatch.undo()
    ck.wait_for_async_saves()  # raised once: nothing is left in flight or kept
    assert checkpoints_in(tmp_path) == ["s.ckpt"]
    assert_same(ck.read_checkpoint(path), before)
    fresh = make_state(data, "hensman_natural", monkeypatch, train=False)
    assert ck.load_checkpoint(path, like=fresh).step == state.step


def test_a_crash_leaves_the_old_checkpoint_and_the_next_save_clears_up(data, tmp_path,
                                                                       monkeypatch):
    """What a writer killed before its commit leaves (a half-written
    snapshot directory and its link) does not change what the path holds;
    it is named by ``leftovers`` and removed by the next save of the path."""
    state = make_state(data, "hensman_natural", monkeypatch)
    path = save("orbax", str(tmp_path / "s.ckpt"), state, {"epoch": 1})
    dead = tmp_path / ".s.ckpt.snapshot-dead"
    dead.mkdir()
    (dead / ck.STATE_FILE).write_bytes(b"half")
    os.symlink(dead.name, str(dead) + ".link")
    (tmp_path / "s.ckpt.tmp").write_bytes(b"half")  # the file writer's
    assert ck.read_checkpoint(path)["metadata"] == {"epoch": 1}
    assert ck.leftovers(str(tmp_path)) == [".s.ckpt.snapshot-dead", ".s.ckpt.snapshot-dead.link",
                                           "s.ckpt.tmp"]
    save("orbax_async", path, state, {"epoch": 2})
    assert ck.leftovers(str(tmp_path)) == ["s.ckpt.tmp"]
    save("pickle", path, state, {"epoch": 3})
    assert checkpoints_in(tmp_path) == ["s.ckpt"]
    assert ck.read_checkpoint(path)["metadata"] == {"epoch": 3}


@pytest.mark.parametrize("first,second", [("orbax_async", "pickle"), ("pickle", "orbax"),
                                          ("orbax", "orbax_async")])
def test_cli_runs_each_backend_and_resumes_across_backends(data, tmp_path, first, second,
                                                           capsys):
    """A CLI run under ``first`` (auto-recover: a snapshot every epoch),
    then a run resumed from its folder under ``second``."""
    common = [f"--data_source_path={data / 'data'}", *FLAGS, *KIND_FLAGS["hensman_natural"],
              "--epochs=2", "--checkpoint_every=1", "--test_freq=0", "--auto_recover=True"]

    def run(name, backend, *extra):
        flags = tmp_path / f"{name}.txt"
        flags.write_text("\n".join(common + [f"--save_path={tmp_path / name}",
                                             f"--results_path={tmp_path / name}",
                                             f"--checkpoint_backend={backend}", *extra]) + "\n")
        assert cli.main(["--device=cpu", f"--f={flags}"]) == 0
        return tmp_path / name

    a = run("a", first)
    for name in ("model_last.ckpt", "model_final.ckpt"):
        assert os.path.isdir(a / name) == (first != "pickle"), name
    assert ck.read_checkpoint(str(a / "model_last.ckpt"))["metadata"] == {"epoch": 2}
    b = run("b", second, f"--gp_model_folder={a}")
    assert f"Loaded GP models (resumed from {a / 'model_final.ckpt'})" in capsys.readouterr().out
    assert os.path.isdir(b / "model_final.ckpt") == (second != "pickle")
    steps = [ck.read_checkpoint(str(d / "model_final.ckpt"))["step"] for d in (a, b)]
    assert steps == [4, 8]  # 2 epochs of 2 batches, then 2 more
    assert ck.leftovers(str(a)) == ck.leftovers(str(b)) == []

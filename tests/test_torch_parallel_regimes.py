"""The port's sharded standard and VI regimes (lvae_torch/parallel/mesh.py:
ShardedStandardTrainer, ShardedVITrainer) and the trainers' facade, on the
CPU over gloo ranks, against one process of the port.

One world of spawned ranks per mesh shape (``tests/torch_parallel_worker.py``)
runs 3 epochs of each standard mode on a 9-subject cohort (T=4, L=4, M=6,
float64, injected noise): at (2, 1) the trainer appends one ghost subject
to align the data axis, and the reference is one process with the same
ghost; at (1, 2) nothing is padded. The losses and the GP hyperparameters
must agree within 1e-8 relative. The (2, 1) world also runs 3 VI phase-1
steps and 4 phase-2 steps (L=3) and the facade's checks.
"""

import numpy as np
import pytest
import torch

from lvae_torch.parallel import mesh as tpm
from tests import torch_parallel_worker as w

MODES = ("closed", "GPapprox", "GPapprox_closed")
SHAPES = [(2, 1), (1, 2)]
VI_STEPS = 3


def one_process_standard(type_kl: str, ghosts: int) -> dict:
    tr = w.standard_trainer(type_kl, p=w.STANDARD_P)
    if ghosts:
        tr.tdata, tr.block_mask = tpm.pad_ghost_subjects(tr.tdata, tr.block_mask, ghosts)
    return w.standard_epochs(tr, w.standard_noise(type_kl, w.STANDARD_P + ghosts))


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    root = tmp_path_factory.mktemp("regimes")
    pred_eps = np.random.default_rng(4).normal(size=(4, 16, 3))
    vi = {"steps": VI_STEPS, "pred_eps": pred_eps}
    ctxs = {shape: (w.launch(2, "world_regimes", (shape, vi),
                             str(root / f"w{shape[0]}{shape[1]}")),
                    str(root / f"w{shape[0]}{shape[1]}"))
            for shape in SHAPES}
    refs = {(mode, ghosts): one_process_standard(mode, ghosts)
            for mode in MODES for ghosts in (0, 1)}
    refs["vi"] = w.vi_run(w.vi_trainer(), VI_STEPS, pred_eps)
    return {shape: w.collect(ctx, out) for shape, (ctx, out) in ctxs.items()}, refs


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_standard_matches_one_process(worlds, shape, mode):
    results, refs = worlds
    ghosts = 1 if shape == (2, 1) else 0
    ref = refs[(mode, ghosts)]
    for out in results[shape]:
        got = out[mode]
        assert got["subjects"] == w.STANDARD_P + ghosts
        np.testing.assert_allclose(got["epochs"], ref["epochs"], rtol=1e-8)
        for a, b in zip(got["gp"], ref["gp"]):
            np.testing.assert_allclose(a, b, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_ghost_subject_changes_nothing(worlds, mode):
    """The ghost-padded cohort trains as the cohort itself (the ghost's
    noise rows are never read)."""
    _, refs = worlds
    np.testing.assert_allclose(refs[(mode, 1)]["epochs"], refs[(mode, 0)]["epochs"], rtol=1e-8)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_ghost_padding_is_announced(worlds, shape):
    results, _ = worlds
    for out in results[shape]:
        said = out["closed"]["said"]
        if shape == (2, 1):
            assert "padding P=9 with 1 ghost subject(s) to align the 2-way data axis" in said
        else:
            assert said == ""


def test_sharded_standard_refuses_gppvae(worlds):
    results, _ = worlds
    for shape in SHAPES:
        for out in results[shape]:
            assert "mini_batch" in out["gppvae_refused"]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_vi_matches_one_process(worlds, shape):
    """3 phase-1 steps and the replicated phase 2: every rank reports one
    process's losses and returns its mu_pred. At (1, 2) the 3 latents do
    not divide the latent axis, so both ranks hold them all and only the
    first counts the GP terms."""
    results, refs = worlds
    ref = refs["vi"]
    for out in results[shape]:
        got = out["vi"]
        np.testing.assert_allclose(got["steps"], ref["steps"], rtol=1e-8)
        np.testing.assert_allclose(got["mu"], ref["mu"], rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(got["mu_pred"], ref["mu_pred"], rtol=1e-8, atol=1e-12)
        np.testing.assert_allclose(got["lv_pred"], ref["lv_pred"], rtol=1e-8, atol=1e-12)
    a, b = results[shape]
    np.testing.assert_array_equal(a["vi"]["mu_pred"], b["vi"]["mu_pred"])


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_vi_warns_where_latents_do_not_divide(worlds, shape):
    """L=3 on a 2-way latent axis is replicated with a warning; on (2, 1)
    there is no latent axis to split and no warning."""
    results, _ = worlds
    for out in results[shape]:
        said = [m for m in out["warnings"] if m.startswith("ShardedVITrainer (latent dims)")]
        if shape == (1, 2):
            assert said and "3 does not divide the 2-way 'latent' mesh axis" in said[0]
        else:
            assert not said


@pytest.mark.parametrize("check", ["callback_got_wrapper", "write_reached_inner", "no_shadow",
                                   "state_written"])
def test_facade(worlds, check):
    """fit hands the wrapper to its callback; attribute writes reach the
    inner trainer and leave no shadow; a state write goes through."""
    results, _ = worlds
    for out in results[(2, 1)]:
        assert out["facade"][check]


def test_trivial_mesh_trains_as_one_process():
    """The 1 x 1 mesh needs no process group: the sharded trainer is the
    trainer."""
    mesh = tpm.make_mesh(1, 1, device="cpu")
    noise = w.standard_noise("GPapprox_closed", 8, epochs=2)
    a = w.standard_epochs(tpm.ShardedStandardTrainer(w.standard_trainer("GPapprox_closed"), mesh),
                          noise)
    b = w.standard_epochs(w.standard_trainer("GPapprox_closed"), noise)
    np.testing.assert_array_equal(a["epochs"], b["epochs"])


def test_trainer_on_another_device_than_the_mesh_is_refused():
    mesh = tpm.make_mesh(1, 1, device="cpu")
    trainer = w.standard_trainer("closed")
    trainer.device = torch.device("meta")
    with pytest.raises(ValueError, match="the mesh rank on cpu"):
        tpm.ShardedStandardTrainer(trainer, mesh)

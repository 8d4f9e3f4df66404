"""The port's fixed-shape serving bundle (``CompiledServing``) against
lvae_tpu's, on the CPU, where its programs run eagerly (on the card each is
a replay of a captured CUDA graph: ``tests/test_torch_cuda.py``).

An RNN bundle refuses a request whose rows are not whole subjects, as JAX's
``_check_seq_rows`` does: GRU and LSTM at T=4, 5·T − 1 rows, on ``encode``
and ``impute`` (f32 models from one set of flax params; a request of whole
subjects then agrees within 1e-5 of the largest latent). A sibling made by
``for_k_subjects`` and its parent, each refreshed with new training
subjects, give JAX's answers at the serving tests' tolerances (frames at
atol 1e-6, the basis at 2e-5 of its largest entry), and a refresh of one
bundle leaves the other's answers unchanged, bit for bit, in both packages.
The basis fold and its extension run as programs (``ops/predict.fold_basis``,
``extend_basis``; on the card replays of captured graphs): on the CPU they
equal ``precompute_predict_basis`` and ``extend_predict_basis`` bit for
bit and JAX's ``_fold_basis_jit``/``_extend_basis_jit`` at the basis bound
above, and a bundle's fold and each refresh of a parent and its sibling go
through them. The world (P=6 subjects × T=5 frames, L=4, M=8, ConvVAE) is
``tests/test_torch_serving.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvae_tpu import inference as jinf
from lvae_tpu.models import rnn as jrnn
from lvae_tpu.ops import kernels as jkx
from lvae_tpu.train import state as jst
from lvae_torch import inference as tinf
from lvae_torch.evaluation import programs as tprog
from lvae_torch.ops import predict as tpr
from lvae_torch.models import vae as tv
from lvae_torch.ops import kernels as tkx
from lvae_torch.utils.convert import gp_params_from_jax, vae_state_dict_from_jax
from test_torch_serving import FRAME_ATOL, K, LATENT_RTOL, N_QUERY, T_OBS, World, cohort, rel

RNN_T, RNN_H, RNN_L, RNN_D = 4, 5, 2, 12
RNN_SPEC = dict(cat_kernel=[2], sqexp_kernel=[0],
                cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2}])


def rnn_bundles(cell):
    """(JAX bundle, port bundle) of one f32 RNN encoder (T=4) over a basis of
    3 subjects, batch 8."""
    rng = np.random.default_rng(0)
    p = 3
    labels = np.asarray([[i, 0.0, s, s % 2, 0, 1] for s in range(p) for i in range(RNN_T)],
                        np.float32)
    jmodel = jrnn.RNNVAE(latent_dim=RNN_L, num_dim=RNN_D, T=RNN_T, hidden_dim=RNN_H,
                         type_rnn=cell)
    params = jmodel.init(jax.random.key(0), jnp.zeros((RNN_T, RNN_D)))
    tmodel = tv.make_vae("rnn", RNN_L, RNN_D, T=RNN_T, hidden_dim=RNN_H, type_rnn=cell)
    tmodel.load_state_dict(vae_state_dict_from_jax(params))
    j0, j1 = jkx.split_kernel_spec(id_covariate=2, **RNN_SPEC)
    t0, t1 = tkx.split_kernel_spec(id_covariate=2, **RNN_SPEC)
    jgp = jst.init_gp_params(j0, j1, RNN_L, constrain_scales=True)
    z = labels[rng.choice(len(labels), 4, replace=False)]
    basis_mu = np.zeros((len(labels), RNN_L), np.float32)
    jpred = jinf.LVAEPredictor(
        model=jmodel, vae_params=params, gp_params=jgp, noise=jnp.ones(RNN_L), spec0=j0,
        spec1=j1, z=jnp.asarray(z), id_covariate=2, basis_labels=labels, basis_mu=basis_mu)
    tpred = tinf.LVAEPredictor(
        model=tmodel, gp_params=gp_params_from_jax(jgp), noise=torch.ones(RNN_L), spec0=t0,
        spec1=t1, z=torch.from_numpy(z), id_covariate=2, basis_labels=labels,
        basis_mu=basis_mu, device="cpu")
    return jpred.aot_compile(batch_size=8), tpred.aot_compile(batch_size=8)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_rnn_bundle_refuses_rows_that_are_not_whole_subjects(cell):
    jb, tb = rnn_bundles(cell)
    frames = np.random.default_rng(1).uniform(size=(5 * RNN_T, RNN_D)).astype(np.float32)
    for bundle in (jb, tb):
        with pytest.raises(ValueError, match="divisible"):
            bundle.encode(frames[:-1])
        with pytest.raises(ValueError, match="divisible"):
            bundle.impute(frames[:-1])
    got, want = tb.encode(frames), jb.encode(frames)  # 5 whole subjects: two padded chunks
    assert got.shape == want.shape == (5 * RNN_T, RNN_L)
    assert rel(got, want) <= 1e-5
    assert tb.impute(frames).shape == (5 * RNN_T, RNN_D)


@pytest.fixture(scope="module")
def world():
    return World()


def request(world, k):
    return world.obs_frames[:k], world.obs_labels[:k], world.query_labels[:k]


def test_sibling_and_parent_refresh_match_jax_and_leave_each_other_unchanged(world):
    jp, tp = world.jax_predictor(), world.torch_predictor()
    kw = dict(batch_size=8, t_obs=T_OBS, n_query=N_QUERY, k_subjects=K)
    jb, tb = jp.aot_compile(**kw), tp.aot_compile(**kw)
    jsib, tsib = jb.for_k_subjects(1), tb.for_k_subjects(1)
    assert tsib._basis.c is not tb._basis.c  # the sibling's own buffers
    sib_before = tsib.predict_trajectories(*request(world, 1))
    np.testing.assert_allclose(sib_before, jsib.predict_trajectories(*request(world, 1)),
                               atol=FRAME_ATOL, rtol=0)
    jsib_before = jsib.predict_trajectories(*request(world, 1))

    # the parent folds two new subjects: its answers follow JAX's, the
    # sibling's stay as they were in both packages
    jb.refresh_basis(world.refresh_frames, world.refresh_labels)
    tb.refresh_basis(world.refresh_frames, world.refresh_labels)
    assert rel(tb._basis.h_nojit, jb._basis.h_nojit) <= LATENT_RTOL
    assert rel(tb._basis.c, jb._basis.c) <= LATENT_RTOL
    np.testing.assert_allclose(tb.predict_trajectories(*request(world, K)),
                               jb.predict_trajectories(*request(world, K)),
                               atol=FRAME_ATOL, rtol=0)
    np.testing.assert_array_equal(tsib.predict_trajectories(*request(world, 1)), sib_before)
    np.testing.assert_array_equal(jsib.predict_trajectories(*request(world, 1)), jsib_before)
    assert rel(tsib._basis.c, np.asarray(jsib._basis.c)) <= LATENT_RTOL
    assert tsib.predictor.basis_labels.shape[0] == world.labels.shape[0]

    # the sibling folds two others: it follows JAX's sibling, the parent stays
    parent_before = tb.predict_trajectories(*request(world, K))
    more_frames, more_labels = cohort(np.random.default_rng(5), range(300, 302))
    jsib.refresh_basis(more_frames, more_labels)
    tsib.refresh_basis(more_frames, more_labels)
    assert rel(tsib._basis.c, jsib._basis.c) <= LATENT_RTOL
    np.testing.assert_allclose(tsib.predict_trajectories(*request(world, 1)),
                               jsib.predict_trajectories(*request(world, 1)),
                               atol=FRAME_ATOL, rtol=0)
    np.testing.assert_array_equal(tb.predict_trajectories(*request(world, K)), parent_before)

    # a sibling made after the refresh starts from the grown basis
    late = tb.for_k_subjects(K)
    np.testing.assert_array_equal(late.predict_trajectories(*request(world, K)), parent_before)
    np.testing.assert_allclose(late.predict_trajectories(*request(world, K)),
                               jb.for_k_subjects(K).predict_trajectories(*request(world, K)),
                               atol=FRAME_ATOL, rtol=0)


def test_bundle_programs_on_the_cpu_are_the_eager_programs(world):
    """On the CPU each request runs the program itself: ``_call`` and the
    eager program give the same bits, and no graph is captured."""
    tb = world.torch_predictor().aot_compile(batch_size=8, t_obs=T_OBS, n_query=N_QUERY,
                                             k_subjects=K)
    assert tb._graphs == {} and tb._graphs.pool is None
    frames = torch.from_numpy(world.frames[:8])
    with torch.inference_mode():
        for name in ("encode", "recon"):
            torch.testing.assert_close(tb._call(name, frames), tb._program(name)(frames),
                                       rtol=0, atol=0)
    got = tb.encode(world.frames[:11])  # a full chunk and a padded one
    np.testing.assert_array_equal(got[:8], tb.encode(world.frames[:8]))
    np.testing.assert_array_equal(tb.decode(got)[8:], tb.decode(got[8:]))


def blocks_of(bundle, labels, mu):
    """The bundle's device blocks of ``labels``/``mu`` and their numpy."""
    xb, mask, mu_b = bundle._blocks_on_device(labels, mu)
    return (xb, mask, mu_b), [np.asarray(t) for t in (xb, mask, mu_b)]


def test_fold_and_extension_programs_equal_the_eager_functions_and_jax(world):
    """The programs against the eager functions (the same bits) and against
    the JAX package's jitted fold and extension."""
    tp, jp = world.torch_predictor(), world.jax_predictor()
    tb = tp.aot_compile(batch_size=8)
    gp = tp.gp_params
    args = (tp.spec0, tp.spec1, gp.kp0, gp.kp1, tp.noise)
    jargs = (jp.gp_params.kp0, jp.gp_params.kp1, jp.noise)
    fold_in, fold_np = blocks_of(tb, tp.basis_labels, tp.basis_mu)
    got = tpr.fold_basis(*args, *fold_in, tp.z, eps=tp.eps)
    want = tpr.precompute_predict_basis(*args, *fold_in, tp.z, eps=tp.eps)
    jwant = jinf._fold_basis_jit(jp.spec0, jp.spec1, jp.eps)(*jargs, *fold_np, jp.z)
    mu_new = tb.encode(world.refresh_frames)
    new_in, new_np = blocks_of(tb, world.refresh_labels, mu_new)
    grown = tpr.extend_basis(*args, got, *new_in, tp.z)
    grown_want = tpr.extend_predict_basis(*args, want, *new_in, tp.z)
    jgrown = jinf._extend_basis_jit(jp.spec0, jp.spec1)(*jargs, jwant, *new_np, jp.z)
    for a, b, j in ((got, want, jwant), (grown, grown_want, jgrown)):
        for x, y, z in zip(a, b, j):
            assert x.is_contiguous() and x.shape == y.shape
            torch.testing.assert_close(x, y, rtol=0, atol=0)
            assert rel(x, z) <= LATENT_RTOL


def test_bundle_fold_and_refreshes_run_the_programs(world, monkeypatch):
    """``aot_compile`` folds through the fold program and each refresh, of
    the parent and then of its sibling, through the extension program, each
    on its own bundle's basis: every refreshed basis has the bits of the
    eager extension of that bundle's basis before it."""
    names = []
    real = tprog.run

    def recorded(name, *args, **kwargs):
        if name.endswith("_basis"):
            names.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(tprog, "run", recorded)
    tp = world.torch_predictor()
    tb = tp.aot_compile(batch_size=8, t_obs=T_OBS, n_query=N_QUERY, k_subjects=K)
    sib = tb.for_k_subjects(1)
    assert names == ["fold_basis"]
    more_frames, more_labels = cohort(np.random.default_rng(5), range(300, 302))
    for bundle, frames, labels in ((tb, world.refresh_frames, world.refresh_labels),
                                   (sib, more_frames, more_labels)):
        other = sib if bundle is tb else tb
        other_before = [t.clone() for t in other._basis]
        before = tpr.PredictBasis(*(t.clone() for t in bundle._basis))
        buffers = [t.data_ptr() for t in bundle._basis]
        bundle.refresh_basis(frames, labels)
        new_in, _ = blocks_of(bundle, labels, bundle.encode(frames))
        pr = bundle.predictor
        want = tpr.extend_predict_basis(pr.spec0, pr.spec1, pr.gp_params.kp0, pr.gp_params.kp1,
                                        pr.noise, before, *new_in, pr.z)
        for got, w in zip(bundle._basis, want):
            torch.testing.assert_close(got, w, rtol=0, atol=0)
        assert [t.data_ptr() for t in bundle._basis] == buffers  # copied into its buffers
        for got, w in zip(other._basis, other_before):
            assert torch.equal(got, w)
    assert names == ["fold_basis", "extend_basis", "extend_basis"]

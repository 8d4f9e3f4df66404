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
The world (P=6 subjects × T=5 frames, L=4, M=8, ConvVAE) is
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

"""The port's RNN encoder (lvae_torch/models/rnn.py) against lvae_tpu's, on
the CPU in float64, and the places that read its ``T``.

The flax model's parameters (every leaf redrawn from a seed, so each bias
is nonzero) go through ``utils/convert.vae_state_dict_from_jax``: the gate
order, the transposes, the zero input-side LSTM bias and the GRU's
``[0, 0, hn.bias]`` hidden-side bias. ``encode`` and ``decode`` of both
cell types, and one Hensman ``batch_loss`` value and every gradient with
``type_nnet=rnn``, match at rtol 1e-8. Then: the ragged-cohort refusal,
``encode_dataset``'s chunks of whole subjects, ``CompiledServing``'s batch
size and pre-training's subject-major batches, as in lvae_tpu; and the
reference-format CLI with ``--type_nnet=rnn`` (pre-training, Hensman,
serving) for both cells. Sizes: T=4 frames, hidden 5, L=2, M=4.

flax's cells make their initial carry in their ``param_dtype``, float32 by
default, which a float64 recurrence cannot scan over: the fixture
``f64_cells`` hands lvae_tpu's ``RNNVAE`` cells with ``param_dtype``
float64 (the JAX package itself is unchanged).
"""

import functools
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvae_tpu.data import blocks as jbk
from lvae_tpu.data.datasets import ArrayDataset
from lvae_tpu.evaluation import encode as jenc
from lvae_tpu.models import rnn as jrnn
from lvae_tpu.ops import kernels as jkx
from lvae_tpu.train import hensman as jth
from lvae_tpu.train import state as jst
from lvae_torch import cli
from lvae_torch.data import blocks as tbk
from lvae_torch.data import healthmnist as thm
from lvae_torch.evaluation import encode as tenc
from lvae_torch.inference import LVAEPredictor
from lvae_torch.models import vae as tv
from lvae_torch.ops import kernels as tkx
from lvae_torch.pipeline import LVAEPipeline
from lvae_torch.train import hensman as tth
from lvae_torch.train import pretrain as tpre
from lvae_torch.utils.convert import hensman_state_from_jax, vae_state_dict_from_jax

T, H, L, M, D = 4, 5, 2, 4, 12
CELLS = ("lstm", "gru")
SPEC = dict(cat_kernel=[2], sqexp_kernel=[0],
            cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2}])


@pytest.fixture(autouse=True)
def f64_cells(monkeypatch):
    f64 = {name: functools.partial(getattr(fnn, name), param_dtype=jnp.float64)
           for name in ("OptimizedLSTMCell", "GRUCell")}
    names = {k: getattr(fnn, k) for k in dir(fnn) if not k.startswith("__")}
    proxy = types.SimpleNamespace(**{**names, **f64})
    monkeypatch.setattr(jrnn, "nn", proxy)


def random_params(params, seed):
    """Every leaf of a flax tree redrawn, N(0, 0.3²), in float64."""
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(tree, [jnp.asarray(0.3 * rng.normal(size=x.shape)) for x in leaves])


def pair(cell, seed=0):
    jmodel = jrnn.RNNVAE(latent_dim=L, num_dim=D, T=T, hidden_dim=H, type_rnn=cell,
                         dtype=jnp.float64)
    params = random_params(jmodel.init(jax.random.key(0), jnp.zeros((T, D))), seed)
    tmodel = tv.make_vae("rnn", L, D, T=T, hidden_dim=H, type_rnn=cell, dtype=torch.float64)
    tmodel.load_state_dict(vae_state_dict_from_jax(params, np.float64))
    return jmodel, params, tmodel


@pytest.mark.parametrize("cell", CELLS)
def test_encode_and_decode_match_jax(cell):
    jmodel, params, tmodel = pair(cell)
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(3 * T, D))
    jmu, jlv = jmodel.apply(params, jnp.asarray(x), method="encode")
    tmu, tlv = tmodel.encode(torch.tensor(x))
    np.testing.assert_allclose(tmu.detach().numpy(), np.asarray(jmu), rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(tlv.detach().numpy(), np.asarray(jlv), rtol=1e-8, atol=1e-14)
    z = rng.normal(size=(5, L))
    want = jmodel.apply(params, jnp.asarray(z), method="decode")
    np.testing.assert_allclose(tmodel.decode(torch.tensor(z)).detach().numpy(), np.asarray(want),
                               rtol=1e-8)
    # the backward pass sees later frames: a change at the last frame moves
    # the first frame's moments, as in the JAX model
    x2 = x.copy()
    x2[T - 1] += 1.0
    moved = (tmodel.encode(torch.tensor(x2))[0][0] - tmu[0]).detach()
    assert float(moved.abs().max()) > 1e-6
    with pytest.raises(ValueError, match="divisible by T"):
        tmodel.encode(torch.tensor(x[:T + 1]))


def cohort(p=3, seed=0, ragged=False):
    rng = np.random.default_rng(seed)
    rows = []
    for s in range(p):
        sick, gender, loc = (int(v) for v in rng.integers(0, 2, 3))
        for i in range(T - (s % 2) if ragged else T):
            rows.append([i + rng.uniform(), (i - 1.0) if sick else 0.0, s, gender, sick, loc])
    labels = np.asarray(rows)
    n = labels.shape[0]
    return ArrayDataset(data=rng.uniform(size=(n, D)), labels=labels,
                        mask=(rng.uniform(size=(n, D)) > 0.2).astype(np.float64))


def hensman_pair(cell, ds):
    args = dict(latent_dim=L, P_tot=3, N_tot=len(ds), weight=0.15, loss_function="mse",
                natural_gradient=True, natural_gradient_lr=0.01, constrain_scales=True,
                eps=1e-5, dropout=False)
    jcfg = jth.HensmanConfig(*jkx.split_kernel_spec(id_covariate=2, **SPEC), **args)
    tcfg = tth.HensmanConfig(*tkx.split_kernel_spec(id_covariate=2, **SPEC), **args)
    z = jst.init_inducing_points(ds.labels, M, seed=0, dtype=np.float64)
    jmodel, params, tmodel = pair(cell, seed=4)
    jtr = jth.HensmanTrainer(jmodel, jcfg, ds, jbk.build_subject_blocks(ds.labels, 2), z,
                             subjects_per_batch=2, seed=0, dtype=jnp.float64)
    tr = jtr.state.trainables._replace(vae=params)
    tr = jax.tree.map(lambda x: x.astype(jnp.float64), tr)
    jtr.state = jtr.state._replace(trainables=tr, opt_state=jtr.optimizer.init(tr))
    ttr = tth.HensmanTrainer(tmodel, tcfg, ds, tbk.build_subject_blocks(ds.labels, 2), z,
                             subjects_per_batch=2, seed=0, dtype=torch.float64, device="cpu")
    ttr.state = hensman_state_from_jax(jtr.state, ttr.model, dtype=torch.float64)
    return jtr, ttr


@pytest.mark.parametrize("cell", CELLS)
def test_hensman_batch_loss_value_and_gradients_match_jax(cell, monkeypatch):
    ds = cohort()
    jtr, ttr = hensman_pair(cell, ds)
    eps = np.random.default_rng(5).normal(size=(2 * T, L))
    # RNNVAE.__call__ samples through the name it imported from models/vae
    monkeypatch.setattr(jrnn, "sample_latent",
                        lambda rng, mu, lv: mu + jnp.asarray(eps) * jnp.exp(0.5 * lv))
    rows = jnp.asarray([2, 0])
    table = jtr.tables[0]
    idx, bmask = jnp.take(table.index, rows, axis=0), jnp.take(table.mask, rows, axis=0)
    st = jtr.state
    (net, (metrics, _)), grads = jax.value_and_grad(
        lambda tr: jth.batch_loss(jtr.model, jtr.cfg, tr, st.m_nat, st.H_nat, jtr.tdata, idx,
                                  bmask, jnp.asarray(2.0), jax.random.key(0)),
        has_aux=True)(st.trainables)
    tstate = ttr.state
    order = torch.tensor([2, 0])
    tnet, (tmetrics, _) = tth.batch_loss(
        ttr.model, ttr.cfg, tstate.trainables, tstate.m_nat, tstate.H_nat, ttr.tdata,
        ttr.tables[0].index[order], ttr.tables[0].mask[order], torch.tensor(2.0, dtype=torch.float64),
        eps=torch.tensor(eps))
    tnet.backward()
    for got, want in zip(tmetrics, metrics):
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-8)
    jsd = vae_state_dict_from_jax(grads.vae, np.float64)
    for name, p in ttr.model.named_parameters():
        want = jsd[name].numpy()
        # raw_log_vy under the mse loss: no port gradient, JAX's is 0
        got = np.zeros_like(want) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-13 * np.abs(want).max(),
                                   err_msg=name)
    assert float(ttr.model.rnn.weight_hh_l0_reverse.grad.abs().max()) > 0
    jgp = [*grads.gp.kp0, *grads.gp.kp1]
    for want, got in zip(jgp, tstate.trainables.gp.tensors()):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(want), rtol=1e-8, atol=1e-14)


@pytest.mark.parametrize("cell", CELLS)
def test_pinned_biases_stay_zero_under_adam(cell):
    """The torch biases flax's cells lack stay exactly zero through Adam
    steps, so the trained model keeps the JAX model's parameters."""
    ds = cohort()
    _, ttr = hensman_pair(cell, ds)
    for _ in range(3):
        ttr.train_step(ttr.tables[0], torch.tensor([0, 1]))
    rnn = ttr.model.rnn
    for sfx in ("", "_reverse"):
        if cell == "lstm":
            assert not getattr(rnn, f"bias_ih_l0{sfx}").any()
        else:
            assert not getattr(rnn, f"bias_hh_l0{sfx}")[:2 * H].any()
            assert getattr(rnn, f"bias_hh_l0{sfx}")[2 * H:].all()


def test_ragged_cohort_is_refused_as_in_jax():
    ds = cohort(ragged=True)
    with pytest.raises(ValueError, match="fixed-T cohort"):
        hensman_pair("gru", ds)


def test_encode_dataset_chunks_whole_subjects_as_in_jax():
    jmodel, params, tmodel = pair("lstm")
    data = np.random.default_rng(2).uniform(size=(5 * T, D))
    for batch_size in (6, 9, 1000):  # rounded down to 4, 8 and all 20 rows
        jmu, jlv = jenc.encode_dataset(jmodel, params, data, batch_size=batch_size)
        tmu, tlv = tenc.encode_dataset(tmodel, data, batch_size=batch_size, device="cpu")
        np.testing.assert_allclose(tmu, jmu, rtol=1e-8, atol=1e-14)
        np.testing.assert_allclose(tlv, jlv, rtol=1e-8, atol=1e-14)
    for enc, args in ((jenc.encode_dataset, (jmodel, params, data[:-1])),
                      (tenc.encode_dataset, (tmodel, data[:-1]))):
        kwargs = {} if enc is jenc.encode_dataset else {"device": "cpu"}
        with pytest.raises(ValueError, match="divisible by T"):
            enc(*args, **kwargs)


def test_serving_batch_and_pretraining_batches_follow_t():
    _, _, tmodel = pair("gru")
    ds = cohort(p=3)
    spec0, spec1 = tkx.split_kernel_spec(id_covariate=2, **SPEC)
    from lvae_torch.train.state import init_gp_params

    pred = LVAEPredictor(model=tmodel.float(), gp_params=init_gp_params(spec0, spec1, L),
                         noise=torch.ones(L), spec0=spec0, spec1=spec1,
                         z=ds.labels[:M], id_covariate=2, basis_labels=ds.labels,
                         basis_mu=np.zeros((len(ds), L)), device="cpu")
    # lvae_tpu/inference.py:242-246: round down to a multiple of T, at least T
    for asked, want in ((10, 8), (3, T), (12, 12)):
        assert pred.aot_compile(batch_size=asked).batch_size == want
    bundle = pred.aot_compile(batch_size=10)
    np.testing.assert_allclose(bundle.encode(ds.data), pred.encode(ds.data), rtol=1e-6)
    with pytest.raises(ValueError, match="t_obs == T"):
        pred.aot_compile(batch_size=8, t_obs=2, n_query=3)
    pre = tpre.VAEPretrainer(tmodel, ds, batch_size=10, device="cpu")
    assert pre.batch_size == 8
    order = pre.epoch_order()
    assert order.shape == (1, 8)
    starts = order.reshape(-1, T)
    assert (starts[:, 0] % T == 0).all() and (starts - starts[:, :1] == torch.arange(T)).all()
    with pytest.raises(ValueError, match="divisible by T"):
        tpre.VAEPretrainer(tmodel, ArrayDataset(ds.data[:-1], ds.labels[:-1], ds.mask[:-1]),
                           device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_cli_pretrain_hensman_and_serving_with_the_rnn_encoder(cell, tmp_path):
    data, results = tmp_path / "data", tmp_path / "results"
    thm.generate_healthmnist(1, 1, num_timepoints=5, seed=1, destination=str(data))
    files = [f"--data_source_path={data}", f"--save_path={results}",
             f"--results_path={results}", "--dataset_type=HealthMNIST",
             "--csv_file_data=health_MNIST_data_masked.csv",
             "--csv_file_label=health_MNIST_label.csv", "--mask_file=mask.csv"]
    model = ["--type_nnet=rnn", f"--type_rnn={cell}", "--hidden_dim=6", "--T=5",
             "--latent_dim=2", "--num_dim=1296", "--dropout=0"]
    (tmp_path / "vae.txt").write_text("\n".join(files + model + ["--epochs=1"]) + "\n")
    assert cli.main(["--device=cpu", "pretrain", f"--f={tmp_path / 'vae.txt'}"]) == 0
    lvae = files + model + [
        "--id_covariate=2", "--M=4", "--cat_kernel=[2]", "--sqexp_kernel=[0]",
        "--cat_int_kernel=[{'cont_covariate':0, 'cat_covariate':2}]", "--constrain_scales=True",
        "--hensman=True", "--natural_gradient=True", "--subjects_per_batch=1",
        "--type_KL=GPapprox_closed", "--loss_function=mse", "--epochs=1",
        f"--model_params={results / 'model_params_vae.ckpt'}", "--gp_model_folder="]
    (tmp_path / "lvae.txt").write_text("\n".join(lvae) + "\n")
    from lvae_torch.config import parse_flag_lines

    cfg, _ = parse_flag_lines([f"--f={tmp_path / 'lvae.txt'}"])
    pipe = LVAEPipeline(cfg, device="cpu")
    pipe.build_trainer()
    assert pipe.model.type_rnn == cell and pipe.model.rnn.hidden_size == 6
    pipe.train()
    pipe.save_artifacts()
    assert (results / "model_final.ckpt").exists() and (results / "gp_model.pth").exists()
    served = LVAEPredictor.from_pipeline(pipe)
    bundle = served.aot_compile(batch_size=8, t_obs=5, n_query=3)
    ds = pipe.dataset
    query = ds.labels[:3].copy()
    query[:, 2] = 99
    lab = ds.labels[:5].copy()
    lab[:, 2] = 99
    out = bundle.predict_trajectories(ds.data[None, :5], lab[None], query[None])
    assert out.shape == (1, 3, 1296) and np.isfinite(out).all()

"""The port's evaluation programs (lvae_torch/evaluation/programs.py) on the
CPU, where each runs eagerly (on the card each is a replay of a captured
CUDA graph: ``tests/test_torch_cuda.py``).

The world is ``tests/test_torch_evaluation.py``'s: one float64 ConvVAE
carried over from flax, random float64 GP hyperparameters, L=3, T=5, M=6, a
ragged 3-subject validation cohort of 14 frames; the RNN encoders are
``tests/test_torch_rnn.py``'s (T=4, hidden 5, L=2), in float64. Held here:

* every program on the CPU is the eager program: the value each call of
  ``programs.run`` returns is the bits of its function run again on its
  inputs, and no graph is captured (validate, encode, decode,
  ``recon_mse``, ``vae_forward``, the GP posterior);
* ``validate`` against JAX's at rtol 1e-8 in each ``type_KL`` mode
  (``closed`` and ``GPapprox_closed`` take the DUBO, ``GPapprox`` the mean
  of 3 samples' −Σ gp_elbo), the noise injected, on the K1 and on the K4
  route;
* with no generator, ``validate`` draws the GPapprox noise after the
  encoder noise from one generator seeded 0 (the same bits as that draw
  injected; not the encoder's first values again);
* ``encode_dataset``/``decode_latents`` against JAX's at rtol 1e-8 (atol
  1e-14 on the moments) where N is not a multiple of the chunk, for the
  ConvVAE and for both RNN cells, whose chunks are whole subjects;
* a program's key: the same after an update in place, another when the
  model's storages are replaced or cuDNN's determinism switch flips; a
  capture drops the graphs of its name and shape on other storages (not
  those of another route) and keeps at most ``GRAPHS_PER_NAME`` graphs of
  one name;
* a dataset array's device copy lives as long as the array.
"""

import functools
import types

import flax.linen as fnn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvae_tpu.evaluation import encode as jenc
from lvae_tpu.evaluation.validate import validate as jax_validate
from lvae_tpu.models import rnn as jrnn
from lvae_torch.evaluation import encode as tenc
from lvae_torch.evaluation import programs
from lvae_torch.evaluation import testing as ttest
from lvae_torch.evaluation import validate as tval
from lvae_torch.models import vae as tv
from lvae_torch.ops import kernels as tkx
from lvae_torch.ops import predict as tpr
from lvae_torch.train.graph import StepGraphs
from test_torch_evaluation import L, inject, noise_for, world  # noqa: F401
import test_torch_rnn as rnn_t

ROUTES = {"k1": (True, False), "k4": (False, True)}  # (use_b_chain_kernel, use_block_pair_kernel)
SAMPLES = 3


@pytest.fixture
def recorded(monkeypatch):
    """Every ``programs.run`` call: (name, function, inputs, value)."""
    calls = []
    real = programs.run

    def spy(name, fn, inputs, *args, **kwargs):
        out = real(name, fn, inputs, *args, **kwargs)
        calls.append((name, fn, inputs, out))
        return out

    monkeypatch.setattr(programs, "run", spy)
    return calls


def val_args(w, ds=None):
    return (w["tmodel"], w["tgp"], torch.tensor(w["noise"]), *w["tspecs"], ds or w["valid"],
            w["z"], 2, 0.15)


def blocks_shape(ds):
    _, counts = np.unique(ds.labels[:, 2], return_counts=True)
    return len(counts), int(counts.max())


def test_programs_on_the_cpu_are_the_eager_programs(world, recorded):
    w = world
    model = w["tmodel"]
    tval.validate(*val_args(w), verbose=False, device="cpu")
    tval.validate(*val_args(w), type_kl="GPapprox", num_samples=2, verbose=False, device="cpu")
    mu, _ = tenc.encode_dataset(model, w["valid"].data, batch_size=4, device="cpu")
    tenc.decode_latents(model, mu, batch_size=4, device="cpu")
    ttest.vae_test(model, w["test"], verbose=False, device="cpu")
    tenc.vae_forward(model, torch.tensor(w["test"].data))
    tpr.predict_latents(*w["tspecs"], w["tgp"].kp0, w["tgp"].kp1, torch.tensor(w["noise"]),
                        w["train"].labels, w["pred_mu"], w["test"].labels, torch.tensor(w["z"]),
                        2, 1e-5)
    names = [c[0] for c in recorded]
    assert sorted(set(names)) == ["decode", "encode", "gp_predict", "recon_mse", "vae_forward",
                                  "validate"]
    for name, fn, inputs, out in recorded:
        with torch.inference_mode():
            again = fn(*inputs)
        assert torch.equal(again, out), name
    cpu = torch.device("cpu")
    graphs = programs.graphs_of(model, cpu)
    assert graphs == {} and graphs.pool is None
    assert programs.graphs_of(None, cpu) == {}


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("type_kl,loss", [("closed", "mse"), ("GPapprox_closed", "nll"),
                                          ("GPapprox", "mse")])
def test_validate_matches_jax_in_each_mode_and_route(world, inject, monkeypatch, type_kl, loss,
                                                     route):
    w = world
    ds = w["valid"]
    want = jax_validate(
        w["jmodel"], w["params"], w["jgp"], jnp.asarray(w["noise"]), *w["jspecs"], ds,
        jnp.asarray(w["z"]), 2, 0.15, loss, L, 1e-5, type_kl=type_kl, num_samples=SAMPLES,
        verbose=False)
    b_chain, block_pair = ROUTES[route]
    monkeypatch.setattr(tkx, "use_b_chain_kernel", b_chain)
    monkeypatch.setattr(tkx, "use_block_pair_kernel", block_pair)
    p, t_max = blocks_shape(ds)
    got = tval.validate(
        *val_args(w), loss, L, 1e-5, type_kl=type_kl, num_samples=SAMPLES, verbose=False,
        enc_eps=torch.tensor(noise_for((len(ds), L))),
        gp_eps=torch.tensor(np.stack([noise_for((p, t_max, L))] * SAMPLES)), device="cpu")
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-8)


def test_validate_draws_the_gp_noise_after_the_encoder_noise_from_one_generator(world):
    w = world
    ds = w["valid"]
    p, t_max = blocks_shape(ds)
    gen = torch.Generator().manual_seed(0)
    enc = torch.randn((len(ds), L), generator=gen, dtype=torch.float64)
    after = torch.randn((SAMPLES, p, t_max, L), generator=gen, dtype=torch.float64)
    first = torch.randn((SAMPLES, p, t_max, L), generator=torch.Generator().manual_seed(0),
                        dtype=torch.float64)
    kw = dict(type_kl="GPapprox", num_samples=SAMPLES, verbose=False, device="cpu")
    drawn = tval.validate(*val_args(w), **kw)
    assert drawn == tval.validate(*val_args(w), enc_eps=enc, gp_eps=after, **kw)
    repeated = tval.validate(*val_args(w), enc_eps=enc, gp_eps=first, **kw)
    assert repeated.recon == drawn.recon and repeated.gp != drawn.gp


def test_encode_and_decode_match_jax_on_a_padded_tail(world):
    w = world
    data = w["valid"].data  # 14 frames in chunks of 4: the last one padded with row 0
    jmu, jlv = jenc.encode_dataset(w["jmodel"], w["params"], data, batch_size=4)
    tmu, tlv = tenc.encode_dataset(w["tmodel"], data, batch_size=4, device="cpu")
    np.testing.assert_allclose(tmu, jmu, rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(tlv, jlv, rtol=1e-8, atol=1e-14)
    z = np.random.default_rng(3).normal(size=(9, L))
    np.testing.assert_allclose(tenc.decode_latents(w["tmodel"], z, batch_size=4, device="cpu"),
                               jenc.decode_latents(w["jmodel"], w["params"], z, batch_size=4),
                               rtol=1e-8)


@pytest.fixture
def f64_cells(monkeypatch):
    """lvae_tpu's RNN cells with a float64 carry (``tests/test_torch_rnn.py``)."""
    f64 = {name: functools.partial(getattr(fnn, name), param_dtype=jnp.float64)
           for name in ("OptimizedLSTMCell", "GRUCell")}
    names = {k: getattr(fnn, k) for k in dir(fnn) if not k.startswith("__")}
    monkeypatch.setattr(jrnn, "nn", types.SimpleNamespace(**{**names, **f64}))


@pytest.mark.parametrize("cell", rnn_t.CELLS)
def test_rnn_encode_and_decode_match_jax_in_whole_subject_chunks(f64_cells, cell):
    jmodel, params, tmodel = rnn_t.pair(cell)
    rng = np.random.default_rng(4)
    data = rng.uniform(size=(5 * rnn_t.T, rnn_t.D))  # chunks of 8 rows: 8, 8, 4 + a ghost subject
    jmu, jlv = jenc.encode_dataset(jmodel, params, data, batch_size=9)
    tmu, tlv = tenc.encode_dataset(tmodel, data, batch_size=9, device="cpu")
    np.testing.assert_allclose(tmu, jmu, rtol=1e-8, atol=1e-14)
    np.testing.assert_allclose(tlv, jlv, rtol=1e-8, atol=1e-14)
    z = rng.normal(size=(7, rnn_t.L))
    np.testing.assert_allclose(tenc.decode_latents(tmodel, z, batch_size=3, device="cpu"),
                               jenc.decode_latents(jmodel, params, z, batch_size=3), rtol=1e-8)


def test_program_key_follows_the_storages_not_the_values():
    model = tv.make_vae("conv", 2, 1296, dropout=0.0, generator=torch.Generator().manual_seed(0))
    x = torch.zeros(3, 36, 36, 1)
    key = programs.program_key("encode", [x], model, (1000,))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    model.load_state_dict(model.state_dict())  # copies into the same storages
    assert programs.program_key("encode", [x], model, (1000,)) == key
    fresh = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(fresh, assign=True)
    moved = programs.program_key("encode", [x], model, (1000,))
    assert moved != key and moved[:5] == key[:5]
    assert programs.program_key("encode", [x[:2]], model, (1000,))[:2] != key[:2]
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = not prev
    try:  # a capture keeps the cuDNN algorithms its warm-up chose
        assert programs.program_key("encode", [x], model, (1000,)) != moved
    finally:
        torch.backends.cudnn.deterministic = prev


def test_a_capture_drops_the_graphs_it_replaces_and_the_oldest_of_its_name():
    graphs = StepGraphs()
    sig, k1, k4 = (((3, 2), torch.float32),), (None, False), (False, True)
    stale = ("encode", sig, None, k1, (), (0,))  # on storages since replaced
    other_route = ("encode", sig, None, k4, (), (1,))
    other_shape = ("encode", (((4, 2), torch.float32),), None, k1, (), (0,))
    decode = ("decode", sig, None, k1, (), (0,))
    graphs.update({stale: "g", other_route: "g", other_shape: "g", decode: "g"})
    programs._make_room(graphs, ("encode", sig, None, k1, (), (1,)))
    assert list(graphs) == [other_route, other_shape, decode]
    keys = [("encode", (((n, 2), torch.float32),), None, k1, (), (1,))
            for n in range(5, 5 + programs.GRAPHS_PER_NAME)]
    graphs.update((k, "g") for k in keys)
    programs._make_room(graphs, ("encode", (((99, 2), torch.float32),), None, k1, (), (1,)))
    kept = [k for k in graphs if k[0] == "encode"]
    assert kept == keys[-(programs.GRAPHS_PER_NAME - 1):] and decode in graphs


def test_a_dataset_array_is_moved_once_while_it_lives():
    made = []

    def make():
        made.append(1)
        return len(made)

    arr = np.zeros(3)
    assert programs._cached(arr, ("t",), make) == programs._cached(arr, ("t",), make) == 1
    assert programs._cached(arr, ("u",), make) == 2
    keys = [k for k in programs._on_card if k[0] == id(arr)]
    assert len(keys) == 2
    del arr
    assert not any(k in programs._on_card for k in keys)
    assert programs._cached([0.0], ("t",), make) == 3  # not an array: made at every call

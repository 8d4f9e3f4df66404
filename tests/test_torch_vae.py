"""lvae_torch.models.vae against the flax models, weights carried over by
lvae_torch.utils.convert, on the CPU in float32.

Tolerance atol 1e-5: the two frameworks sum the convolutions and dense
products in another order, and f32 rounding differs by a few ulps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvae_tpu.evaluation.encode import decode_latents as j_decode_latents
from lvae_tpu.evaluation.encode import encode_dataset as j_encode_dataset
from lvae_tpu.models import vae as jv
from lvae_torch.evaluation.encode import decode_latents, encode_dataset
from lvae_torch.models import vae as tv
from lvae_torch.utils.convert import vae_state_dict_from_jax

ATOL = 1e-5
LATENT = 4


def _pair(kind):
    if kind == "conv":
        jm = jv.ConvVAE(latent_dim=LATENT, num_dim=36 * 36, p=0.0)
        x0 = jnp.zeros((2, 36, 36, 1), jnp.float32)
        tm = tv.make_vae("conv", LATENT, 36 * 36, dropout=0.0)
    else:
        jm = jv.SimpleVAE(latent_dim=LATENT, num_dim=50)
        x0 = jnp.zeros((2, 50), jnp.float32)
        tm = tv.make_vae("simple", LATENT, 50)
    params = jm.init(jax.random.key(0), x0, deterministic=True)
    # non-default noise so the carried raw_log_vy is checked too
    params["params"]["raw_log_vy"] = params["params"]["raw_log_vy"] + 0.1
    tm.load_state_dict(vae_state_dict_from_jax(params))
    return jm, params, tm.eval()


@pytest.mark.parametrize("kind", ["conv", "simple"])
def test_encode_decode_match_flax(kind):
    jm, params, tm = _pair(kind)
    rng = np.random.default_rng(0)
    shape = (3, 36, 36, 1) if kind == "conv" else (3, 50)
    x = rng.uniform(size=shape).astype(np.float32)
    z = rng.normal(size=(3, LATENT)).astype(np.float32)
    jmu, jlv = jm.apply(params, jnp.asarray(x), deterministic=True, method="encode")
    jrec = jm.apply(params, jnp.asarray(z), deterministic=True, method="decode")
    with torch.no_grad():
        tmu, tlv = tm.encode(torch.from_numpy(x))
        trec = tm.decode(torch.from_numpy(z))
        tfwd, fmu, _ = tm(torch.from_numpy(x))
    np.testing.assert_allclose(tmu.numpy(), np.asarray(jmu), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tlv.numpy(), np.asarray(jlv), atol=ATOL, rtol=0)
    assert trec.shape == jrec.shape  # NHWC at the public methods
    np.testing.assert_allclose(trec.numpy(), np.asarray(jrec), atol=ATOL, rtol=0)
    jfwd, _, _ = jm.apply(params, jnp.asarray(x), deterministic=True)
    np.testing.assert_allclose(tfwd.numpy(), np.asarray(jfwd), atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        tv.floored_log_vy(tm.raw_log_vy.detach()).numpy(),
        np.asarray(jv.floored_log_vy(params["params"]["raw_log_vy"])),
        rtol=1e-6,
    )


def test_chunked_encode_decode_match_flax():
    """encode_dataset/decode_latents chunk with the JAX pad rule; N=7 in
    chunks of 3 pads the tail with row 0."""
    jm, params, tm = _pair("conv")
    rng = np.random.default_rng(1)
    x = rng.uniform(size=(7, 36, 36, 1)).astype(np.float32)
    mu, lv = encode_dataset(tm, x, batch_size=3, device="cpu")
    jmu, jlv = j_encode_dataset(jm, params, x, batch_size=3)
    np.testing.assert_allclose(mu, jmu, atol=ATOL, rtol=0)
    np.testing.assert_allclose(lv, jlv, atol=ATOL, rtol=0)
    rec = decode_latents(tm, mu, batch_size=3, device="cpu")
    jrec = j_decode_latents(jm, params, jmu, batch_size=3)
    assert rec.shape == (7, 36, 36, 1)
    np.testing.assert_allclose(rec, jrec, atol=ATOL, rtol=0)
    assert encode_dataset(tm, x[:0], device="cpu")[0].shape == (0, LATENT)
    assert decode_latents(tm, mu[:0], device="cpu").shape == (0, 36, 36, 1)


def test_dropout_is_off_in_eval_and_on_in_train():
    tm = tv.make_vae("conv", LATENT, 36 * 36, dropout=0.5,
                     generator=torch.Generator().manual_seed(0))
    x = torch.rand(4, 36, 36, 1, generator=torch.Generator().manual_seed(1), dtype=torch.float32)
    with torch.no_grad():
        tm.eval()
        a, b = tm.encode(x)[0], tm.encode(x)[0]
        assert torch.equal(a, b)
        tm.train()
        torch.manual_seed(0)
        c = tm.encode(x)[0]
    assert not torch.equal(a, c)


@pytest.mark.parametrize("kind", ["conv", "simple"])
def test_model_is_float32_whatever_the_default_dtype(kind):
    """The port's models are f32 as the JAX package's are, even where an
    earlier caller left torch's default dtype at float64."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        tm = tv.make_vae(kind, LATENT, 36 * 36).eval()
    finally:
        torch.set_default_dtype(prev)
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    mu, _ = encode_dataset(tm, np.zeros((2, 36, 36, 1), np.float32), device="cpu")
    assert mu.dtype == np.float32


def test_generator_init_is_reproducible():
    a = tv.make_vae("conv", LATENT, 36 * 36, generator=torch.Generator().manual_seed(3))
    b = tv.make_vae("conv", LATENT, 36 * 36, generator=torch.Generator().manual_seed(3))
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(pa, pb), name

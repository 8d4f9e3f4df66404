"""The port's reference file formats (lvae_torch/utils/torch_compat.py)
against lvae_tpu's writers and readers, on the CPU.

* The four GP resume files (``gp_model.pth``, ``zt_list.pth``, ``m.pth``,
  ``H.pth``): from one state (random float64 GP parameters, inducing points
  and (m, H), carried to the port by ``utils/convert.gp_params_from_jax``)
  the JAX writer and the port's give the same keys and float64 tensors,
  z, m and H bit for bit and the GP parameters to the last bits of the two
  libraries' exp (rtol 1e-14, atol 1e-15), under two kernel specs (one
  with a masked covariate, binary and binary-interaction components) and
  both noise settings. JAX's reader
  reads the port's files and the port's reader JAX's, back to the state.
* The ``.pth`` VAE: the port's files read in lvae_tpu give the port's
  model's outputs, and lvae_tpu's files seed the port's pipeline, for the
  ConvVAE and the SimpleVAE.
* A Hensman pipeline run writes the four files of its final state.

Nothing here reads the reference's own checkout.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lvae_tpu.models import vae as jv
from lvae_tpu.ops import kernels as jkx
from lvae_tpu.train import state as jst
from lvae_tpu.utils import torch_compat as jtc
from lvae_torch.models import vae as tv
from lvae_torch.ops import kernels as tkx
from lvae_torch.pipeline import reference_vae_state_dict
from lvae_torch.utils import torch_compat as ttc
from lvae_torch.utils.convert import gp_params_from_jax, vae_state_dict_from_jax

L, M, Q = 3, 5, 7
SPECS = {
    "healthmnist": dict(cat_kernel=[2], sqexp_kernel=[0],
                        cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2},
                                        {"cont_covariate": 0, "cat_covariate": 3},
                                        {"cont_covariate": 1, "cat_covariate": 4}],
                        id_covariate=2),
    "masked_binary": dict(cat_kernel=[2], bin_kernel=[5], sqexp_kernel=[0, 1],
                          cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2}],
                          bin_int_kernel=[{"cont_covariate": 1, "bin_covariate": 4}],
                          covariate_missing_val=[{"covariate": 1, "mask": 6}], id_covariate=2),
}
FILES = ("gp_model.pth", "zt_list.pth", "m.pth", "H.pth")


def state(spec, seed=0):
    """Random JAX float64 GP parameters, z, m and a PSD H."""
    spec0, spec1 = jkx.split_kernel_spec(**spec)
    gp = jst.init_gp_params(spec0, spec1, L, dtype=jnp.float64)
    rng = np.random.default_rng(seed)

    def jitter(x):
        return jnp.asarray(np.asarray(x) + 0.3 * rng.normal(size=x.shape))

    gp = jax.tree.map(jitter, gp)
    z = rng.normal(size=(M, Q))
    m = rng.normal(size=(L, M, 1))
    h = rng.normal(size=(L, M, M))
    return gp, z, m, h @ np.swapaxes(h, -1, -2) + np.eye(M)


def load(path):
    return torch.load(path, map_location="cpu", weights_only=True)


@pytest.mark.parametrize("constrain", [True, False], ids=["noise1", "free_noise"])
@pytest.mark.parametrize("name", sorted(SPECS))
def test_gp_files_equal_the_jax_writer_and_read_back_both_ways(name, constrain, tmp_path):
    spec = SPECS[name]
    gp, z, m, H = state(spec)
    tgp = gp_params_from_jax(gp, dtype=torch.float64)
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jtc.save_reference_gp_state(jdir, gp, z, m, H, latent_dim=L, constrain_scales=constrain,
                                **spec)
    ttc.save_reference_gp_state(tdir, tgp, torch.tensor(z), torch.tensor(m), torch.tensor(H),
                                latent_dim=L, constrain_scales=constrain, **spec)
    for f in FILES:
        want, got = load(os.path.join(jdir, f)), load(os.path.join(tdir, f))
        if f == "gp_model.pth":
            assert sorted(got) == sorted(want)
            pairs = [(got[k], want[k]) for k in want]
            # XLA's and torch's float64 exp and softplus differ in the last
            # bit; softplus⁻¹(y) = log(expm1(y)) turns an ulp of y into an
            # absolute error near the machine epsilon (1/y times ulp(y))
            rtol, atol = 1e-14, 1e-15
        else:
            pairs, rtol, atol = [(got, want)], 0.0, 0.0
        for g, w in pairs:
            assert g.dtype == w.dtype == torch.float64 and g.shape == w.shape
            torch.testing.assert_close(g, w, rtol=rtol, atol=atol)

    # JAX's reader on the port's files, the port's reader on JAX's
    jkp0, jkp1, jnoise, jz, jm, jH = jtc.load_reference_gp_state(tdir, L, **spec)
    tkp0, tkp1, tnoise, tz, tm, tH = ttc.load_reference_gp_state(jdir, L, **spec)
    for jx, tx in ((jkp0, tkp0), (jkp1, tkp1)):
        for a, b in zip(jx, tx):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tnoise.numpy(), np.asarray(jnoise), rtol=1e-12)
    for a, b, want in ((jz, tz, z), (jm, tm, m), (jH, tH, H)):
        np.testing.assert_array_equal(np.asarray(a), want)
        np.testing.assert_array_equal(b.numpy(), want)
    # and back to the state itself: the scales and the used lengthscales
    for kp, tkp, spec_k in ((gp.kp0, tkp0, jkx.split_kernel_spec(**spec)[0]),
                            (gp.kp1, tkp1, jkx.split_kernel_spec(**spec)[1])):
        np.testing.assert_allclose(tkp.raw_scale.numpy(), np.asarray(kp.raw_scale), rtol=1e-9)
        rbf = [c for c, comp in enumerate(spec_k.components) if comp.rbf_col >= 0]
        np.testing.assert_allclose(tkp.raw_lengthscale.numpy()[:, rbf],
                                   np.asarray(kp.raw_lengthscale)[:, rbf], rtol=1e-9)
    want_noise = np.ones(L) if constrain else np.asarray(jkx.constrain(gp.raw_noise))
    np.testing.assert_allclose(tnoise.numpy(), want_noise, rtol=1e-9)


@pytest.mark.parametrize("kind", ["conv", "simple"])
def test_pth_vae_round_trips_with_lvae_tpu(kind, tmp_path):
    num_dim, lat = (1296, 3) if kind == "conv" else (20, 3)
    model = tv.make_vae(kind, lat, num_dim, generator=torch.Generator().manual_seed(4),
                        dropout=0.0)
    path = ttc.save_torch_vae_checkpoint(str(tmp_path / "port.pth"), model)
    assert "_log_vy" in load(path) and "raw_log_vy" not in load(path)
    params = jtc.load_torch_vae_checkpoint(path, kind, lat)
    jmodel = (jv.ConvVAE(latent_dim=lat, num_dim=num_dim, p=0.0) if kind == "conv"
              else jv.SimpleVAE(latent_dim=lat, num_dim=num_dim))
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(4, 36, 36, 1) if kind == "conv" else (4, num_dim)).astype(np.float32)
    jmu, _ = jmodel.apply(params, jnp.asarray(x), method="encode")
    tmu, _ = model.eval().encode(torch.tensor(x))
    np.testing.assert_allclose(tmu.detach().numpy(), np.asarray(jmu), rtol=1e-4, atol=1e-5)

    # lvae_tpu's file seeds the port's model exactly as its own params do
    jpath = jtc.save_torch_vae_checkpoint(str(tmp_path / "jax.pth"), params, kind)
    sd = reference_vae_state_dict(load(jpath))
    want = vae_state_dict_from_jax(params)
    assert sorted(sd) == sorted(want)
    for k in want:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)
    other = tv.make_vae(kind, lat, num_dim, dropout=0.0)
    other.load_state_dict(sd)
    for k, v in other.state_dict().items():
        torch.testing.assert_close(v, model.state_dict()[k], rtol=0, atol=0)


def test_rnn_has_no_reference_pth(tmp_path):
    model = tv.make_vae("rnn", 2, 12, T=3, hidden_dim=4)
    with pytest.raises(ValueError, match="no RNN"):
        ttc.save_torch_vae_checkpoint(str(tmp_path / "rnn.pth"), model)


def test_hensman_pipeline_writes_the_four_files_of_its_state(tmp_path):
    from lvae_torch.data import healthmnist as thm
    from lvae_torch.pipeline import LVAEPipeline
    from lvae_torch.config import parse_flag_lines
    from lvae_torch.train.state import psd_from_factor

    thm.generate_healthmnist(1, 1, num_timepoints=5, seed=1, destination=str(tmp_path / "d"))
    spec = dict(cat_kernel=[2], sqexp_kernel=[0],
                cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2}], id_covariate=2)
    for ng in (True, False):
        out = tmp_path / f"ng{ng}"
        cfg, unknown = parse_flag_lines([
            f"--data_source_path={tmp_path / 'd'}", f"--save_path={out}",
            "--dataset_type=HealthMNIST", "--csv_file_data=health_MNIST_data_masked.csv",
            "--csv_file_label=health_MNIST_label.csv", "--mask_file=mask.csv",
            "--type_nnet=simple", "--latent_dim=2", "--num_dim=1296", "--M=4", "--T=5",
            "--id_covariate=2", "--cat_kernel=[2]", "--sqexp_kernel=[0]",
            "--cat_int_kernel=[{'cont_covariate':0, 'cat_covariate':2}]", "--hensman=True",
            f"--natural_gradient={ng}", "--subjects_per_batch=1", "--epochs=1",
            "--constrain_scales=False", "--gp_model_folder=", "--model_params="])
        assert not unknown
        pipe = LVAEPipeline(cfg, device="cpu")
        pipe.train()
        pipe.save_artifacts()
        st = pipe.trainer.state
        tr = st.trainables
        kp0, kp1, noise, z, m, H = ttc.load_reference_gp_state(str(out), 2, **spec)
        torch.testing.assert_close(kp0.raw_scale.float(), tr.gp.kp0.raw_scale.detach(),
                                   rtol=1e-6, atol=1e-6)
        torch.testing.assert_close(noise.float(), tkx.constrain(tr.gp.raw_noise.detach()),
                                   rtol=1e-6, atol=0)
        torch.testing.assert_close(z, pipe.trainer.tdata.z.double(), rtol=0, atol=0)
        want_m = st.m_nat if ng else tr.m
        want_H = st.H_nat if ng else psd_from_factor(tr.h_factor)
        torch.testing.assert_close(m, want_m.detach().double(), rtol=0, atol=0)
        torch.testing.assert_close(H, want_H.detach().double(), rtol=0, atol=0)

"""bf16 VAE compute in the port (``compute_dtype=torch.bfloat16``, the
pipeline's ``model_dtype=bfloat16``) against lvae_tpu's bf16 models, on the
CPU.

Both packages take the same f32 weights (a flax ``model.init`` carried over
by ``utils/convert.py``) and the same inputs from a numpy seed. The noise is
injected on both sides, rounded to bf16 first (lvae_tpu draws it in the
moments' dtype; the test replaces its ``sample_latent``), and dropout is
off. K1 and K2 are not reached on the CPU: the GP algebra runs its plain
versions in f32 on both sides.

bf16 rounds at other places in the two frameworks (flax adds a dense
layer's bias after rounding the product; torch's CPU kernels add it inside;
cuDNN-style recurrences keep a bf16 carry where flax's cells keep theirs
in f32), so answers are held by tolerances relative to the largest
|entry| of the reference: the forward passes at 2e-2, the rest at the
``BOUNDS`` below, each set at no more than 3x the gap measured on the CPU
(``python -m tests.test_torch_bf16`` prints them; PERF.md records them)
and never above 5e-2. The dtype invariants (f32 parameters and optimizer
moments, bf16 outputs, f32 host arrays, an f32 GP side under a bf16 frame
table) are held exactly.

Sizes: 12x12 frames (ConvVAE) or 12 features (SimpleVAE), P=5 subjects x
T=4, L=3, M=6, 2 subjects a batch; the RNN encoder at hidden 8.
"""

if __name__ == "__main__":  # the suite's JAX settings (CPU, x64) before JAX is imported
    import tests.conftest  # noqa: F401

import flax.linen as nn
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from lvae_tpu import inference as jinf
from lvae_tpu.data import blocks as jbk
from lvae_tpu.data.datasets import ArrayDataset
from lvae_tpu.evaluation.encode import encode_dataset as j_encode_dataset
from lvae_tpu.models import rnn as jrnn
from lvae_tpu.models import vae as jv
from lvae_tpu.ops import elbo as jeb
from lvae_tpu.ops import kernels as jkx
from lvae_tpu.train import hensman as jth
from lvae_tpu.train import pretrain as jpre
from lvae_tpu.train import standard as jts
from lvae_tpu.train import state as jst
from lvae_tpu.train import vi as jvi
from lvae_torch import inference as tinf
from lvae_torch.data import blocks as tbk
from lvae_torch.evaluation import encode as tenc
from lvae_torch.models import vae as tv
from lvae_torch.ops import kernels as tkx
from lvae_torch.train import hensman as tth
from lvae_torch.train import pretrain as tpre
from lvae_torch.train import standard as tts
from lvae_torch.train import state as tst
from lvae_torch.train import vi as tvi
from lvae_torch.utils.convert import (
    gp_params_from_jax, hensman_state_from_jax, standard_state_from_jax,
    vae_state_dict_from_jax, vi_state_from_jax,
)

BF16 = torch.bfloat16
P, T, L, M, S = 5, 4, 3, 6, 2
HW, D, HIDDEN = 12, 12, 8
FORWARD_RTOL = 2e-2  # max |Δ| over max |ref| of mu, log_var and the reconstruction
# the gaps measured on the CPU (python -m tests.test_torch_bf16; PERF.md) x at
# most 3, capped at 5e-2; relative unless named abs
BOUNDS = {
    "hensman_terms": 3e-3, "hensman_grads": 4.5e-2,  # measured 1.07e-3, 1.65e-2
    "gpapprox_terms": 1.8e-3, "gpapprox_grads": 5e-2,  # 6.26e-4, 2.34e-2
    "gppvae_terms": 2.5e-3, "gppvae_grads": 3e-2,  # 9.05e-4, 1.09e-2
    "pretrain_terms": 4e-4, "pretrain_grads": 2.5e-2,  # 1.48e-4, 8.57e-3
    "pretrain_bias_grads": 5e-2,  # 2.88e-2 (the output bias: 2,880 terms that cancel)
    "vi1_terms": 4e-4, "vi1_grads": 4e-2,  # 1.39e-4, 1.34e-2
    "vi2_moments": 6e-8,  # 2.21e-8
    "serving_latents": 9e-7, "serving_frames": 1e-2,  # 3.01e-7; abs 3.91e-3 (1 ulp at 0.5)
    "table_net": 1.8e-6,  # 6.21e-7
}
SPEC = dict(cat_kernel=[2], sqexp_kernel=[0],
            cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2},
                            {"cont_covariate": 1, "cat_covariate": 4}])


def round_bf16(a) -> np.ndarray:
    """``a`` rounded to bf16, held in f32: the same values on both sides."""
    return np.asarray(a, np.float32).astype(ml_dtypes.bfloat16).astype(np.float32)


def rel(got, want) -> float:
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    return float(np.abs(got - want).max() / np.abs(want).max())


def cohort(kind, seed=0, subjects=range(P), first_id=0):
    """Subject-major rows ``[time, disease_time, id, gender, disease,
    location]``, uniform frames and a random observation mask."""
    rng = np.random.default_rng(seed)
    rows = []
    for s in subjects:
        sick, gender, loc = (int(v) for v in rng.integers(0, 2, 3))
        for i in range(T):
            rows.append([i + rng.uniform(), (i - 1.0) if sick else 0.0, s + first_id, gender,
                         sick, loc])
    labels = np.asarray(rows, np.float32)
    n = labels.shape[0]
    shape = (n, HW, HW, 1) if kind == "conv" else (n, D)
    num = int(np.prod(shape[1:]))
    return ArrayDataset(data=rng.uniform(size=shape).astype(np.float32), labels=labels,
                        mask=(rng.uniform(size=(n, num)) > 0.2).astype(np.float32))


def num_dim(kind) -> int:
    return HW * HW if kind == "conv" else D


def jax_vae(kind, dtype=jnp.bfloat16):
    if kind == "conv":
        return jv.ConvVAE(latent_dim=L, num_dim=HW * HW, p=0.0, image_hw=HW, dtype=dtype)
    if kind == "simple":
        return jv.SimpleVAE(latent_dim=L, num_dim=D, dtype=dtype)
    return jrnn.RNNVAE(latent_dim=L, num_dim=D, T=T, hidden_dim=HIDDEN, type_rnn=kind,
                       dtype=dtype)


def port_vae(kind, params=None):
    """The port's model of ``kind`` computing in bf16 (the flax ``params``
    loaded where given)."""
    if kind in ("lstm", "gru"):
        model = tv.make_vae("rnn", L, D, T=T, hidden_dim=HIDDEN, type_rnn=kind,
                            compute_dtype=BF16)
    else:
        model = tv.make_vae(kind, L, num_dim(kind), dropout=0.0, compute_dtype=BF16)
    if params is not None:
        model.load_state_dict(vae_state_dict_from_jax(params))
    return model


@pytest.fixture
def inject(monkeypatch):
    """lvae_tpu's ``sample_latent`` takes the test's noise, in the moments'
    dtype: ``eps`` for ``[N, L]`` moments, ``gp_eps`` for ``[P, T, L]``
    blocks; zero noise where the holder has none."""
    holder = {}

    def sample_latent(rng, mu, log_var):
        e = holder.get("eps" if mu.ndim == 2 else "gp_eps")
        e = jnp.zeros(mu.shape, mu.dtype) if e is None else jnp.asarray(e, mu.dtype)
        return mu + e * jnp.exp(0.5 * log_var)

    monkeypatch.setattr(jv, "sample_latent", sample_latent)
    monkeypatch.setattr(jrnn, "sample_latent", sample_latent)
    return holder


# ----------------------------------------------------------------- forward
def forward_gaps(kind):
    """(gaps of mu, log_var and the reconstruction, the port's output dtypes)."""
    jmodel = jax_vae(kind)
    ds = cohort("conv" if kind == "conv" else "simple", seed=1)
    params = jmodel.init(jax.random.key(2), jnp.asarray(ds.data[:T]))
    tmodel = port_vae(kind, params).eval()
    jmu, jlv = jmodel.apply(params, jnp.asarray(ds.data), method="encode")
    with torch.no_grad():
        tmu, tlv = tmodel.encode(torch.from_numpy(ds.data))
        z = round_bf16(np.random.default_rng(3).normal(size=(len(ds), L)))
        trec = tmodel.decode(torch.from_numpy(z))
    jrec = jmodel.apply(params, jnp.asarray(z), method="decode")
    gaps = {"mu": rel(tmu.float(), jmu), "log_var": rel(tlv.float(), jlv),
            "recon": rel(trec.float(), jrec)}
    return gaps, (tmu.dtype, tlv.dtype, trec.dtype, jmu.dtype, jrec.dtype)


@pytest.mark.parametrize("kind", ["conv", "simple", "lstm", "gru"])
def test_forward_matches_jax_bf16(kind):
    gaps, dtypes = forward_gaps(kind)
    assert dtypes == (BF16, BF16, BF16, jnp.bfloat16, jnp.bfloat16)
    for name, gap in gaps.items():
        assert gap <= FORWARD_RTOL, (name, gaps)


# ----------------------------------------------------------------- Hensman
def hensman_cfgs(kind, loss="mse", ng=True, constrain=True):
    ds = cohort(kind)
    args = dict(latent_dim=L, P_tot=P, N_tot=len(ds), weight=0.15, loss_function=loss,
                natural_gradient=ng, natural_gradient_lr=0.01, constrain_scales=constrain,
                eps=1e-5, dropout=False)
    return (ds, jth.HensmanConfig(*jkx.split_kernel_spec(id_covariate=2, **SPEC), **args),
            tth.HensmanConfig(*tkx.split_kernel_spec(id_covariate=2, **SPEC), **args))


def hensman_pair(kind, loss="mse", ng=True, constrain=True):
    """(lvae_tpu's trainer of a bf16 model, the port's from its state)."""
    ds, jcfg, tcfg = hensman_cfgs(kind, loss, ng, constrain)
    z = jst.init_inducing_points(ds.labels, M, seed=0)
    jtr = jth.HensmanTrainer(jax_vae(kind), jcfg, ds, jbk.build_subject_blocks(ds.labels, 2), z,
                             subjects_per_batch=S, seed=0)
    ttr = tth.HensmanTrainer(port_vae(kind), tcfg, ds, tbk.build_subject_blocks(ds.labels, 2),
                             z, subjects_per_batch=S, seed=0, device="cpu")
    ttr.state = hensman_state_from_jax(jtr.state, ttr.model)
    return jtr, ttr


def vae_grad_gap(jgrads_vae, model) -> float:
    """The largest per-tensor gap of the VAE's gradients from lvae_tpu's
    bf16 ones."""
    want = vae_state_dict_from_jax(jgrads_vae)
    return max(rel(p.grad, want[n]) for n, p in model.named_parameters()
               if np.abs(want[n].numpy()).max() > 0)


def hensman_gaps(kind, loss, ng, inject):
    jtr, ttr = hensman_pair(kind, loss, ng, constrain=ng)
    rows = np.asarray([0, 3])
    eps = round_bf16(np.random.default_rng(5).normal(size=(S * T, L)))
    inject["eps"] = eps
    st = jtr.state
    table = jtr.tables[0]
    idx, bmask = table.index[rows], table.mask[rows]
    (_, (jm, _)), jgrads = jax.value_and_grad(
        lambda tr: jth.batch_loss(jtr.model, jtr.cfg, tr, st.m_nat, st.H_nat, jtr.tdata, idx,
                                  bmask, jnp.float32(2), jax.random.key(0)),
        has_aux=True)(st.trainables)
    tstate, ttable = ttr.state, ttr.tables[0]
    order = torch.from_numpy(rows)
    net, (tm, _) = tth.batch_loss(
        ttr.model, ttr.cfg, tstate.trainables, tstate.m_nat, tstate.H_nat, ttr.tdata,
        ttable.index[order], ttable.mask[order], torch.tensor(2.0), eps=torch.from_numpy(eps))
    net.backward()
    terms = max(abs(float(g) - float(w)) / abs(float(w)) for g, w in zip(tm, jm))
    return {"hensman_terms": terms, "hensman_grads": vae_grad_gap(jgrads.vae, ttr.model)}


HENSMAN_REGIMES = {"conv_ng_mse": ("conv", "mse", True), "simple_adam_nll": ("simple", "nll", False)}


@pytest.mark.parametrize("regime", sorted(HENSMAN_REGIMES))
def test_hensman_batch_loss_matches_jax_bf16(regime, inject):
    gaps = hensman_gaps(*HENSMAN_REGIMES[regime], inject)
    for name, gap in gaps.items():
        assert gap <= BOUNDS[name], (name, gaps)


def test_hensman_bf16_steps_finite_and_decreasing():
    """As tests/test_training.py holds lvae_tpu's bf16 Hensman run."""
    _, ttr = hensman_pair("simple")
    first = ttr.run_epoch()
    for _ in range(8):
        last = ttr.run_epoch()
    assert np.isfinite(last.net) and last.net < first.net


def test_dtype_invariants_after_a_step(monkeypatch):
    monkeypatch.setattr(tth, "use_bf16_table", None)
    _, ttr = hensman_pair("conv")
    ttr.run_epoch()
    params = list(ttr.state.trainables.parameters())
    assert all(p.dtype == torch.float32 for p in params)
    assert ttr.model.raw_log_vy.dtype == torch.float32
    opt = ttr.state.opt_state
    moments = [t for s in opt.state.values() for k, t in s.items() if k != "step"]
    assert len(moments) == 2 * len(params) and all(t.dtype == torch.float32 for t in moments)
    assert ttr.model.compute_dtype == BF16  # .to(dtype) recast the parameters only
    assert ttr.tdata.data.dtype == torch.float32  # the table is f32 unless switched on
    x = torch.from_numpy(cohort("conv").data[:4])
    with torch.no_grad():
        mu, lv = ttr.model.encode(x)
        assert mu.dtype == lv.dtype == ttr.model.decode(mu).dtype == BF16
    mu_np, lv_np = tenc.encode_dataset(ttr.model, x.numpy(), device="cpu")
    rec = tenc.decode_latents(ttr.model, mu_np, device="cpu")
    assert mu_np.dtype == lv_np.dtype == rec.dtype == np.float32
    assert rec.shape == (4, HW, HW, 1)


def test_auto_model_dtype_and_env_parse(monkeypatch):
    """As tests/test_review_fixes.py holds lvae_tpu's gate: off a TPU the
    auto rule never picks bf16; the switch forces it both ways, never for
    an f64 base; the variable takes the JAX package's values."""
    monkeypatch.setattr(tv, "use_bf16_model", None)
    assert tv.auto_model_dtype() == torch.float32
    assert tv.auto_model_dtype(torch.float64) == torch.float64
    monkeypatch.setattr(tv, "use_bf16_model", True)
    assert tv.auto_model_dtype() == BF16
    assert tv.auto_model_dtype(torch.float64) == torch.float64
    monkeypatch.setattr(tv, "use_bf16_model", False)
    assert tv.auto_model_dtype() == torch.float32
    for value, want in (("1", True), ("true", True), ("ON", True), ("0", False),
                        ("false", False), ("off", False), ("", None), ("  ", None)):
        monkeypatch.setenv("LVAE_MODEL_BF16", value)
        assert tv.bf16_switch_from_env("LVAE_MODEL_BF16") is want, value
    monkeypatch.setenv("LVAE_TABLE_BF16", "yes")
    with pytest.raises(ValueError, match="LVAE_TABLE_BF16='yes': expected 0/1"):
        tv.bf16_switch_from_env("LVAE_TABLE_BF16")


# ---------------------------------------------------------- the bf16 table
def table_trainer(monkeypatch, compute_dtype, switch):
    monkeypatch.setattr(tth, "use_bf16_table", switch)
    ds, _, tcfg = hensman_cfgs("conv")
    model = tv.make_vae("conv", L, HW * HW, dropout=0.0, compute_dtype=compute_dtype,
                        generator=torch.Generator().manual_seed(0))
    z = jst.init_inducing_points(ds.labels, M, seed=0)
    return tth.HensmanTrainer(model, tcfg, ds, tbk.build_subject_blocks(ds.labels, 2), z,
                              subjects_per_batch=S, seed=0, device="cpu")


def test_bf16_table_gate_and_step(monkeypatch):
    """tests/test_bf16_table.py's gate: a bf16 table only under a bf16
    model with the switch on; the GP side stays f32."""
    tr = table_trainer(monkeypatch, None, True)
    assert tr.tdata.data.dtype == tr.tdata.pixmask.dtype == torch.float32
    tr = table_trainer(monkeypatch, BF16, True)
    assert tr.tdata.data.dtype == tr.tdata.pixmask.dtype == BF16
    assert tr.tdata.labels.dtype == tr.tdata.z.dtype == torch.float32
    ms = tr.run_epochs(2)
    assert np.isfinite(ms[-1].net) and np.isfinite(ms[-1].recon)
    assert tr.tdata.z.dtype == torch.float32
    assert table_trainer(monkeypatch, BF16, False).tdata.data.dtype == torch.float32
    # unset, the table stays f32, as the JAX package's default leaves it
    assert table_trainer(monkeypatch, BF16, None).tdata.data.dtype == torch.float32
    with pytest.raises(AssertionError):  # never for an f64 GP dtype
        assert tth._bf16_table_active(tr.model, torch.float64)


def table_gap(monkeypatch) -> float:
    nets = [table_trainer(monkeypatch, BF16, switch).run_epochs(1)[-1].net
            for switch in (True, False)]
    return abs(nets[0] - nets[1]) / abs(nets[1])


def test_bf16_table_close_to_f32_table(monkeypatch):
    """The table rounds the loss target to bf16: the first epoch tracks the
    f32-table run."""
    assert table_gap(monkeypatch) <= BOUNDS["table_net"]


# ------------------------------------------------- the other regimes, one step
STD_MODES = {"gpapprox": ("GPapprox", "nll", False), "gppvae": ("GPapprox_closed", "mse", False)}


def standard_pair(mode):
    type_kl, loss, constrain = STD_MODES[mode]
    ds = cohort("simple")
    args = dict(latent_dim=L, P_tot=P, T=T, weight=0.3, loss_function=loss, type_KL=type_kl,
                num_samples=2, constrain_scales=constrain, eps=1e-5, dropout=False)
    spec = jkx.split_kernel_spec(id_covariate=2, **SPEC)
    z = jst.init_inducing_points(ds.labels, M, seed=0)
    pseudo = mode == "gppvae"
    jtr = jts.StandardTrainer(jax_vae("simple"), jts.StandardConfig(*spec, **args), ds,
                              jbk.build_subject_blocks(ds.labels, 2), z, seed=0,
                              pseudo_minibatch=pseudo)
    ttr = tts.StandardTrainer(port_vae("simple"),
                              tts.StandardConfig(*tkx.split_kernel_spec(id_covariate=2, **SPEC),
                                                 **args),
                              ds, tbk.build_subject_blocks(ds.labels, 2), z, seed=0,
                              pseudo_minibatch=pseudo, device="cpu")
    ttr.state = standard_state_from_jax(jtr.state, ttr.model)
    return jtr, ttr


def std_grad_gaps(jgrads, trainables) -> float:
    gaps = [vae_grad_gap(jgrads.vae, trainables.vae)]
    jgp = [*jgrads.gp.kp0, *jgrads.gp.kp1]
    for a, b in zip(jgp, trainables.gp.tensors()):
        if b.grad is not None and np.abs(np.asarray(a)).max() > 0:
            gaps.append(rel(b.grad, a))
    return max(gaps)


def standard_gaps(mode, inject):
    jtr, ttr = standard_pair(mode)
    st = ttr.state
    for p in st.trainables.parameters():
        p.grad = None
    if mode == "gpapprox":
        rng = np.random.default_rng(1)
        eps, gp = round_bf16(rng.normal(size=(P * T, L))), round_bf16(rng.normal(size=(P, T, L)))
        inject.update(eps=eps, gp_eps=gp)
        (_, jm), jgrads = jax.value_and_grad(
            lambda tr: jts.full_batch_loss(jtr.model, jtr.cfg, tr, jtr.tdata, jtr.block_mask,
                                           jax.random.key(0)), has_aux=True)(jtr.state.trainables)
        net, tm = tts.full_batch_loss(ttr.model, ttr.cfg, st.trainables, ttr.tdata,
                                      ttr.block_mask, eps=torch.from_numpy(eps),
                                      gp_eps=torch.from_numpy(np.stack([gp, gp])))
        net.backward()
    else:  # z = mu in the replay, as tests/test_torch_standard.py runs it
        jgrads, jm = jts.gppvae_grads(jtr.model, jtr.cfg, jtr.state.trainables, jtr.tdata,
                                      jtr.block_mask, jax.random.key(3))
        tm = tts.gppvae_grads(ttr.model, ttr.cfg, st.trainables, ttr.tdata, ttr.block_mask,
                              eps=torch.zeros(P * T, L), gp_eps=torch.zeros(2, P, T, L))
    terms = max(abs(float(g) - float(w)) / abs(float(w)) for g, w in zip(tm, jm))
    return {f"{mode}_terms": terms, f"{mode}_grads": std_grad_gaps(jgrads, st.trainables)}


@pytest.mark.parametrize("mode", sorted(STD_MODES))
def test_standard_step_matches_jax_bf16(mode, inject):
    gaps = standard_gaps(mode, inject)
    for name, gap in gaps.items():
        assert gap <= BOUNDS[name], (name, gaps)


FLAX_LAYERS = (nn.Conv, nn.ConvTranspose, nn.Dense)


def pretrain_gaps(inject):
    """One pre-training batch (lvae_tpu/train/pretrain.py's batch_loss,
    the KL on the bf16 moments on both sides). The weights' gradients are
    held against lvae_tpu's bf16 ones. A bias's gradient is its layer's
    output cotangent summed over every row and pixel (2,880 terms for the
    first and the last convolution here), which XLA on the CPU adds in
    bf16 and torch in f32: the decoder's output bias reads 4.0 in lvae_tpu
    against 3.502 for its f32 model and 3.516 in the port. So each bias is
    held against lvae_tpu's own bf16 cotangent of its layer's output,
    taken through flax's ``intercept_methods`` and summed in f32."""
    ds = cohort("conv", seed=4)
    jmodel = jax_vae("conv")
    params = jmodel.init(jax.random.key(1), jnp.asarray(ds.data[:2]))
    eps = round_bf16(np.random.default_rng(6).normal(size=(len(ds), L)))
    inject["eps"] = eps
    x, pix = jnp.asarray(ds.data), jnp.asarray(ds.mask)
    shapes = {}

    def jloss(p, outputs):
        """The loss, each layer's output plus ``outputs[its name]`` where
        given (a bf16 zero: the values are unchanged)."""
        def add(next_fun, args, kwargs, context):
            y = next_fun(*args, **kwargs)
            if context.method_name == "__call__" and isinstance(context.module, FLAX_LAYERS):
                shapes[context.module.name] = (y.shape, y.dtype)
                if context.module.name in outputs:
                    y = y + outputs[context.module.name]
            return y

        with nn.intercept_methods(add):
            recon, mu, log_var = jmodel.apply(p, x, rng=jax.random.key(0), deterministic=True)
        mse_i, nll_i = jv.vae_loss(p["params"]["raw_log_vy"], recon, x, pix)
        kld_i = jpre.std_normal_kld(mu, log_var)
        loss = jnp.sum(nll_i + kld_i)
        return loss, (loss, jnp.sum(mse_i), jnp.sum(nll_i), jnp.sum(kld_i))

    (_, jm), jgrads = jax.value_and_grad(jloss, has_aux=True)(params, {})
    zeros = {name: jnp.zeros(shape, dtype) for name, (shape, dtype) in shapes.items()}
    cotangents = jax.grad(lambda o: jloss(params, o)[0])(zeros)
    summed = {name: {**jgrads["params"][name], "bias": jnp.asarray(
        np.asarray(g, np.float32).reshape(-1, g.shape[-1]).sum(0))}
        for name, g in cotangents.items()}
    want = vae_state_dict_from_jax(jgrads)
    want_bias = vae_state_dict_from_jax({"params": {**jgrads["params"], **summed}})
    model = port_vae("conv", params)
    loss, tm = tpre.pretrain_loss(model, torch.from_numpy(ds.data), torch.from_numpy(ds.mask),
                                  torch.from_numpy(eps), "nll", dropout=False)
    loss.backward()
    terms = max(abs(float(g) - float(w)) / abs(float(w)) for g, w in zip(tm, jm))
    grads = {n: rel(p.grad, (want_bias if n.endswith(".bias") else want)[n])
             for n, p in model.named_parameters()}
    return {"pretrain_terms": terms,
            "pretrain_grads": max(g for n, g in grads.items() if not n.endswith(".bias")),
            "pretrain_bias_grads": max(g for n, g in grads.items() if n.endswith(".bias"))}


def test_pretrain_step_matches_jax_bf16(inject):
    gaps = pretrain_gaps(inject)
    for name, gap in gaps.items():
        assert gap <= BOUNDS[name], (name, gaps)


TRAIN_VI = cohort("simple", seed=7)
PRED_VI = cohort("simple", seed=8, subjects=range(3), first_id=10)


def vi_pair():
    args = dict(latent_dim=L, weight=0.15, loss_function="mse", constrain_scales=True,
                eps=1e-5)
    jcfg = jvi.VIConfig(*jkx.split_kernel_spec(id_covariate=2, **SPEC), **args)
    tcfg = tvi.VIConfig(*tkx.split_kernel_spec(id_covariate=2, **SPEC), **args)
    z = jst.init_inducing_points(TRAIN_VI.labels, M, seed=0)
    jmodel = jax_vae("simple")
    params = jmodel.init(jax.random.key(3), jnp.zeros((2, D)))
    gp = jst.init_gp_params(jcfg.spec0, jcfg.spec1, L, constrain_scales=True)
    jtr = jvi.VITrainer(jmodel, jcfg, TRAIN_VI, jbk.build_subject_blocks(TRAIN_VI.labels, 2),
                        z, params, gp, learning_rate=1e-2, seed=0)
    ttr = tvi.VITrainer(port_vae("simple"), tcfg, TRAIN_VI,
                        tbk.build_subject_blocks(TRAIN_VI.labels, 2), z,
                        tst.init_gp_params(tcfg.spec0, tcfg.spec1, L, constrain_scales=True),
                        learning_rate=1e-2, device="cpu")
    ttr.state = vi_state_from_jax(jtr.state, ttr.model, learning_rate=1e-2)
    return jtr, ttr


def vi_phase1_gaps():
    """Phase 1's loss and gradients (lvae_tpu/train/vi.py:108-140 with the
    test's noise; its latents f32, the decoder bf16)."""
    jtr, ttr = vi_pair()
    cfg, st = jtr.cfg, jtr.state
    eps = np.random.default_rng(9).normal(size=st.mu.shape).astype(np.float32)
    data, pixmask, xb, block_mask, z_ind = (jtr.data_ordered, jtr.pixmask_ordered, jtr.xb,
                                            jtr.block_mask, jtr.z_ind)

    def loss(tr):
        mu, log_var, vae, gp = tr
        zs = mu + jnp.asarray(eps) * jnp.exp(0.5 * log_var)
        recon = jtr.model.apply(vae, zs, deterministic=True, method=type(jtr.model).decode)
        mse_i, nll_i = jv.vae_loss(vae["params"]["raw_log_vy"], recon, data, pixmask)
        ops = jeb.gp_block_operators(cfg.spec0, cfg.spec1, gp.kp0, gp.kp1,
                                     jnp.ones_like(gp.raw_noise), xb, z_ind, block_mask, cfg.eps)
        gp_loss = jnp.sum(jeb.dubo(ops, mu.reshape(P, T, L), log_var.reshape(P, T, L))) / L
        net = jnp.sum(mse_i) + cfg.weight * gp_loss
        return net, (jnp.sum(mse_i), jnp.sum(nll_i), gp_loss)

    (net, aux), grads = jax.value_and_grad(loss, has_aux=True)((st.mu, st.log_var, st.vae,
                                                                st.gp))
    got = ttr.loss(ttr.state, torch.from_numpy(eps))
    got[0].backward()
    terms = max(abs(g.item() - float(w)) / abs(float(w)) for g, w in zip(got, (net,) + aux))
    gaps = [vae_grad_gap(grads[2], ttr.state.vae)]
    gaps += [rel(t.grad, w) for t, w in ((ttr.state.mu, grads[0]), (ttr.state.log_var, grads[1]))]
    return {"vi1_terms": terms, "vi1_grads": max(gaps)}


def vi_phase2_gaps():
    """One phase-2 step (lvae_tpu's noise rebuilt from its key chain, in
    the f32 moments' dtype): the prediction cohort's moments after it,
    which start from each package's bf16 encoding."""
    jtr, ttr = vi_pair()
    want = jtr.optimize_prediction_set(PRED_VI, epochs=1, log_every=0, seed=1)
    _, sub = jax.random.split(jax.random.key(1))
    eps = np.stack([np.asarray(jax.random.normal(k, (len(PRED_VI), L), dtype=jnp.float32))
                    for k in jax.random.split(sub, 1)])
    got = ttr.optimize_prediction_set(PRED_VI, epochs=1, log_every=0, eps=torch.from_numpy(eps))
    return {"vi2_moments": max(rel(g, w) for g, w in zip(got, want))}


def test_vi_phase1_matches_jax_bf16():
    gaps = vi_phase1_gaps()
    for name, gap in gaps.items():
        assert gap <= BOUNDS[name], (name, gaps)


def test_vi_phase2_matches_jax_bf16():
    gaps = vi_phase2_gaps()
    assert gaps["vi2_moments"] <= BOUNDS["vi2_moments"], gaps


# ----------------------------------------------------------------- serving
def serving_gaps():
    """A trajectory request and the basis encodings from predictors of one
    bf16 ConvVAE: lvae_tpu's against the port's (its bundle's program,
    eager on the CPU)."""
    ds = cohort("conv", seed=10)
    new = cohort("conv", seed=11, subjects=range(2), first_id=100)
    jmodel = jax_vae("conv")
    params = jmodel.init(jax.random.key(4), jnp.asarray(ds.data[:2]))
    spec0, spec1 = jkx.split_kernel_spec(id_covariate=2, **SPEC)
    t0, t1 = tkx.split_kernel_spec(id_covariate=2, **SPEC)
    gp = jst.init_gp_params(spec0, spec1, L, constrain_scales=True)
    gp = jax.tree_util.tree_map(lambda a: jnp.asarray(
        np.asarray(a) + 0.3 * np.random.default_rng(5).normal(size=a.shape), jnp.float32), gp)
    z = jst.init_inducing_points(ds.labels, M, seed=0)
    jmu, _ = j_encode_dataset(jmodel, params, ds.data)
    jp = jinf.LVAEPredictor(model=jmodel, vae_params=params, gp_params=gp,
                            noise=jnp.ones(L, jnp.float32), spec0=spec0, spec1=spec1,
                            z=jnp.asarray(z), id_covariate=2, basis_labels=ds.labels,
                            basis_mu=np.asarray(jmu))
    tmodel = port_vae("conv", params)
    tmu, _ = tenc.encode_dataset(tmodel, ds.data, device="cpu")
    tp = tinf.LVAEPredictor(model=tmodel, gp_params=gp_params_from_jax(gp),
                            noise=torch.ones(L), spec0=t0, spec1=t1, z=torch.from_numpy(z),
                            id_covariate=2, basis_labels=ds.labels, basis_mu=tmu, device="cpu")
    assert tp.model.compute_dtype == BF16 and tmu.dtype == np.float32
    obs = new.data.reshape(2, T, HW, HW, 1)[:, :2]
    obs_l = new.labels.reshape(2, T, -1)[:, :2]
    query = new.labels.reshape(2, T, -1)[:, 2:]
    kw = dict(batch_size=8, t_obs=2, n_query=2, k_subjects=2)
    got = tp.aot_compile(**kw).predict_trajectories(obs, obs_l, query)
    want = jp.aot_compile(**kw).predict_trajectories(obs, obs_l, query)
    assert got.dtype == np.float32 and got.shape == (2, 2, HW, HW, 1)
    lat = tp.predict_latent_trajectory(obs[0], obs_l[0], query[0])
    jlat = jp.predict_latent_trajectory(obs[0], obs_l[0], query[0])
    return {"serving_latents": max(rel(tmu, jmu), rel(lat, jlat)),
            "serving_frames": float(np.abs(got - np.asarray(want, np.float32)).max())}


def test_serving_request_matches_jax_bf16():
    gaps = serving_gaps()
    for name, gap in gaps.items():
        assert gap <= BOUNDS[name], (name, gaps)


# ------------------------------------------------------------ measurement
def flax_carry_recurrence(rnn, h, cell, reverse):
    """One direction of the port's ``nn.LSTM``/``nn.GRU`` weights run as
    flax's bf16 cells run: gate products in bf16, carry and output in f32
    (the path the port did not take; measured only)."""
    sfx = "_reverse" if reverse else ""
    w_ih, w_hh, b_ih, b_hh = (getattr(rnn, f"{n}_l0{sfx}").to(BF16)
                              for n in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"))
    hid = w_hh.shape[1]
    xi = torch.nn.functional.linear(h, w_ih, b_ih)
    c = state = torch.zeros(h.shape[0], hid)
    out = [None] * h.shape[1]
    for t in (reversed(range(h.shape[1])) if reverse else range(h.shape[1])):
        gh = torch.nn.functional.linear(state.to(BF16), w_hh, b_hh)
        if cell == "lstm":
            i, f, g, o = (gh + xi[:, t]).chunk(4, -1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            state = torch.sigmoid(o) * torch.tanh(c)
        else:
            (xr, xz, xn), (hr, hz, hn) = xi[:, t].chunk(3, -1), gh.chunk(3, -1)
            z = torch.sigmoid(xz + hz)
            n = torch.tanh(xn + torch.sigmoid(xr + hr) * hn)
            state = (1.0 - z) * n + z * state
        out[t] = state
    return torch.stack(out, 1)


def rnn_carry_gaps(cell, t=T, hidden=HIDDEN, latent=L, d=D, subjects=P):
    """The encoder's (mu, log_var) gaps from lvae_tpu's bf16 RNN encoder:
    the port's (cuDNN's call, a bf16 carry) and flax's f32 carry run on the
    port's weights, at the given widths."""
    jmodel = jrnn.RNNVAE(latent_dim=latent, num_dim=d, T=t, hidden_dim=hidden, type_rnn=cell,
                         dtype=jnp.bfloat16)
    x = np.random.default_rng(12).uniform(size=(subjects * t, d)).astype(np.float32)
    params = jmodel.init(jax.random.key(1), jnp.asarray(x[:t]))
    jmu, jlv = jmodel.apply(params, jnp.asarray(x), method="encode")
    model = tv.make_vae("rnn", latent, d, T=t, hidden_dim=hidden, type_rnn=cell,
                        compute_dtype=BF16)
    model.load_state_dict(vae_state_dict_from_jax(params))
    with torch.no_grad():
        mu, lv = model.encode(torch.from_numpy(x))
        e = torch.tanh(tv.layer(model.embed, torch.from_numpy(x).reshape(subjects, t, d), BF16))
        h = sum(flax_carry_recurrence(model.rnn, e, cell, r) for r in (False, True))
        h = h.reshape(subjects * t, hidden)
        fmu, flv = (tv.layer(m, h, BF16) for m in (model.fc_mu, model.fc_lv))
    return {"bf16_carry": {"mu": rel(mu.float(), jmu), "log_var": rel(lv.float(), jlv)},
            "f32_carry": {"mu": rel(fmu.float(), jmu), "log_var": rel(flv.float(), jlv)}}


def measure() -> dict:
    """Every gap this file holds, measured on this CPU, and the RNN
    recurrence's two paths at the test's and at the config file's widths
    (T=20, hidden 64, L=32, 36x36 frames, 20 subjects)."""
    out = {f"forward_{k}": forward_gaps(k)[0] for k in ("conv", "simple", "lstm", "gru")}
    for cell in ("lstm", "gru"):
        out[f"rnn_carry_{cell}"] = rnn_carry_gaps(cell)
        out[f"rnn_carry_{cell}_full_width"] = rnn_carry_gaps(cell, 20, 64, 32, 1296, 20)
    with pytest.MonkeyPatch.context() as mp:
        holder = {}
        mp.setattr(jv, "sample_latent", lambda rng, mu, lv: mu + jnp.asarray(
            holder.get("eps" if mu.ndim == 2 else "gp_eps", np.zeros(mu.shape)), mu.dtype)
            * jnp.exp(0.5 * lv))
        for regime, args in HENSMAN_REGIMES.items():
            holder.clear()
            out[f"hensman_{regime}"] = hensman_gaps(*args, holder)
        for mode in STD_MODES:
            holder.clear()
            out[mode] = standard_gaps(mode, holder)
        holder.clear()
        out["pretrain"] = pretrain_gaps(holder)
        out["table"] = {"table_net": table_gap(mp)}
    out["vi1"] = vi_phase1_gaps()
    out["vi2"] = vi_phase2_gaps()
    out["serving"] = serving_gaps()
    return out


if __name__ == "__main__":
    import json

    print(json.dumps(measure(), indent=1))

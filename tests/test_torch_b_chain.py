"""The B-chain of kernel K1 (lvae_torch/kernels_cuda/b_chain.py) and its
helpers against lvae_tpu, on the CPU.

On the CPU ``BChain``'s forward is the plain version; its backward is the
port of ``_b_chain_bwd_impl``. Each is held against three things, on the
same numpy inputs:

* the JAX XLA chain (block kernels → B → Cholesky → inverse → log|B| →
  trace), in float64 at rtol 1e-8 (summation order only);
* JAX ``fused_b_chain``, the Pallas kernel body run in interpret mode, in
  float32 at rtol 1e-5, with an atol of 1e-5 times each array's largest
  entry: at T = 65 both f32 versions (an unrolled factorisation against
  ``torch.linalg``'s) sit up to 4e-6 of that scale from the f64 value, on
  entries and gradient components near zero as on large ones;
* torch autograd through the plain chain, in float64 at rtol 1e-8.

The inputs cover a ragged mask (a short subject), a ghost subject (mask all
zero), a centred-categorical (``cat_mod``) component and T = 65, which the
JAX package routes to its split path and the CUDA kernel covers with its one
shape.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lvae_tpu.ops.kernels as jkx
from lvae_tpu.kernels_pallas import kernel_matrix as jkm
from lvae_tpu.ops import linalg as jla
from lvae_torch.kernels_cuda import b_chain as bc
from lvae_torch.kernels_cuda import kernel_matrix as tkm
from lvae_torch.ops import elbo as teb
from lvae_torch.ops import kernels as tkx

SPEC_ARGS = dict(
    cat_kernel=[2], sqexp_kernel=[0],
    cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 2}], id_covariate=2,
)


def cat_mod_specs(kx):
    """spec0 with a 4-class centred categorical on column 1 and an RBF;
    spec1 the id categorical."""
    comp = kx.KernelComponent
    spec0 = kx.KernelSpec(components=(
        comp(kind="cat_mod", rbf_col=-1, eq_cols=(), and_cols=(), cat_mod=(1, 4)),
        comp(kind="sqexp", rbf_col=0, eq_cols=(), and_cols=(), cat_mod=(-1, 0)),
    ))
    spec1 = kx.KernelSpec(components=(
        comp(kind="cat", rbf_col=-1, eq_cols=(2,), and_cols=(), cat_mod=(-1, 0)),
        comp(kind="bin_rbf", rbf_col=0, eq_cols=(2,), and_cols=(3,), cat_mod=(-1, 0)),
    ))
    return spec0, spec1


CASES = {
    # name: (S, T, L, cat_mod spec)
    "ragged": (5, 4, 3, False),
    "cat_mod": (4, 3, 2, True),
    "t65": (2, 65, 2, False),
}


def make_case(name, dtype):
    """Numpy inputs and both packages' specs for one case."""
    s, t, latent, cat_mod = CASES[name]
    rng = np.random.RandomState(sum(map(ord, name)))
    xb = np.zeros((s, t, 4))
    xb[:, :, 0] = np.arange(t)[None] * (10.0 / t) + rng.rand(s, 1)  # time
    xb[:, :, 1] = rng.randint(0, 4, (s, t)) if cat_mod else rng.randn(s, t)
    xb[:, :, 2] = np.arange(s)[:, None]  # id
    xb[:, :, 3] = rng.randint(0, 2, (s, 1))
    mask = np.ones((s, t))
    mask[1, t - 1:] = 0.0  # a short subject
    if s > 3:
        mask[3, :] = 0.0  # a ghost subject
    xb = xb * mask[:, :, None]
    if cat_mod:
        specs = (cat_mod_specs(jkx), cat_mod_specs(tkx))
    else:
        specs = (jkx.split_kernel_spec(**SPEC_ARGS), tkx.split_kernel_spec(**SPEC_ARGS))
    c0, c1 = (len(sp.components) for sp in specs[0])
    raw = {
        "s0": rng.randn(latent, c0) * 0.3 + float(jkx.unconstrain(0.7)),
        "l0": rng.randn(latent, c0) * 0.3 + float(jkx.unconstrain(2.5)),
        "s1": rng.randn(latent, c1) * 0.3 + float(jkx.unconstrain(0.7)),
        "l1": rng.randn(latent, c1) * 0.3 + float(jkx.unconstrain(2.5)),
        "noise": rng.rand(latent) + 0.5,
    }
    arrays = {k: v.astype(dtype) for k, v in raw.items()}
    arrays["xb"] = xb.astype(dtype)
    arrays["mask"] = mask.astype(dtype)
    return specs, arrays


def jax_args(specs, a):
    kp0 = jkx.KernelParams(jnp.asarray(a["s0"]), jnp.asarray(a["l0"]))
    kp1 = jkx.KernelParams(jnp.asarray(a["s1"]), jnp.asarray(a["l1"]))
    return (*specs[0], kp0, kp1, jnp.asarray(a["noise"]), jnp.asarray(a["xb"]),
            jnp.asarray(a["mask"]))


def torch_leaves(a):
    return [torch.tensor(a[k], requires_grad=True) for k in ("s0", "l0", "s1", "l1", "noise")]


def torch_args(specs, leaves, a):
    s0, l0, s1, l1, noise = leaves
    return (*specs[1], tkx.KernelParams(s0, l0), tkx.KernelParams(s1, l1), noise,
            torch.tensor(a["xb"]), torch.tensor(a["mask"]))


def jax_xla_chain(spec0, spec1, kp0, kp1, noise, xb, mask):
    k0_st = jkx.block_kernel_matrix(spec0, kp0, xb, mask)
    lb = jla.cholesky(jkx.block_b_operator(spec1, kp1, xb, mask, noise))
    ib = jla.chol_inverse(lb)
    return ib, jla.logdet_from_chol(lb, batch_dims=1), jnp.einsum("lptu,lptu->l", ib, k0_st)


def weights(shape, dtype):
    n = int(np.prod(shape))
    return np.cos(np.arange(n)).reshape(shape).astype(dtype)


def jax_value_and_grads(fn, args):
    spec0, spec1, kp0, kp1, noise, xb, mask = args

    def loss(kp0, kp1, noise):
        ib, ld, tr = fn(spec0, spec1, kp0, kp1, noise, xb, mask)
        w = jnp.asarray(weights(ib.shape, ib.dtype))
        return jnp.sum(ib * w) + jnp.sum(ld * 0.7) + jnp.sum(tr * 1.3)

    outs = fn(*args)
    g = jax.grad(loss, argnums=(0, 1, 2))(kp0, kp1, noise)
    grads = [g[0].raw_scale, g[0].raw_lengthscale, g[1].raw_scale, g[1].raw_lengthscale, g[2]]
    return [np.asarray(o) for o in outs], [np.asarray(x) for x in grads]


def torch_value_and_grads(fn, specs, a):
    leaves = torch_leaves(a)
    outs = fn(*torch_args(specs, leaves, a))
    ib, ld, tr = outs
    w = torch.tensor(weights(tuple(ib.shape), a["xb"].dtype))
    (torch.sum(ib * w) + torch.sum(ld * 0.7) + torch.sum(tr * 1.3)).backward()
    return [o.detach().numpy() for o in outs], [x.grad.numpy() for x in leaves]


def plain_chain_raw(spec0, spec1, kp0, kp1, noise, xb, mask):
    """b_chain_reference from raw parameters, differentiated by autograd."""
    def cg(kp):
        ls = tkx.constrain(kp.raw_lengthscale)
        return tkx.constrain(kp.raw_scale), 0.5 / (ls * ls)

    return bc.b_chain_reference(spec0, spec1, *cg(kp0), *cg(kp1), noise, xb, mask)


def _close(got, want, rtol, atol=0.0):
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=f"output {i}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_backward_match_jax_xla_chain_f64(case):
    specs, a = make_case(case, np.float64)
    want_out, want_grad = jax_value_and_grads(jax_xla_chain, jax_args(specs, a))
    got_out, got_grad = torch_value_and_grads(bc.b_chain_operators, specs, a)
    _close(got_out, want_out, rtol=1e-8, atol=1e-12)
    _close(got_grad, want_grad, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_backward_match_fused_interpret_f32(case, monkeypatch):
    from lvae_tpu.kernels_pallas import b_chain as jbc

    monkeypatch.setattr(jkx, "use_pallas_b_chain", True)
    specs, a = make_case(case, np.float32)
    want_out, want_grad = jax_value_and_grads(jbc.b_chain_operators, jax_args(specs, a))
    got_out, got_grad = torch_value_and_grads(bc.b_chain_operators, specs, a)
    for got, want in zip(got_out + got_grad, want_out + want_grad):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("case", sorted(CASES))
def test_backward_matches_autograd_of_plain_chain(case):
    specs, a = make_case(case, np.float64)
    want_out, want_grad = torch_value_and_grads(plain_chain_raw, specs, a)
    got_out, got_grad = torch_value_and_grads(bc.b_chain_operators, specs, a)
    _close(got_out, want_out, rtol=0)
    _close(got_grad, want_grad, rtol=1e-8, atol=1e-12)


def test_unused_outputs_take_no_cotangent():
    """A loss of log|B| alone (iB and the trace unused) differentiates."""
    specs, a = make_case("ragged", np.float64)
    leaves = torch_leaves(a)
    _, ld, _ = bc.b_chain_operators(*torch_args(specs, leaves, a))
    ld.sum().backward()
    ref = torch_leaves(a)
    plain_chain_raw(*torch_args(specs, ref, a))[1].sum().backward()
    for got, want in zip(leaves, ref):
        if want.grad is None:  # spec0 does not enter log|B|
            assert got.grad is None or not got.grad.any()
        else:
            torch.testing.assert_close(got.grad, want.grad, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("spec_name", ["config", "cat_mod"])
def test_block_helpers_match_jax_f64(spec_name):
    """masked_block_stack and block_param_grads against the JAX helpers."""
    case = "cat_mod" if spec_name == "cat_mod" else "ragged"
    specs, a = make_case(case, np.float64)
    rng = np.random.default_rng(1)
    xf, mf = a["xb"], a["mask"]
    mm3 = mf[:, :, None] * mf[:, None, :]
    for jspec, tspec, sk, lk in ((specs[0][0], specs[1][0], "s0", "l0"),
                                 (specs[0][1], specs[1][1], "s1", "l1")):
        scale = np.exp(a[sk])
        g = 0.5 / np.exp(a[lk]) ** 2
        cot = rng.normal(size=(scale.shape[0],) + mm3.shape)
        want = jkm.masked_block_stack(jspec, jnp.asarray(scale), jnp.asarray(g),
                                      jnp.asarray(xf), jnp.asarray(mm3))
        got = tkm.masked_block_stack(tspec, torch.tensor(scale), torch.tensor(g),
                                     torch.tensor(xf), torch.tensor(mm3))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-14)
        want_g = jkm.block_param_grads(jspec, jnp.asarray(scale), jnp.asarray(g),
                                       jnp.asarray(cot), jnp.asarray(xf), jnp.asarray(mm3))
        got_g = tkm.block_param_grads(tspec, torch.tensor(scale), torch.tensor(g),
                                      torch.tensor(cot), torch.tensor(xf), torch.tensor(mm3))
        _close([x.numpy() for x in got_g], [np.asarray(x) for x in want_g], rtol=1e-10,
               atol=1e-13)


def test_usable_gate():
    """f32, 2 <= T <= 128, both specs non-empty and within the table: one
    kernel shape covers the JAX package's full and split paths."""
    spec0, spec1 = tkx.split_kernel_spec(**SPEC_ARGS)
    kp0 = tkx.init_kernel_params(spec0, 3)

    def can(t, dtype=torch.float32, s0=spec0, s1=spec1):
        return bc.usable(s0, s1, kp0, torch.zeros((3, t, 4), dtype=dtype))

    assert all(can(t) for t in (2, 20, 64, 65, 128))
    assert not can(1) and not can(129)
    assert not can(20, torch.float64)
    empty = tkx.KernelSpec(components=())
    assert not can(20, s0=empty) and not can(20, s1=empty)
    wide = tkx.KernelSpec(components=spec1.components * 9)  # 18 > 16 components
    assert not can(20, s1=wide)
    with pytest.raises(ValueError):
        bc.spec_table(spec0, wide)


def test_spec_table_layout():
    spec0, spec1 = cat_mod_specs(tkx)
    table = bc.spec_table(spec0, spec1)
    row = 2 + bc.MAX_EQ + 1 + bc.MAX_AND + 2
    assert len(table) == 4 * row
    # cat_mod (1, 4) on spec0's first component; spec1's second has eq (2,), and (3,)
    assert table[:row] == [-1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 4]
    assert table[3 * row:] == [0, 1, 2, 0, 0, 0, 1, 3, 0, 0, 0, -1, 0]


def test_cpu_operators_take_the_plain_chain():
    """gp_block_operators on a CPU f32 batch inside usable()'s shapes takes
    the plain chain: no launch, the K0/B stacks kept, no folded trace."""
    specs, a = make_case("ragged", np.float32)
    spec0, spec1, kp0, kp1, noise, xb, mask = torch_args(specs, torch_leaves(a), a)
    assert bc.usable(spec0, spec1, kp0, xb)
    before = bc.b_chain.launches
    z = torch.tensor(a["xb"][0])
    with torch.no_grad():
        ops = teb.gp_block_operators(spec0, spec1, kp0, kp1, noise, xb, z, mask=mask, eps=1e-4)
    assert bc.b_chain.launches == before
    assert ops.tr_iB_K0 is None and ops.K0_st is not None and ops.B is not None
    ib, ld, tr = bc.b_chain_operators(spec0, spec1, kp0, kp1, noise, xb, mask)
    torch.testing.assert_close(ops.iB, ib.detach(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(ops.logdet_B, ld.detach(), rtol=1e-5, atol=1e-6)

"""The work counts at the shapes PERF.md's kernel table lists, and one
ConvVAE layer's operations by hand."""

import math

import pytest

from perfbench import counts


def test_k1_b_chain_bound_at_the_training_batch():
    # [L=32, S=20, T=20], 6 covariates, 3 + 2 components: bytes bound it
    assert counts.b_chain_bound_ms(32, 20, 20, 6, 3, 2) == pytest.approx(0.000311, rel=2e-3)


@pytest.mark.parametrize("shape,ms", [((32, 60, 60), 0.000413), ((64, 60, 60), 0.000825),
                                      ((32, 100, 20, 20), 0.00459)])
def test_k2_chol_inv_bound(shape, ms):
    assert counts.chol_inv_bound_ms(shape) == pytest.approx(ms, rel=2e-3)


def test_k3_kernel_matrix_bound_at_the_closed_prior():
    # [32, 2000, 2000], 5 components of which 4 squared-exponential
    assert counts.kernel_matrix_bound_ms(32, 2000, 2000, 6, 5, 4) == pytest.approx(0.153, rel=3e-3)


def test_conv2_operations_by_hand():
    layers = dict(counts.conv_vae_layers(32, 36))
    # 18×18 outputs, 32 channels out, 16 in, a 3×3 window: a multiply and an add each
    assert layers["conv2"] == 2 * 18 * 18 * 32 * 16 * 3 * 3 == 2_985_984
    # the first transposed convolution: 9×9 inputs, 32 in, 16 out, a 4×4 window
    assert layers["deconv1"] == 2 * 9 * 9 * 32 * 16 * 4 * 4


def test_training_counts_backward_twice_but_the_first_convolution_once():
    fwd = counts.vae_flops(32, 36, 1, 1, train=False)
    conv1 = dict(counts.conv_vae_layers(32, 36))["conv1"]
    assert counts.vae_flops(32, 36, 1, 1, train=True) == 3 * fwd - conv1


def test_closed_step_is_dominated_by_the_n_cubed_algebra():
    cfg = {"latent_dim": 32, "P": 100, "T": 20, "num_dim": 1296}
    n = 2000
    gp = 3 * 32 * (n ** 3 + 2 * n * n)
    assert counts.closed_step_flops(cfg) == pytest.approx(
        gp + counts.vae_flops(32, 36, n, n, True))
    assert math.isclose(counts.closed_step_flops(cfg) / 1e9, 816, rel_tol=0.01)

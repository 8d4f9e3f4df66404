"""Launch geometry of the component kernels K3 (``csrc/kernel_matrix.cu``)
and K4 (``csrc/block_pair.cu``), held on the CPU:
``kernels_cuda/km_plan.py`` is the one place of their tiles and walks, and
its ``k3_block_writes`` / ``k4_block_writes`` repeat the kernels' index
arithmetic store by store. Each walk must write every entry of its output
exactly once; the C entry points refuse a plan other than these."""

import numpy as np
import pytest
import torch

from lvae_torch.kernels_cuda import km_plan as kp

Q, C = 6, 5  # HealthMNIST covariates and joined components


def k3_counts(n_lat, n1, n2, symmetric):
    """The plan and how many times its whole grid writes each entry of
    ``K [L, N1, N2]``."""
    plan = kp.k3_plan(n_lat, n1, n2, Q, C, symmetric)
    count = np.zeros((n_lat, n1, n2), dtype=np.int32)
    for by in range(plan.grid_y):
        for bx in range(plan.grid_x):
            for l, i, j, cnt in kp.k3_block_writes(plan, n_lat, n1, n2, bx, by):
                count[l, i, j:j + cnt] += 1
    return plan, count


@pytest.mark.parametrize("n_lat,n1,n2", [
    (3, 70, 37),      # N1 != N2, neither a tile multiple, N2 % 4 != 0
    (2, 517, 1030),   # the card tests' odd shape: rows of 1030 floats are not 16-byte aligned
    (9, 33, 132),     # one row past a tile; N2 % 4 == 0 with a partial column tile
    (1, 1, 1),
    (1, 2000, 2000),  # the closed-KL prior's N
])
def test_k3_general_walk_writes_every_entry_once(n_lat, n1, n2):
    plan, count = k3_counts(n_lat, n1, n2, False)
    assert not plan.symmetric and plan.vec == (n2 % 4 == 0)
    assert (plan.grid_x, plan.grid_y) == (-(-n2 // kp.GEN_COLS), -(-n1 // kp.GEN_ROWS))
    assert (count == 1).all()


@pytest.mark.parametrize("n_lat,n", [
    (9, 70),    # latents past one staging chunk; a partial last tile
    (3, 37),    # N % 4 != 0: scalar stores, in place and transposed
    (2, 64),    # tile multiples
    (1, 1),
    (1, 2000),  # the closed-KL prior: 63 tiles a side, 2,016 blocks
    (8, 520),   # the card-vs-CPU replay's N, one full staging chunk
])
def test_k3_symmetric_walk_with_its_mirror_writes_every_entry_once(n_lat, n):
    plan, count = k3_counts(n_lat, n, n, True)
    tiles = kp.sym_tiles(n)
    assert plan.symmetric and plan.vec == (n % 4 == 0)
    assert (plan.grid_x, plan.grid_y) == (tiles * (tiles + 1) // 2, 1)
    assert (count == 1).all()


def test_k3_symmetric_walk_is_the_lower_triangle_diagonal_last():
    for tiles in (1, 2, 3, 17, 63, 200):
        walk = [kp.sym_tile(b, tiles) for b in range(tiles * (tiles + 1) // 2)]
        assert sorted(walk) == sorted((i, j) for i in range(tiles) for j in range(i + 1))
        off = tiles * (tiles - 1) // 2
        assert all(i > j for i, j in walk[:off]) and all(i == j for i, j in walk[off:])
    assert kp.k3_plan(32, 2000, 2000, Q, C, True).grid_x == 2016


def test_k3_symmetric_walk_needs_a_square():
    with pytest.raises(ValueError):
        kp.k3_plan(2, 600, 601, Q, C, True)


@pytest.mark.parametrize("symmetric", [False, True])
def test_k3_shared_memory_stays_within_a_block(symmetric):
    plan = kp.k3_plan(32, 2000, 2000, Q, C, symmetric)
    assert plan.smem == kp.k3_smem_bytes(32, C, Q, symmetric) <= kp.MAX_SMEM
    assert plan.smem <= kp.DEFAULT_SMEM  # the main path needs no raised limit
    # the largest L the gate passes still fits, the next does not
    n_lat = max(n for n in range(1, 4000) if kp.k3_fits(n, 16, Q))
    assert kp.k3_plan(n_lat, 600, 600, Q, 16, symmetric).smem <= kp.MAX_SMEM
    with pytest.raises(ValueError):
        kp.k3_plan(n_lat + 1, 600, 600, Q, 16, True)


def test_k3_component_buckets():
    assert [kp.component_bucket(c) for c in (1, 5, 6, 7, 8, 9, 16)] == [6, 6, 6, 8, 8, 16, 16]
    assert kp.k3_plan(2, 600, 600, Q, 5, True).bucket == 6  # the HealthMNIST spec
    assert kp.k3_plan(2, 600, 600, Q, 12, False).bucket == 16
    with pytest.raises(ValueError):
        kp.component_bucket(17)


def test_symmetric_decision_is_one_storage():
    x = torch.randn(40, Q)
    assert kp.same_storage(x, x)
    assert kp.same_storage(x, x[:])  # a view of the same rows
    assert not kp.same_storage(x, x.clone())
    assert not kp.same_storage(x, x[:39])
    y = torch.randn(Q, 40).t()  # same shape, other strides than its copy
    assert not kp.same_storage(y, y.contiguous())


def k4_counts(n_lat, n_subj, t):
    plan = kp.k4_plan(n_lat, n_subj, t)
    plane = n_subj * t * t
    count = np.zeros((n_lat, plane), dtype=np.int32)
    for by in range(plan.latents):
        for bx in range(plan.blocks):
            for l, s, t1, t2, cnt in kp.k4_block_writes(plan, n_subj, t, bx, by):
                assert 0 <= s < n_subj and 0 <= t1 < t and 0 <= t2 < t
                f = (s * t + t1) * t + t2
                count[l, f:f + cnt] += 1
    return plan, count


@pytest.mark.parametrize("n_subj,t", [(5, 2), (3, 3), (20, 20), (3, 37), (2, 128), (3, 150),
                                      (7, 3)])
@pytest.mark.parametrize("n_lat", [1, 5])
def test_k4_flat_walk_writes_every_entry_once(n_subj, t, n_lat):
    """Every (l, s, t1, t2) once, at T up to 150 and at S·T² % 4 != 0 (3·3²,
    3·37², 7·3²), where the quads cross subject boundaries and the last one
    is partial."""
    plan, count = k4_counts(n_lat, n_subj, t)
    assert plan.vec == ((n_subj * t * t) % 4 == 0)
    assert plan.blocks == -(-kp.k4_quads(n_subj, t) // kp.K4_THREADS)
    assert plan.latents == n_lat
    assert (count == 1).all()


def test_k4_plan_at_the_hensman_shape():
    """[L=32, S=20, T=20]: 2,000 threads along the plane (of 8 blocks' 2,048)
    a latent, 256 blocks in all."""
    plan = kp.k4_plan(32, 20, 20)
    assert plan == kp.K4Plan(vec=True, blocks=8, latents=32)
    assert kp.k4_quads(20, 20) == 2000


def test_k4_plan_refuses_what_the_kernel_cannot_index():
    assert kp.k4_fits(2, 32000) and not kp.k4_fits(2, 33000)
    with pytest.raises(ValueError):
        kp.k4_plan(4, 2, 33000)
    with pytest.raises(ValueError):
        kp.k4_plan(70000, 2, 20)  # beyond the grid's y limit

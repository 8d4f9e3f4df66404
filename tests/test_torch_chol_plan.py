"""Launch plans of the team-based kernels K2 (``csrc/chol_inv.cu``) and K1
(``csrc/b_chain.cu``), held on the CPU: ``kernels_cuda/chol_plan.py`` is the
one place of their geometry, and the C entry points refuse a plan that breaks
these rules. Parametrised over the team boundaries (warp teams up to 32, a
block team above) and over batches, not over every size."""

import pytest

from lvae_torch.kernels_cuda import b_chain as k1
from lvae_torch.kernels_cuda import chol_plan as cp
from lvae_torch.kernels_cuda import kernel_matrix as k3
from lvae_torch.ops import kernels as kx

BATCHES = [0, 1, 7, 256, 1061, 3200]  # 1,061: a last block of one warp team
Q = 6  # covariates of the HealthMNIST layout
SMS = 132  # an H100 SXM's SMs


def team_of_each_matrix(plan, batch):
    """Matrix index -> (block, team) as the kernels assign them: team w of
    block b owns matrix b * teams + w, if that is below the batch."""
    owners = {}
    for b in range(plan.blocks):
        for w in range(plan.teams):
            idx = b * plan.teams + w
            if idx < batch:
                owners.setdefault(idx, []).append((b, w))
    return owners


def check_geometry(plan, n, batch, team_floats, sms=SMS):
    owners = team_of_each_matrix(plan, batch)
    assert sorted(owners) == list(range(batch))
    assert all(len(o) == 1 for o in owners.values())  # each matrix exactly once
    assert plan.blocks == -(-batch // plan.teams)  # no empty block
    assert plan.threads == plan.team * plan.teams <= 1024
    assert plan.threads % cp.WARP == 0
    rows = cp.team_rows(n)
    assert rows >= n and plan.team % rows == 0  # every row has its threads
    if n > cp.WARP:
        assert plan.teams == 1 and rows in cp.BLOCK_ROWS
        lanes = plan.team // rows
        assert lanes & (lanes - 1) == 0 and lanes <= cp.WARP  # a row's lanes share a warp
    elif batch >= cp.WARP_TEAMS_AN_SM * sms:
        assert plan.team == cp.WARP  # packed warp teams fill the card
    else:
        assert (plan.team, plan.teams) == (cp.WARP * cp.SMALL_LANES, 1)
    assert plan.smem == plan.teams * 4 * team_floats
    assert plan.smem <= cp.MAX_SMEM
    # a small batch still spreads over the SMs
    assert plan.blocks >= min(batch, sms)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("n", [2, 20, 31, 32, 33, 60, 64])
def test_chol_inv_plan_covers_each_matrix_once(n, batch):
    plan = cp.chol_inv_plan(n, batch, SMS)
    check_geometry(plan, n, batch, cp.chol_team_floats(n))
    # chol_inv.cu never raises the block's shared-memory limit
    assert plan.smem <= cp.DEFAULT_SMEM


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("t", [2, 20, 32, 33, 64, 65, 128])
def test_b_chain_plan_covers_each_block_once(t, batch):
    plan = cp.b_chain_plan(t, batch, Q, SMS)
    check_geometry(plan, t, batch, cp.b_chain_team_floats(t, Q))
    # above 48 KB only for a block team, where b_chain.cu raises the limit
    assert plan.smem <= cp.DEFAULT_SMEM or t > cp.WARP


def test_training_shapes_get_the_expected_teams():
    """The main path's shapes: the fold's 3,200 20×20 matrices in packed
    warp teams; the request's 256, the M×M stacks and K1's 640 blocks in
    block teams, one a thread block."""
    fold, request = cp.chol_inv_plan(20, 3200, SMS), cp.chol_inv_plan(20, 256, SMS)
    assert (fold.team, fold.teams) == (cp.WARP, cp.MAX_WARP_TEAMS)
    assert request == cp.Plan(32 * cp.SMALL_LANES, 1, 256, 32 * cp.SMALL_LANES,
                              4 * cp.chol_team_floats(20))
    for batch in (32, 64):
        team = 64 * cp.LANES
        assert cp.chol_inv_plan(60, batch, SMS) == cp.Plan(team, 1, batch, team,
                                                      4 * cp.chol_team_floats(60))
    assert cp.b_chain_plan(20, 640, Q, SMS).team == 32 * cp.SMALL_LANES
    assert cp.b_chain_plan(128, 8, Q, SMS).smem > cp.DEFAULT_SMEM


@pytest.mark.parametrize("sms", [114, 132, 148])
def test_plans_follow_the_cards_sm_count(sms):
    """Warp teams from WARP_TEAMS_AN_SM matrices an SM on, packed only as far
    as the blocks still cover every SM; below that, block teams."""
    edge = cp.WARP_TEAMS_AN_SM * sms
    assert cp.chol_inv_plan(20, edge, sms).team == cp.WARP
    assert cp.chol_inv_plan(20, edge - 1, sms).team == cp.WARP * cp.SMALL_LANES
    assert cp.b_chain_plan(20, edge, Q, sms).team == cp.WARP
    for batch in (edge, 2 * edge + 1, 3200 * 4):
        plan = cp.chol_inv_plan(20, batch, sms)
        check_geometry(plan, 20, batch, cp.chol_team_floats(20), sms)


@pytest.mark.parametrize("n", [0, 1, 65, 128])
def test_chol_inv_plan_rejects_sizes_outside_the_kernel(n):
    with pytest.raises(ValueError):
        cp.chol_inv_plan(n, 4, SMS)


@pytest.mark.parametrize("t", [0, 1, 129, 256])
def test_b_chain_plan_rejects_sizes_outside_the_kernel(t):
    with pytest.raises(ValueError):
        cp.b_chain_plan(t, 4, Q, SMS)


def test_plans_reject_a_negative_batch_and_an_oversized_team():
    with pytest.raises(ValueError):
        cp.chol_inv_plan(20, -1, SMS)
    with pytest.raises(ValueError):
        cp.b_chain_plan(20, 4, 0, SMS)
    with pytest.raises(ValueError):  # covariates past a block's shared memory
        cp.b_chain_plan(128, 4, 400, SMS)


@pytest.mark.parametrize("max_teams", [1, 2, 4, 8])
def test_swept_warp_plans_stay_within_the_rules(max_teams):
    """The plans of the team sweep (PERF.md §6) and of the card tests obey
    the same rules."""
    for n, batch in ((20, 3200), (20, 3201), (20, 256), (32, 3200)):
        plan = cp.make_plan(n, batch, cp.chol_team_floats(n), SMS, max_warp_teams=max_teams,
                            lanes=1)
        assert plan.team == cp.WARP and plan.teams <= max_teams
        assert plan.smem <= cp.DEFAULT_SMEM and plan.threads == plan.teams * cp.WARP
        assert plan.blocks == -(-batch // plan.teams)


@pytest.mark.parametrize("n,rows", [(2, 32), (32, 32), (33, 64), (64, 64), (65, 128), (128, 128)])
def test_team_rows_give_each_row_its_threads(n, rows):
    assert cp.team_rows(n) == rows


def test_no_team_takes_more_than_128_rows():
    with pytest.raises(ValueError):
        cp.team_rows(129)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16])
def test_swept_block_plans_stay_within_the_rules(lanes):
    """The block-team plans of the sweep (PERF.md §6) obey the same rules."""
    for n, batch in ((60, 32), (64, 64), (20, 256), (20, 640)):
        if n <= cp.WARP and lanes == 1:
            continue  # one lane a row of 32 is a warp team
        plan = cp.make_plan(n, batch, cp.chol_team_floats(n), SMS, lanes=lanes)
        rows = cp.team_rows(n)
        assert plan.threads == plan.team == rows * lanes and plan.teams == 1
        assert plan.blocks == batch and plan.smem == 4 * cp.chol_team_floats(n)


@pytest.mark.parametrize("lanes", [0, 3, 32])
def test_plans_reject_lanes_that_make_no_block_team(lanes):
    with pytest.raises(ValueError):
        cp.make_plan(60, 32, cp.chol_team_floats(60), SMS, lanes=lanes)


def test_b_chain_spec_table_is_built_once_per_pair_of_specs():
    spec0, spec1 = kx.split_kernel_spec(
        cat_kernel=[2], sqexp_kernel=[0],
        cat_int_kernel=[{"cont_covariate": 0, "cat_covariate": 3}], id_covariate=2)
    first = k1._table(spec0, spec1)
    assert k1._table(spec0, spec1) is first
    assert list(first) == k3.spec_table(spec0, spec1)

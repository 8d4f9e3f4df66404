"""Launch plans of the team-based factorisation kernels K2 and K1.

Both kernels (``csrc/chol_inv.cu``, ``csrc/b_chain.cu``) give each matrix to
a *team* of threads (``csrc/chol_common.cuh``): for a large batch of
``n <= 32``, one warp, one thread a row, several teams a block; otherwise a
whole block, 32, 64 or 128 rows (``n`` up to that; 128 for K1 only) of
several threads each. This
module is the one place of their launch geometry: the wrappers pass a
:class:`Plan` to the C entry points, which check it and refuse
(``cudaErrorInvalidValue``) a plan they do not take. Nothing here touches a
device but :func:`num_sms`, so the CPU tests hold every plan (with an
H100 SXM's 132 SMs).

``MAX_WARP_TEAMS``, ``LANES``, ``WARP_TEAMS_AN_SM`` and ``SMALL_LANES`` were
fixed from one sweep on an H100 at the main path's shapes (PERF.md §6
records it).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import torch

from lvae_torch.ops import linalg as la

WARP = 32
BLOCK_ROWS = (64, 128)  # the rows a block team covers: n up to 64, or up to 128
DEFAULT_SMEM = 48 * 1024  # a block's dynamic shared memory without raising its limit
MAX_SMEM = 232448  # bytes of shared memory a block can have on Hopper

MAX_WARP_TEAMS = 4  # warp teams a block, at most
LANES = 8  # threads a row (and a column of L⁻¹) in a block team (n > 32)
# n <= 32: a batch of at least WARP_TEAMS_AN_SM matrices an SM fills the
# card, and packed warp teams issue the fewest instructions; a smaller batch
# is bound by one matrix's chain, and a block team of 32 rows x SMALL_LANES
# threads shortens it
WARP_TEAMS_AN_SM = 8
SMALL_LANES = 4

K2_MIN_N, K2_MAX_N = la.KERNEL_MIN_N, la.KERNEL_MAX_N
K1_MIN_T, K1_MAX_T = 2, 128


class Plan(NamedTuple):
    """``team`` threads own a matrix, ``teams`` teams a block of ``threads``
    threads, ``blocks`` blocks, ``smem`` bytes of dynamic shared memory a
    block."""

    team: int
    teams: int
    blocks: int
    threads: int
    smem: int


def chol_team_floats(n: int) -> int:
    """Shared floats of one team's matrix (``chol_common.cuh``): A (then L,
    with A⁻¹'s strict lower triangle transposed above it) and M = L⁻¹ (the
    factor's column buffers before it), each ``n × (n+1)``, and A⁻¹'s
    diagonal."""
    return 2 * n * (n + 1) + n


def b_chain_team_floats(t: int, q: int) -> int:
    """K1's team: the matrices, the covariates ``[T, Q]``, the mask and 32
    floats of trace partials (``b_chain.cu``)."""
    return chol_team_floats(t) + t * q + t + WARP


def team_rows(n: int) -> int:
    """Rows the team of an ``n × n`` matrix covers: a warp's 32, or a block
    team's 64 or 128 (``lvae::team_rows``)."""
    for rows in (WARP, *BLOCK_ROWS):
        if n <= rows:
            return rows
    raise ValueError(f"no team takes n={n} > {BLOCK_ROWS[-1]}")


@functools.lru_cache(maxsize=16)
def num_sms(device: torch.device) -> int:
    """The SM count of the CUDA device the wrappers launch on."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def make_plan(n: int, batch: int, team_floats: int, sms: int,
              max_warp_teams: int = MAX_WARP_TEAMS, lanes: Optional[int] = None) -> Plan:
    """The plan for ``batch`` matrices of size ``n`` on a card of ``sms``
    SMs. With ``lanes`` 1 (the default for ``n <= 32`` and a batch of
    ``WARP_TEAMS_AN_SM · sms`` or more): warp teams, one thread a row, as many
    a block as still leaves ``sms`` blocks or more (at most
    ``max_warp_teams``, and within the 48 KB default).
    Otherwise (by default ``SMALL_LANES`` for a smaller batch of ``n <= 32``,
    ``LANES`` for ``n > 32``): one block team a block, ``team_rows(n)`` rows of
    ``lanes`` threads (a power of two; at most 1024 threads)."""
    if batch < 0:
        raise ValueError(f"batch must be >= 0, got {batch}")
    rows = team_rows(n)
    if lanes is None:
        if rows == WARP:
            lanes = 1 if batch >= WARP_TEAMS_AN_SM * sms else SMALL_LANES
        else:
            lanes = LANES
    team_bytes = 4 * team_floats
    teams = 1
    if lanes == 1 and rows == WARP:
        team = WARP
        teams = max(1, min(max_warp_teams, batch // sms, DEFAULT_SMEM // team_bytes))
    else:
        if lanes < 1 or lanes & (lanes - 1) or rows * lanes > 1024:
            raise ValueError(f"{lanes} lanes a row do not make a block team of {rows} rows")
        team = rows * lanes
    smem = teams * team_bytes
    if smem > MAX_SMEM:
        raise ValueError(f"a team needs {team_bytes} bytes of shared memory, above {MAX_SMEM}")
    return Plan(team=team, teams=teams, blocks=-(-batch // teams), threads=team * teams,
                smem=smem)


@functools.lru_cache(maxsize=256)
def chol_inv_plan(n: int, batch: int, sms: int) -> Plan:
    """K2's plan for ``batch`` SPD matrices ``n × n``, ``2 <= n <= 64``, on
    a card of ``sms`` SMs; within the 48 KB default (``chol_inv.cu`` never
    raises the limit)."""
    if not K2_MIN_N <= n <= K2_MAX_N:
        raise ValueError(f"cholesky_inverse kernel takes {K2_MIN_N} <= n <= {K2_MAX_N}, got n={n}")
    return make_plan(n, batch, chol_team_floats(n), sms)


@functools.lru_cache(maxsize=256)
def b_chain_plan(t: int, batch: int, q: int, sms: int) -> Plan:
    """K1's plan for ``batch = L·S`` blocks of ``T`` frames with ``q``
    covariates, ``2 <= T <= 128``, on a card of ``sms`` SMs; a block team
    may take up to 227 KB
    (``b_chain.cu`` raises the block's limit above 48 KB)."""
    if not K1_MIN_T <= t <= K1_MAX_T:
        raise ValueError(f"b_chain kernel takes {K1_MIN_T} <= T <= {K1_MAX_T}, got T={t}")
    if q < 1:
        raise ValueError(f"b_chain kernel needs q >= 1 covariates, got {q}")
    return make_plan(t, batch, b_chain_team_floats(t, q), sms)


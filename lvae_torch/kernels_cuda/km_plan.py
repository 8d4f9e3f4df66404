"""Launch geometry of the component kernels K3 (``csrc/kernel_matrix.cu``)
and K4 (``csrc/block_pair.cu``).

This module is the one place of their tiles, walks, vector width and
shared-memory bytes: the wrappers pass a plan to the C entry points, which
recompute it and refuse (``cudaErrorInvalidValue``) a plan they do not
take, as ``chol_plan.py`` does for K1 and K2. Nothing here touches a
device, so the CPU tests hold every walk; :func:`k3_block_writes` and
:func:`k4_block_writes` repeat the kernels' index arithmetic store by store
for them.

**K3**, ``K [L, N1, N2]``. A block of ``THREADS`` threads owns a tile; a
thread owns ``VEC`` consecutive columns of one row at a time and stores
each latent's four entries with one 16-byte store where the row allows it
(``N2 % 4 == 0``; a scalar store per entry otherwise).

* The general walk: tiles of ``GEN_ROWS × GEN_COLS``, a warp a row and its
  32 lanes four columns each, grid ``(⌈N2 / GEN_COLS⌉, ⌈N1 / GEN_ROWS⌉)``.
* The symmetric walk, when ``x1`` and ``x2`` are one tensor: square tiles of
  ``SYM_TILE`` rows, a thread a row's four columns, only tiles ``I >= J``
  (off-diagonal tiles first, the diagonal ones last), one block a tile. An
  off-diagonal tile is written in place and, through a shared buffer of
  ``SYM_LAT`` latents, transposed at ``(J, I)``. Every factor of
  ``component.cuh`` is bitwise symmetric in its two rows, so the mirrored
  entries are those the general walk computes there.

**K4**, both stacks ``[L, S, T, T]``. A flat walk over the ``S·T·T`` plane:
a thread owns ``VEC`` consecutive flat entries (which may cross a subject
boundary) of one latent, with no shared memory and no barrier; grid
``(⌈⌈S·T·T / 4⌉ / K4_THREADS⌉, L)``. One latent a thread keeps each
thread's chain shortest: on an H100 at the Hensman shape two or four
latents a thread took longer (PERF.md §6).
"""

from __future__ import annotations

import math
from typing import Iterator, NamedTuple, Tuple

import torch

VEC = 4  # entries a thread stores at once (one float4)
MAX_SMEM = 232448  # bytes of shared memory a block can have on Hopper
DEFAULT_SMEM = 48 * 1024  # a block's dynamic shared memory without raising its limit
MAX_GRID_Y = 65535
MAX_INT = 2**31 - 1

# K3
THREADS = 256
GEN_ROWS, GEN_COLS = 8, 128  # general tile: a warp a row, 32 lanes x 4 columns
SYM_TILE = 32  # symmetric tile: 32 rows x 8 threads of 4 columns
SYM_LAT = 8  # latents a symmetric block stages before its transposed store
SYM_STRIDE = SYM_TILE + 1  # the staging buffer's row stride, conflict-free both ways
K3_BUCKETS = (6, 8, 16)  # K3's factor arrays, compiled for each number of components

# K4
K4_THREADS = 256


def component_bucket(c: int) -> int:
    """The least of K3's factor-array sizes that holds ``c`` components."""
    for bucket in K3_BUCKETS:
        if c <= bucket:
            return bucket
    raise ValueError(f"kernel_matrix kernel takes at most {K3_BUCKETS[-1]} components, got {c}")


def same_storage(x1: torch.Tensor, x2: torch.Tensor) -> bool:
    """K3's symmetric decision: ``x1`` and ``x2`` are one tensor's storage
    (equal data pointer, shape and strides), so ``K(x1, x2)`` is symmetric.
    A copy takes the general walk."""
    return (x1.data_ptr() == x2.data_ptr() and x1.shape == x2.shape
            and x1.stride() == x2.stride() and x1.dtype == x2.dtype
            and x1.device == x2.device)


def vec_ok(n2: int) -> bool:
    """Whether K3's rows take 16-byte stores: every row starts 16-byte
    aligned when ``N2 % 4 == 0`` (the output is a fresh allocation)."""
    return n2 % VEC == 0


class K3Plan(NamedTuple):
    """``symmetric`` walk (else general); grid ``(grid_x, grid_y)`` of
    ``THREADS`` threads; 16-byte stores if ``vec``; ``smem`` bytes of
    dynamic shared memory a block; factor arrays of ``bucket``
    components."""

    symmetric: bool
    vec: bool
    grid_x: int
    grid_y: int
    smem: int
    bucket: int


def k3_smem_bytes(n_lat: int, c: int, q: int, symmetric: bool) -> int:
    """The parameters ``scale, g [L, C]``, the tile's rows of x1 and columns
    of x2 (``[rows, Q]`` and ``[Q, cols]``), and for the symmetric walk the
    staging buffer ``[SYM_LAT, SYM_TILE, SYM_STRIDE]``."""
    if symmetric:
        tile = 2 * SYM_TILE * q + SYM_LAT * SYM_TILE * SYM_STRIDE
    else:
        tile = (GEN_ROWS + GEN_COLS) * q
    return 4 * (2 * n_lat * c + tile)


def k3_fits(n_lat: int, c: int, q: int) -> bool:
    """Whether both walks' shared memory holds ``L`` latents' parameters
    of ``C`` components and ``Q`` covariates."""
    return max(k3_smem_bytes(n_lat, c, q, sym) for sym in (False, True)) <= MAX_SMEM


def sym_tiles(n: int) -> int:
    """Tiles along each side of the symmetric walk."""
    return -(-n // SYM_TILE)


def sym_tile(b: int, tiles: int) -> Tuple[int, int]:
    """Tile ``(I, J)``, ``I >= J``, of symmetric block ``b``: the
    ``tiles·(tiles−1)/2`` off-diagonal tiles row by row, then the diagonal
    (``kernel_matrix.cu``'s ``sym_tile``)."""
    off = tiles * (tiles - 1) // 2
    if b >= off:
        return b - off, b - off
    i = int((1.0 + math.sqrt(1.0 + 8.0 * b)) / 2.0)
    while i * (i - 1) // 2 > b:
        i -= 1
    while (i + 1) * i // 2 <= b:
        i += 1
    return i, b - i * (i - 1) // 2


def k3_plan(n_lat: int, n1: int, n2: int, q: int, c: int, symmetric: bool) -> K3Plan:
    """K3's plan; ``symmetric`` needs ``N1 == N2`` (the wrapper sets it from
    :func:`same_storage`). Raises ``ValueError`` where the kernel has no
    plan: shared memory beyond ``MAX_SMEM``, or a grid beyond its limits."""
    if symmetric and n1 != n2:
        raise ValueError(f"a symmetric kernel matrix is square, got {n1} x {n2}")
    bucket = component_bucket(c)
    smem = k3_smem_bytes(n_lat, c, q, symmetric)
    if smem > MAX_SMEM:
        raise ValueError(f"kernel_matrix kernel: L={n_lat}, C={c}, Q={q} need {smem} bytes "
                         f"of shared memory, above {MAX_SMEM}")
    if symmetric:
        t = sym_tiles(n1)
        grid = (t * (t + 1) // 2, 1)
    else:
        grid = (-(-n2 // GEN_COLS), -(-n1 // GEN_ROWS))
    if grid[0] > MAX_INT or grid[1] > MAX_GRID_Y:
        raise ValueError(f"kernel_matrix kernel: {n1} x {n2} exceeds the grid's limits")
    return K3Plan(symmetric, vec_ok(n2), grid[0], grid[1], smem, bucket)


def _row_quads(j: int, n2: int, vec: bool) -> Iterator[Tuple[int, int]]:
    """(first column, count) of the stores of a thread's ``VEC`` columns
    from ``j``: one 16-byte store of four, or one a valid column."""
    valid = max(0, min(VEC, n2 - j))
    if vec and valid == VEC:
        yield j, VEC
    else:
        for k in range(valid):
            yield j + k, 1


def k3_block_writes(plan: K3Plan, n_lat: int, n1: int, n2: int, bx: int,
                    by: int = 0) -> Iterator[Tuple[int, int, int, int]]:
    """Every store of K3's block ``(bx, by)`` as ``(l, i, j, count)``: the
    ``count`` entries ``K[l, i, j:j+count]``, in the kernel's thread and
    latent order."""
    if plan.symmetric:
        t = sym_tiles(n1)
        ti, tj = sym_tile(bx, t)
        i0, j0 = ti * SYM_TILE, tj * SYM_TILE
        mirror = ti != tj
        for l0 in range(0, n_lat, SYM_LAT):
            for tid in range(THREADS):  # in place
                i, j = i0 + tid // 8, j0 + (tid % 8) * VEC
                if i < n1:
                    for l in range(l0, min(l0 + SYM_LAT, n_lat)):
                        for jj, cnt in _row_quads(j, n2, plan.vec):
                            yield l, i, jj, cnt
            if mirror:
                for tid in range(THREADS):  # transposed: row j0 + r, columns from i0
                    row, col = j0 + tid // 8, i0 + (tid % 8) * VEC
                    for l in range(l0, min(l0 + SYM_LAT, n_lat)):
                        for cc, cnt in _row_quads(col, n2, plan.vec):
                            yield l, row, cc, cnt
        return
    for tid in range(THREADS):
        i, j = by * GEN_ROWS + tid // 32, bx * GEN_COLS + (tid % 32) * VEC
        if i >= n1 or j >= n2:
            continue
        for l in range(n_lat):
            for jj, cnt in _row_quads(j, n2, plan.vec):
                yield l, i, jj, cnt


class K4Plan(NamedTuple):
    """16-byte stores if ``vec``; grid ``(blocks, latents)`` of
    ``K4_THREADS`` threads, a latent a block row."""

    vec: bool
    blocks: int
    latents: int


def k4_quads(n_subj: int, t: int) -> int:
    """Threads along the flat ``S·T·T`` plane: four entries each."""
    return -(-(n_subj * t * t) // VEC)


def k4_fits(n_subj: int, t: int) -> bool:
    """Whether the flat walk's 32-bit indices cover ``S·T·T``."""
    return n_subj * t * t + VEC <= MAX_INT


def k4_plan(n_lat: int, n_subj: int, t: int) -> K4Plan:
    """K4's plan. Raises ``ValueError`` where the 32-bit flat index or the
    grid cannot hold the stacks."""
    if not k4_fits(n_subj, t):
        raise ValueError(f"block_pair kernel: S·T·T = {n_subj * t * t} exceeds its "
                         "32-bit flat index")
    if n_lat > MAX_GRID_Y:
        raise ValueError(f"block_pair kernel: L={n_lat} exceeds the grid's limit")
    return K4Plan((n_subj * t * t) % VEC == 0, -(-k4_quads(n_subj, t) // K4_THREADS), n_lat)


def k4_block_writes(plan: K4Plan, n_subj: int, t: int, bx: int,
                    by: int) -> Iterator[Tuple[int, int, int, int, int]]:
    """Every store of K4's block ``(bx, by)`` into each stack as ``(l, s,
    t1, t2, count)``: ``count`` flat entries from ``(s, t1, t2)`` of latent
    ``l = by``, with the kernel's decoding of the flat index."""
    plane = n_subj * t * t
    for tid in range(K4_THREADS):
        f = (bx * K4_THREADS + tid) * VEC
        if f >= plane:
            continue
        valid = min(VEC, plane - f)
        s, rem = divmod(f, t * t)
        t1, t2 = divmod(rem, t)
        decoded = [(s, t1, t2)]
        for _ in range(1, valid):  # the kernel's carry from t2 to t1 to s
            t2 += 1
            if t2 == t:
                t2, t1 = 0, t1 + 1
                if t1 == t:
                    t1, s = 0, s + 1
            decoded.append((s, t1, t2))
        if plan.vec and valid == VEC:
            yield (by, *decoded[0], VEC)
        else:
            for e in decoded:
                yield (by, *e, 1)

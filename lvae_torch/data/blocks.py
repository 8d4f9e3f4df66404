"""Subject blocking: static-shape batching over longitudinal subjects.

A copy of the numpy-only part of ``lvae_tpu/data/blocks.py``: a padded
per-subject index table ``[P, T_max]`` with a validity mask, its partition
into T-length buckets for ragged cohorts, and the scatter of per-block values
back to flat rows.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np


class SubjectBlocks(NamedTuple):
    """Padded per-subject sample-index table for one dataset.

    ``index [P, T_max]`` — row indices into the flat dataset (0 on padding),
    ``mask  [P, T_max]`` — 1 where the slot holds a real sample,
    ``subject_ids [P]``  — subject id value per block row (first-appearance
                           order, matching utils.py:61-87),
    ``t_lens [P]``       — true number of samples per subject.
    """

    index: np.ndarray
    mask: np.ndarray
    subject_ids: np.ndarray
    t_lens: np.ndarray

    @property
    def num_subjects(self) -> int:
        return self.index.shape[0]

    @property
    def t_max(self) -> int:
        return self.index.shape[1]


def build_subject_blocks(
    labels: np.ndarray,
    id_covariate: int,
    t_max: Optional[int] = None,
) -> SubjectBlocks:
    """Group sample rows by the id covariate, in order of first appearance."""
    ids = np.asarray(labels)[:, id_covariate]
    order: dict = {}
    members: list = []
    for i, s in enumerate(ids):
        key = float(s)
        if key not in order:
            order[key] = len(members)
            members.append([])
        members[order[key]].append(i)
    p = len(members)
    t_lens = np.asarray([len(m) for m in members], dtype=np.int32)
    if t_max is None:
        t_max = int(t_lens.max())
    elif t_max < t_lens.max():
        raise ValueError(f"t_max={t_max} < longest subject ({t_lens.max()})")
    index = np.zeros((p, t_max), dtype=np.int32)
    mask = np.zeros((p, t_max), dtype=np.float32)
    for r, m in enumerate(members):
        index[r, : len(m)] = m
        mask[r, : len(m)] = 1.0
    subject_ids = np.asarray([float(ids[m[0]]) for m in members])
    return SubjectBlocks(index=index, mask=mask, subject_ids=subject_ids, t_lens=t_lens)


def bucket_boundaries(t_lens: np.ndarray, max_buckets: int) -> List[int]:
    """Choose at most ``max_buckets`` T-length caps for a ragged cohort.

    Starting from the distinct subject lengths, repeatedly merge the adjacent
    pair of caps whose merge adds the least padded-Cholesky work
    (Σ over the lower cap's subjects of T_upper³ − T_s³) until at most
    ``max_buckets`` caps remain. Returns sorted inclusive caps; the last is
    ``max(t_lens)``.
    """
    t_lens = np.asarray(t_lens, dtype=np.int64)
    caps = sorted(set(int(t) for t in t_lens))
    if max_buckets < 1:
        raise ValueError(f"max_buckets must be >= 1, got {max_buckets}")
    counts = {c: int(np.sum(t_lens == c)) for c in caps}
    # members[i]: the (length, count) pairs assigned to caps[i]
    members = [[(c, counts[c])] for c in caps]
    while len(caps) > max_buckets:
        best_i, best_cost = 0, None
        for i in range(len(caps) - 1):
            upper = caps[i + 1]
            cost = sum(n * (upper**3 - t**3) for t, n in members[i])
            if best_cost is None or cost < best_cost:
                best_i, best_cost = i, cost
        members[best_i + 1] = members[best_i] + members[best_i + 1]
        del caps[best_i], members[best_i]
    return caps


def bucket_subject_blocks(
    blocks: SubjectBlocks,
    max_buckets: int,
    caps: Optional[Sequence[int]] = None,
) -> List[SubjectBlocks]:
    """Partition a ragged cohort into T-length buckets: each returned table
    holds the subjects whose length falls in its cap's band, padded only to
    that cap. Buckets are ordered by ascending cap and non-empty. The masked
    padding keeps every bound exact whatever the cap, so bucketing changes
    the cost, never the values."""
    if caps is None:
        caps = bucket_boundaries(blocks.t_lens, max_buckets)
    caps = sorted(int(c) for c in caps)
    if caps[-1] < int(blocks.t_lens.max()):
        raise ValueError(
            f"largest cap {caps[-1]} < longest subject ({blocks.t_lens.max()})"
        )
    out: List[SubjectBlocks] = []
    assigned = np.zeros(blocks.num_subjects, dtype=bool)
    for cap in caps:
        sel = (~assigned) & (blocks.t_lens <= cap)
        assigned |= sel
        rows = np.flatnonzero(sel)
        if rows.size == 0:
            continue
        out.append(
            SubjectBlocks(
                index=blocks.index[rows, :cap].copy(),
                mask=blocks.mask[rows, :cap].copy(),
                subject_ids=blocks.subject_ids[rows].copy(),
                t_lens=blocks.t_lens[rows].copy(),
            )
        )
    return out


def scatter_to_flat(
    values_b: np.ndarray, index: np.ndarray, mask: np.ndarray, n: int
) -> np.ndarray:
    """Scatter per-block values ``[P, T, ...]`` back to flat rows ``[N, ...]``.

    The block axes must LEAD (matching ``index``'s shape); trailing feature
    axes are free. Leading batch axes are not supported — pass e.g.
    ``[P, T, L]``, not ``[L, P, T]`` (the layout of ops/predict.py).
    """
    flat_idx = index.reshape(-1)
    flat_mask = mask.reshape(-1).astype(bool)
    out = np.zeros((n,) + values_b.shape[len(index.shape):], dtype=values_b.dtype)
    vals = values_b.reshape((-1,) + values_b.shape[len(index.shape):])
    out[flat_idx[flat_mask]] = vals[flat_mask]
    return out

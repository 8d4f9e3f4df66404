"""Subject blocking: static-shape batching over longitudinal subjects.

A copy of the numpy-only part of ``lvae_tpu/data/blocks.py`` that serving
needs: a padded per-subject index table ``[P, T_max]`` with a validity mask,
and the scatter of per-block values back to flat rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

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

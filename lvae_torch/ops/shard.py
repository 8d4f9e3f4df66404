"""How a computation sees the cohort: the whole of it, or one rank's shard.

The GP bounds, the natural gradients and the posterior sum over subjects
and over latent dims, and a few of their steps read a mean over every
latent (the f32 jitters) or a logical AND over them (the natural-gradient
guard). Those functions take a ``view`` and route each such reduction
through it. :data:`LOCAL`, the default, holds every subject and latent, so
each reduction is the identity and the arithmetic is that of one process.
``lvae_torch.parallel.mesh.RankView`` holds one rank's subjects and latents
and turns the same reductions into collectives over the mesh.
"""

from __future__ import annotations

import torch


class Local:
    """The view of one process that holds every subject and latent."""

    rows = slice(None)  # this rank's subjects (of a subject axis)
    lat = slice(None)  # this rank's latent dims (of a latent axis)

    def data_sums(self, *ts: torch.Tensor):
        """Each tensor, a sum over this rank's subjects, summed over the
        ranks that share its latents (one collective for all)."""
        return ts

    def latent_mean(self, total: torch.Tensor, count: int) -> torch.Tensor:
        """``total / count`` where both are sums over this rank's latents."""
        return total / count

    def all_latents(self, ok: torch.Tensor) -> torch.Tensor:
        """Logical AND of a device boolean over every rank's latents."""
        return ok

    def gather_rows(self, t: torch.Tensor, n: int, dim: int = 0) -> torch.Tensor:
        """The whole subject axis ``dim`` (length ``n``) from this rank's rows."""
        return t

    def gather_latents(self, t: torch.Tensor, n: int, dim: int = 0) -> torch.Tensor:
        """The whole latent axis ``dim`` (length ``n``) from this rank's latents."""
        return t

    def frames(self, t: int) -> slice:
        """This rank's rows of a subject-major ``[P·T, ...]`` frame axis."""
        return slice(None)

    def weight(self, *axes: str) -> float:
        """1 where this rank counts a term summed over ``axes`` (of "data",
        "latent"), else 0: every term is counted on exactly one rank."""
        return 1.0

    def world_metrics(self, metrics):
        """A NamedTuple of this rank's shares of the metrics, summed over
        every rank."""
        return metrics

    def sum_grads(self, params) -> None:
        """Sum each parameter's ``.grad`` over every rank, in place."""

    def latent_shard(self, state):
        """This rank's latents of a Hensman state (``lat`` of each ``[L, ...]``
        leaf, as views)."""
        return state


LOCAL = Local()

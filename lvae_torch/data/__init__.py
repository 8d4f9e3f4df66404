"""Data layer: subject blocking."""

from lvae_torch.data.blocks import SubjectBlocks, build_subject_blocks  # noqa: F401

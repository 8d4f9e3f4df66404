"""lvae_torch — the PyTorch/CUDA port of lvae_tpu for NVIDIA Hopper.

Serves a trained longitudinal VAE: ConvVAE/SimpleVAE encoding and decoding,
the sparse additive-GP posterior over latent trajectories with a folded
cohort basis and a low-rank per-request extension, and a fixed-shape
serving bundle. Every CUDA kernel sits beside a plain PyTorch version that
runs when the tensors lie on the CPU. The package imports no JAX and nothing
of ``lvae_tpu``.
"""

__version__ = "0.1.0"

from lvae_torch.config import LVAEConfig, VAEConfig, load_flag_file  # noqa: F401

"""lvae_torch — the PyTorch/CUDA port of lvae_tpu for NVIDIA Hopper.

Trains and serves a longitudinal VAE: ConvVAE, SimpleVAE and RNN (LSTM or
GRU) encoding and decoding, the additive-GP prior with Hensman SVI, the
standard full-batch and the VI regimes, validation, test-set prediction
and generation, the reference-format CLI (``python -m lvae_torch.cli``) and
the reference's GP resume files; the sparse GP posterior
over latent trajectories with a folded cohort basis, a low-rank per-request
extension and a fixed-shape serving bundle. Every CUDA kernel sits beside a
plain PyTorch version that runs when the tensors lie on the CPU. The package
imports no JAX and nothing of ``lvae_tpu``.
"""

__version__ = "0.1.0"

from lvae_torch.config import LVAEConfig, VAEConfig, load_flag_file  # noqa: F401

"""VAE encoder/decoder families."""

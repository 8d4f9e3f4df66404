"""Dataset encoding and decoding."""

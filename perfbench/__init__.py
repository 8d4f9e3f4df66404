"""The benchmark of ``lvae_torch`` on the card: ``python3 perfbench/run.py``."""

"""Plain PyTorch reference of the benchmark's cells.

Written from the model's equations (Ramchandran et al., AISTATS 2021, and the
reference implementation's loss terms), in plain ``torch`` operations, with
no kernel, captured graph or batching scheme of the program. It imports
nothing of ``lvae_torch``, ``lvae_tpu`` or JAX, takes only what the
benchmark made from the seed (data, weights, GP parameters, inducing points,
the variational state) and works out again everything the program derives
from them: the random draws of its training steps.

``model``: the ConvVAE. ``gp``: the additive kernel and the KL bounds.
``steps``: three training steps of each regime.
"""

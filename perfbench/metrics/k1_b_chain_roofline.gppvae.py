"""Kernel K1's share of its roofline in the GPPVAE step: its least time at
the whole cohort's shape ``[L, P, T]`` (``counts.b_chain_bound_ms``), times
the calls of the traced window (the kernels named ``b_chain_*`` in its
device trace), over their device time; none where no such kernel ran."""

from perfbench import counts
from perfbench.inputs import COVARIATES
from perfbench.reference.gp import split_components

PATTERN = "b_chain_"


def read(run):
    busy = run.window.device_seconds(PATTERN)
    if busy is None:
        return None
    calls = sum(PATTERN in name for name, _, _ in run.window.device_ops)
    cfg = run.config
    c0, c1 = (len(c) for c in split_components(cfg))
    bound = counts.b_chain_bound_ms(cfg["latent_dim"], cfg["P"], cfg["T"], COVARIATES, c0, c1)
    return 100.0 * bound * 1e-3 * calls / busy

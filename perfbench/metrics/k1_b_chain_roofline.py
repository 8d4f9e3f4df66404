"""Kernel K1's share of its roofline in the Hensman step: its least time at
the batch's shape ``[L, S, T]`` (``counts.b_chain_bound_ms``), once a step,
times the steps of the traced window, over the device time of the kernels
named ``b_chain_*``; none where no such kernel ran."""

from perfbench import counts
from perfbench.inputs import COVARIATES
from perfbench.reference.gp import split_components

PATTERN = "b_chain_"


def read(run):
    busy = run.window.device_seconds(PATTERN)
    if busy is None:
        return None
    cfg = run.config
    c0, c1 = (len(c) for c in split_components(cfg))
    bound = counts.b_chain_bound_ms(cfg["latent_dim"], cfg["subjects_per_batch"], cfg["T"],
                                    COVARIATES, c0, c1)
    return 100.0 * bound * 1e-3 * run.work["steps"] / busy

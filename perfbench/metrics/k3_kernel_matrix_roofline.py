"""Kernel K3's share of its roofline in the closed-KL step: the prior
``[L, N, N]`` over the whole cohort once a step, at its least time
(``counts.kernel_matrix_bound_ms``), times the steps of the traced window,
over the device time of the kernels named ``kernel_matrix_*``; none where no
such kernel ran."""

from perfbench import counts
from perfbench.inputs import COVARIATES
from perfbench.reference.gp import split_components

PATTERN = "kernel_matrix_"


def read(run):
    busy = run.window.device_seconds(PATTERN)
    if busy is None:
        return None
    cfg = run.config
    comps = [c for part in split_components(cfg) for c in part]
    n = cfg["P"] * cfg["T"]
    bound = counts.kernel_matrix_bound_ms(cfg["latent_dim"], n, n, COVARIATES, len(comps),
                                          sum(c.rbf >= 0 for c in comps))
    return 100.0 * bound * 1e-3 * run.work["steps"] / busy

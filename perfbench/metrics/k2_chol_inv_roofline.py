"""Kernel K2's share of its roofline in the Hensman step: three
factorisations a step, ``[2L, M, M]`` (the inducing covariance and H
together) and twice ``[L, M, M]`` (the natural-gradient step's new H and its
check), each at its least time (``counts.chol_inv_bound_ms``), times the
steps of the traced window, over the device time of the kernels named
``chol_inv_*``; none where no such kernel ran."""

from perfbench import counts

PATTERN = "chol_inv_"


def read(run):
    busy = run.window.device_seconds(PATTERN)
    if busy is None:
        return None
    n_lat, m = run.config["latent_dim"], run.config["M"]
    bound = (counts.chol_inv_bound_ms((2 * n_lat, m, m))
             + 2 * counts.chol_inv_bound_ms((n_lat, m, m)))
    return 100.0 * bound * 1e-3 * run.work["steps"] / busy

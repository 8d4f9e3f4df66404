"""The share of the traced minibatch training window in which the device
idles while the innermost open span of the training loop is
``lvae.train.dispatch``: a chunk's replay loop (input copies, graph
launches, the step count). With ``idle_in_draws.train``,
``idle_in_read.train`` and the idle outside the loop's spans it makes up
``idle_share.train``."""

from perfbench import spans


def read(run):
    return spans.idle_share_under(run, ("lvae.train.dispatch",))

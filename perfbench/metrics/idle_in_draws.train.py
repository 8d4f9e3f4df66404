"""The share of the traced minibatch training window in which the device
idles while the innermost open span of the training loop is
``lvae.train.draws``: a chunk's permutations and noise drawn on the host
and copied to the device. With ``idle_in_dispatch.train``,
``idle_in_read.train`` and the idle outside the loop's spans it makes up
``idle_share.train``."""

from perfbench import spans


def read(run):
    return spans.idle_share_under(run, ("lvae.train.draws",))

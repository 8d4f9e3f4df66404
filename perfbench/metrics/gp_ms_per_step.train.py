"""Device milliseconds a minibatch training step spends in its GP part: the
median over the traced window's samples of the captured step's
``gp_forward`` and ``gp_backward`` phases, timed on the device by the
events the program records at the phase boundaries inside the graph."""

from perfbench import spans


def read(run):
    return spans.phase_ms(run, ("gp_forward", "gp_backward"))

"""Device milliseconds a minibatch training step spends in its update (the
zero-gradient fill, the optimizer, the natural-gradient step, the noise
pin): the median over the traced window's samples of the captured step's
``update`` phase, timed on the device by the events the program records
at the phase boundaries inside the graph."""

from perfbench import spans


def read(run):
    return spans.phase_ms(run, ("update",))

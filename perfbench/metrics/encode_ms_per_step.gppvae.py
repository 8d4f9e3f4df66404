"""Device milliseconds a GPPVAE step spends in its first phase, the no-grad
encode of the whole cohort: the median over the traced window's samples of
the captured step's ``encode`` phase, timed on the device by the events the
program records at the phase boundaries inside the graph."""

from perfbench import spans


def read(run):
    return spans.phase_ms(run, ("encode",))

"""Device milliseconds a GPPVAE step spends replaying the encoder a subject
at a time, each replay's decoder, reconstruction loss and backward with the
GP part's gradient spliced in: the median over the traced window's samples
of the captured step's ``replay`` phase, timed on the device by the events
the program records at the phase boundaries inside the graph."""

from perfbench import spans


def read(run):
    return spans.phase_ms(run, ("replay",))

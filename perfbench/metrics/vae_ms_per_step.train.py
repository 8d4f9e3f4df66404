"""Device milliseconds a minibatch training step spends in its ConvVAE: the
median over the traced window's samples of the captured step's
``vae_forward`` and ``vae_backward`` phases, timed on the device by the
events the program records at the phase boundaries inside the graph."""

from perfbench import spans


def read(run):
    return spans.phase_ms(run, ("vae_forward", "vae_backward"))

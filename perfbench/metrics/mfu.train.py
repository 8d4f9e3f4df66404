"""The minibatch training steps' share of the card's f32 peak: the
operations the traced window's steps need by the reference's algorithm
(``perfbench.counts``, through the regime's ``step_flops``), over the
window's length and 67 TFLOP/s."""

from perfbench import counts


def read(run):
    return 100.0 * run.work["flops"] / run.window.window_s / counts.F32_FLOPS_PER_S

"""The share of the traced full-batch training window in which no operation
ran on the device: one less the union of the device's operation intervals
over the window."""


def read(run):
    return 100.0 * (1.0 - run.window.busy_s / run.window.window_s)

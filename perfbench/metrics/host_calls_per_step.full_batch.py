"""CUDA runtime calls a full-batch training step makes on the host (kernel and
graph launches, copies, fills, waits), from the profiler's host events in
the traced window, over the steps it ran."""


def read(run):
    return sum(run.window.host_calls.values()) / run.work["steps"]

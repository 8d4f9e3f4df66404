"""Seconds from the process's start to the window: imports, the device,
the inputs, the program's construction, its captures and warm-up."""


def read(run):
    return run.work["setup_s"]

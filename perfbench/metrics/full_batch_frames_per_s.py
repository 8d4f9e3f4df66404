"""Frames (subject × timepoint rows) that every full-batch step of the
window trained on, over the window's start to its final device
synchronise."""


def read(run):
    return run.work["frames"] / run.work["seconds"]

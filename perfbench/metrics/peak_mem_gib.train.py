"""The device memory the minibatch training window holds at its peak:
``torch.cuda.max_memory_reserved()`` after ``reset_peak_memory_stats()`` at
the traced window's start, in GiB. Reserved rather than allocated: a
replayed step's scratch lives in its CUDA graph's private pool, which the
allocator holds reserved, so memory traded for speed shows here."""


def read(run):
    return run.peak_bytes / 2 ** 30

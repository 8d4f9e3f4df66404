"""Device kernels a GPPVAE step runs: the traced window's device operations
other than copies and fills, over the steps it ran. The per-subject replays
launch most of them; a step that batches the replays runs fewer."""

NOT_KERNELS = ("Memcpy", "Memset")


def read(run):
    n = sum(not name.startswith(NOT_KERNELS) for name, _, _ in run.window.device_ops)
    return n / run.work["steps"]

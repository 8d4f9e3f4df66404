"""The traced window's reduction: busy time as a union, gaps with the host's
activity, runtime calls, device time by name."""

from perfbench import trace
from perfbench.trace import Event


def test_union_gaps_and_calls():
    events = [
        Event(trace.WINDOW, 0.0, 10.0, False),
        Event("step", 0.5, 9.0, False),
        Event("aten::normal_", 6.0, 8.0, False),
        Event("cudaGraphLaunch", 1.0, 1.1, False),
        Event("cudaLaunchKernel", 2.0, 2.1, False),
        Event("b_chain_warp_kernel", 1.0, 3.0, True),
        Event("sgemm", 2.0, 4.0, True),  # overlaps the first: counted once
        Event("chol_inv_warp_kernel", 5.0, 6.0, True),
        Event("late_kernel", 9.5, 12.0, True),  # clipped to the window
    ]
    w = trace.reduce(events)
    assert w.window_s == 10.0
    assert w.busy_s == (4.0 - 1.0) + (6.0 - 5.0) + (10.0 - 9.5)
    assert w.host_calls == {"cudaGraphLaunch": 1, "cudaLaunchKernel": 1}
    assert w.device_seconds("b_chain_") == 2.0
    assert w.device_seconds("kernel_matrix_") is None
    gaps = {(s, e): what for s, e, what in w.gaps}
    assert gaps[(0.0, 1.0)] == "step"
    assert gaps[(6.0, 9.5)] == "aten::normal_"
    assert gaps[(4.0, 5.0)] == "step"
    top = dict(w.breakdown()["idle_gaps"])
    assert top["aten::normal_"] == 3.5

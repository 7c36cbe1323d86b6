"""Share of the profiled stretch in which no operation ran on the device
(the union of the profiler's device intervals, over the stretch's host
time)."""


def read(run):
    t = run.trace
    if not t or not t["kernels"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

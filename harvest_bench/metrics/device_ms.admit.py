"""Device time of one admission (``add()``): kernel time inside the harness's
``admit`` spans over the profiled stretch, over the number of those spans."""


def read(run):
    t = run.trace
    if not t or not t["kernels"] or not t["n_spans"].get("admit"):
        return None
    return 1e3 * t["device_s_by_span"].get("admit", 0.0) / t["n_spans"]["admit"]

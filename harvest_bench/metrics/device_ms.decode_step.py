"""Device time of one decode step (``step()``): kernel time inside the harness's
``decode_step`` spans over the profiled stretch, over the number of those spans."""


def read(run):
    t = run.trace
    if not t or not t["kernels"] or not t["n_spans"].get("decode_step"):
        return None
    return 1e3 * t["device_s_by_span"].get("decode_step", 0.0) / t["n_spans"]["decode_step"]

"""``moe_gmm``'s share of its roofline over the profiled stretch: the sum
of each launch's bound (``harness.work``: the larger of its FLOPs over the
FLOP peak and its bytes over the byte peak, counted from the launch's
inputs) over the kernel's device time from the profiler.

The launches counted three ways have to agree: the recorder's wrapped
calls, the change in the port's ``launch_counts()["moe_gmm"]``, and the
profiler's ``moe_gmm`` kernels. Where they do not, or a launch came
without its layer's group sizes, the metric reads nothing and says why."""
import sys


def read(run):
    t = run.trace
    if not t or not t["kernels"] or not t["gmm_kernels"]:
        return None
    counts = (t["gmm_recorded"], t["gmm_launches"], t["gmm_kernels"])
    if t["gmm_fault"] or len(set(counts)) != 1:
        print(f"moe_gmm_roofline: launches recorded / counted / profiled {counts}, "
              f"fault {t['gmm_fault']}: not read", file=sys.stderr)
        return None
    _, _, bound = t["gmm_work"]
    return 100.0 * bound / t["gmm_s"]

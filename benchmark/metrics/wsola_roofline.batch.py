"""wsola_roofline.batch: the WSOLA chain's least time (yardstick.wsola_bound,
from the lengths and speed of the answers in the traced window) over the
profiler's time of ctts_wsola_frames' two kernels in that window."""

from benchmark.yardstick import wsola_bound

KERNELS = ("wsola_decide_kernel", "wsola_emit_kernel")


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.kernel_s(KERNELS)
    lens = [int(n) for _, _, ls in run.in_trace() for n in ls if n > 0]
    if spent <= 0 or not lens:
        return None
    return 100.0 * wsola_bound(lens, run.speed)["bound_ms"] / 1e3 / spent

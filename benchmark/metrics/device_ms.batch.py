"""device_ms.batch: milliseconds in which a kernel, copy or fill ran on
the device inside the traced window (their union), per batch yielded in
it."""


def read(run):
    items = run.in_trace() if run.trace is not None else []
    if not items:
        return None
    return run.trace.busy_s * 1e3 / len(items)

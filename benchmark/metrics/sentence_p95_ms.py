"""sentence_p95_ms: the 95th percentile of the wall time of every
CTTSEngine.synthesize call completed in the window."""

from benchmark.yardstick import percentile


def read(run):
    done = run.in_window()
    if not done:
        return None
    return percentile([(b - a) * 1e3 for a, b, _ in done], 95)

"""batch_p95_ms: the 95th percentile, over every batch yielded in the
window, of the time from the stream pulling the batch's texts to its
yielding their samples."""

from benchmark.yardstick import percentile


def read(run):
    done = run.in_window()
    if not done:
        return None
    return percentile([(b - a) * 1e3 for a, b, _ in done], 95)

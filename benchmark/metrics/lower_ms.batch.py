"""lower_ms.batch: mean host milliseconds of host lowering of a batch on
the calling thread (BatchSynthesizer._lower_batch), over the calls
that ended in the traced window; the harness wraps the call
(yardstick.timed_method)."""


def read(run):
    spans = run.span_s("lower")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3

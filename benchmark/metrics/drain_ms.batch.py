"""drain_ms.batch: mean host milliseconds of drain and wire decode of a
batch on the drain thread (BatchSynthesizer._finish), over the calls
that ended in the traced window; the harness wraps the call
(yardstick.timed_method)."""


def read(run):
    spans = run.span_s("drain")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3

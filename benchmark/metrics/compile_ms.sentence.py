"""compile_ms.sentence: mean host milliseconds of the entry's text
normalisation, unit selection and plan (CTTSEngine.compile), over the
calls that ended in the traced window; the harness wraps the call
(yardstick.timed_method)."""


def read(run):
    spans = run.span_s("compile")
    if not spans:
        return None
    return sum(spans) / len(spans) * 1e3

"""pad_share.batch: the share of pad rows in the row slots enqueued in
the traced window, 100 x pad / (pad + real), from the program's
`rows.pad` and `rows.real` counters (%)."""

from benchmark.program import counted


def read(run):
    pad, real = counted(run, "rows.pad"), counted(run, "rows.real")
    if pad is None or real is None or pad + real == 0:
        return None
    return 100.0 * pad / (pad + real)

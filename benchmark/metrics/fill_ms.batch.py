"""fill_ms.batch: mean ms a batch of the host lowering's fill on the
calling thread (the program's `lower.fill` span: every bucket's rows
filled, ordered and padded, its scalars and its shared tables), over
the batches whose spans ended in the traced window. None for a program
without the span."""

from benchmark.program import per_request_ms


def read(run):
    return per_request_ms(run, ("lower.fill",))

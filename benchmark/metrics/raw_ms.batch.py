"""raw_ms.batch: mean ms a batch of the drain's codec-off pass on the
drain thread (the program's `drain.raw` spans: the texts' arrays and one
native copy of every shard's rows into them), over the batches whose
spans ended in the traced window. None where the program has no such
span."""

from benchmark.program import per_request_ms


def read(run):
    return per_request_ms(run, ("drain.raw",))

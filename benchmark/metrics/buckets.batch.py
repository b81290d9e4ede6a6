"""buckets.batch: mean dims buckets a batch enqueues, each one run of
the core (the program's `buckets` counter), over the batches whose
increments fell in the traced window."""

from benchmark.program import per_request_count


def read(run):
    return per_request_count(run, "buckets")

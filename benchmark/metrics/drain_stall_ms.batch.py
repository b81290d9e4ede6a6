"""drain_stall_ms.batch: mean ms the calling thread waits for a batch's
drain before it yields the batch (the program's `stream.wait_drain`
span), over the yielded batches whose wait ended in the traced
window."""

from benchmark.program import per_request_ms


def read(run):
    return per_request_ms(run, ("stream.wait_drain",))

"""copy_wait_ms.batch: mean ms a batch's drain waits for its packed
prefix's copy to the host (the program's `drain.wait_copy` spans, summed
over the batch's shards), over the batches whose spans ended in the
traced window."""

from benchmark.program import per_request_ms


def read(run):
    return per_request_ms(run, ("drain.wait_copy",))

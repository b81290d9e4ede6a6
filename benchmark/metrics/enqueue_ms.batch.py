"""enqueue_ms.batch: mean host ms to stage and launch or replay every
bucket of a batch (the program's `batch.enqueue` span), over the
batches whose span ended in the traced window."""

from benchmark.program import per_request_ms


def read(run):
    return per_request_ms(run, ("batch.enqueue",))

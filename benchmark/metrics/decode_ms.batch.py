"""decode_ms.batch: mean ms of wire decode a batch on the drain thread
(the program's `drain.decode` spans, summed over the batch's shards),
over the batches whose spans ended in the traced window."""

from benchmark.program import per_request_ms


def read(run):
    return per_request_ms(run, ("drain.decode",))

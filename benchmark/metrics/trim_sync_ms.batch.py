"""trim_sync_ms.batch: mean ms the calling thread blocks for a batch's
row lengths, that is for its core to finish on the device (the
program's `trim.sync` spans, summed over the batch's buckets and
shards), over the batches whose spans ended in the traced window."""

from benchmark.program import per_request_ms


def read(run):
    return per_request_ms(run, ("trim.sync",))

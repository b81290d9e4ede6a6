"""d2h_mb.batch: mean MB (10^6 bytes) a batch's trim copies from the
device to the host, its packed prefixes in the wire's words or as
samples (the program's `bytes.d2h` counter), over the batches whose
increments fell in the traced window."""

from benchmark.program import per_request_count


def read(run):
    got = per_request_count(run, "bytes.d2h")
    return None if got is None else got / 1e6

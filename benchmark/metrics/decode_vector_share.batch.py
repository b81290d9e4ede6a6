"""decode_vector_share.batch: the share of the samples that the drain's
wire decode wrote in the traced window that its vector path wrote,
100 x decode.vector / decode.samples, from the program's counters (%).
None where nothing was decoded (a program without these counters)."""

from benchmark.program import counted


def read(run):
    samples, vector = counted(run, "decode.samples"), counted(
        run, "decode.vector")
    if not samples or vector is None:
        return None
    return 100.0 * vector / samples

"""sync_ms.sentence: mean ms a call blocks on the device's result (the
program's `sentence.sync` spans: the length and overflow copy, then the
samples' copy), over the calls whose spans ended in the traced
window."""

from benchmark.program import per_request_ms


def read(run):
    return per_request_ms(run, ("sentence.sync",))

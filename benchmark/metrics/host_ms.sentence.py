"""host_ms.sentence: mean host ms a call spends between its plan and
the wait for the device: the program's `sentence.lower` (walk, fill,
shared tables) and `core.run` (signature, staging, launches or
replays) spans of the call, over the calls whose spans ended in the
traced window."""

from benchmark.program import per_request_ms


def read(run):
    return per_request_ms(run, ("sentence.lower", "core.run"))

"""raw_native_share.batch: the share of the samples that the codec-off
drain wrote in the traced window that its native pass wrote,
100 x raw.native / raw.samples, from the program's counters (%). None
where nothing was copied (a program without these counters)."""

from benchmark.program import counted


def read(run):
    samples, native = counted(run, "raw.samples"), counted(
        run, "raw.native")
    if not samples or native is None:
        return None
    return 100.0 * native / samples

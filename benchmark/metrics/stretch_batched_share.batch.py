"""stretch_batched_share.batch: the share of the real rows of stretching
buckets enqueued in the traced window whose WSOLA decide ran in the
batch's one table launch, 100 x stretch.batched / stretch.rows, from the
program's counters (%). None without stretch rows (speed 1.0, or a
program without these counters)."""

from benchmark.program import counted


def read(run):
    rows = counted(run, "stretch.rows")
    batched = counted(run, "stretch.batched")
    if not rows or batched is None:
        return None
    return 100.0 * batched / rows

"""fill_native_share.batch: the share of the rows that the host lowering
filled in the traced window that its native bucket call wrote,
100 x fill.native / fill.rows, from the program's counters (%). None
where nothing was filled (a program without these counters)."""

from benchmark.program import counted


def read(run):
    rows, native = counted(run, "fill.rows"), counted(run, "fill.native")
    if not rows or native is None:
        return None
    return 100.0 * native / rows

"""Host seconds a map in the program's span ``xfr.bb.masks``: the host
mask draw, the grid and their upload."""

from xfr_bench.program_trace import span_seconds


def read(run):
    if run["family"] != "bb":
        return None
    s = span_seconds("xfr.bb.masks")
    return None if s is None else s / run["units"]

"""Host seconds a map in the program's span ``xfr.bb.prior``: the
mean-EBP prior's enqueue."""

from xfr_bench.program_trace import span_seconds


def read(run):
    if run["family"] != "bb":
        return None
    s = span_seconds("xfr.bb.prior")
    return None if s is None else s / run["units"]

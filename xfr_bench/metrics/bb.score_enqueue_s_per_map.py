"""Host seconds a map in the program's span ``xfr.bb.score``: the
embedding memo's lookups, the probe's encode, the chunks' enqueue and
the fused select+combine."""

from xfr_bench.program_trace import span_seconds


def read(run):
    if run["family"] != "bb":
        return None
    s = span_seconds("xfr.bb.score")
    return None if s is None else s / run["units"]

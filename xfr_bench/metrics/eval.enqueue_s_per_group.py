"""Host seconds a group in the program's span ``xfr.eval.encode``: the
enqueue of the blend+encode steps, the counts' upload included."""

from xfr_bench.program_trace import span_seconds


def read(run):
    if run["family"] != "eval":
        return None
    s = span_seconds("xfr.eval.encode")
    return None if s is None else s / run["units"]

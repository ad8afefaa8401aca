"""Host seconds a group in the program's span ``xfr.eval.plane``: each
map's threshold plane and enter counts, on the host before the launch."""

from xfr_bench.program_trace import span_seconds


def read(run):
    if run["family"] != "eval":
        return None
    s = span_seconds("xfr.eval.plane")
    return None if s is None else s / run["units"]

"""Host seconds a group in the program's span ``xfr.eval.iou``: the IoU
curves, the program's own clock for what ``eval.host_iou_s_per_group``
reads around the call."""

from xfr_bench.program_trace import span_seconds


def read(run):
    if run["family"] != "eval":
        return None
    s = span_seconds("xfr.eval.iou")
    return None if s is None else s / run["units"]

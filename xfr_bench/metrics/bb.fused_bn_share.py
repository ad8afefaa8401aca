"""The share of the BatchNorm rows a STRise map applied inside a fused
epilogue, in percent: the program's counters ``xfr.enc.bn_rows_fused``
(a BatchNorm node a row, run by the fused conv-bias/BatchNorm/gate/add/
ReLU kernel) over ``xfr.enc.bn_rows`` (every BatchNorm node a row, eager
forwards and replayed graphs alike).  The prior's walk keeps BatchNorm
unfused, so the share stays just below 100.  A program that counts no
BatchNorm rows reads nothing."""

from xfr_bench.program_trace import counter


def read(run):
    if run["family"] != "bb":
        return None
    rows = counter("xfr.enc.bn_rows")
    if not rows:
        return None
    return 100.0 * (counter("xfr.enc.bn_rows_fused") or 0) / rows

"""The share of the BatchNorm rows the eval's blend+encode steps applied
inside a fused epilogue, in percent: the program's counters
``xfr.enc.bn_rows_fused`` over ``xfr.enc.bn_rows`` (a BatchNorm node a
row, eager forwards and replayed graphs alike).  A matcher without
BatchNorm (LightCNN), or a program that counts no BatchNorm rows, reads
nothing."""

from xfr_bench.program_trace import counter


def read(run):
    if run["family"] != "eval":
        return None
    rows = counter("xfr.enc.bn_rows")
    if not rows:
        return None
    return 100.0 * (counter("xfr.enc.bn_rows_fused") or 0) / rows

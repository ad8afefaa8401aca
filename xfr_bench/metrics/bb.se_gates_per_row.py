"""SE gate multiplies applied a masked-probe row the STRise scorer
encoded: the program's counter ``xfr.enc.se_gates`` (one a row a gated
block, every encode of a gated matcher) over ``xfr.bb.rows_scored``
(the masked-probe rows, padding included).  A program that dropped the
gates, or scored off the gated graph, reads less than the matcher's
gated blocks; the probe's own encode adds its rows' gates on top."""

from xfr_bench.program_trace import counter


def read(run):
    if run["family"] != "bb":
        return None
    gates, rows = counter("xfr.enc.se_gates"), counter("xfr.bb.rows_scored")
    if not gates or not rows:
        return None
    return gates / rows

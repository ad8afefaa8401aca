"""The share of the blend+encode launches whose ``finish()`` read the
embeddings after its own launch's end, on a side stream, rather than
behind whatever the current stream held then, from the program's
counters ``xfr.eval.reads_after_own_end`` over ``xfr.eval.reads``, in
percent.  A program that counts no reads reads nothing."""

from xfr_bench.program_trace import counter


def read(run):
    if run["family"] != "eval":
        return None
    reads = counter("xfr.eval.reads")
    if not reads:
        return None
    return 100.0 * (counter("xfr.eval.reads_after_own_end") or 0) / reads

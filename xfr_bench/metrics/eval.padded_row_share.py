"""The share of the blend+encode rows the program encoded that no
threshold needed (steps' rows past T), from its counters
``xfr.eval.rows_needed`` and ``xfr.eval.rows_encoded``, in percent."""

from xfr_bench.program_trace import counter


def read(run):
    if run["family"] != "eval":
        return None
    need, done = counter("xfr.eval.rows_needed"), \
        counter("xfr.eval.rows_encoded")
    if not done:
        return None
    return 100.0 * (1.0 - need / done)

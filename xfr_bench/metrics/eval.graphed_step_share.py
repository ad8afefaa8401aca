"""The share of the blend+encode steps whose encode the program ran as a
replay of its captured CUDA graph, from its counters
``xfr.eval.graph_replays`` over ``xfr.eval.steps``, in percent.  A
program without the captured encode counts no replays and reads
nothing."""

from xfr_bench.program_trace import counter


def read(run):
    if run["family"] != "eval":
        return None
    steps, replays = counter("xfr.eval.steps"), \
        counter("xfr.eval.graph_replays")
    if not steps or replays is None:
        return None
    return 100.0 * replays / steps

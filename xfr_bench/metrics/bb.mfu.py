"""The whole step's share of the H100's dense peak: the seconds the
window's units need at the peak of each stage's precision (FLOPs of the
convolutions and matrix products from the configuration's shapes), over
the traced window's seconds, in percent."""


def read(run):
    if run["family"] != "bb":
        return None
    return 100.0 * run["units"] * sum(run["stage_seconds"]) / run["window_s"]

"""The share of the traced window in which no operation ran on the
device, in percent."""


def read(run):
    if run["family"] != "bb":
        return None
    return 100.0 * (1.0 - run["busy_s"] / run["window_s"])

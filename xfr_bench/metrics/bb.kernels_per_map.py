"""Kernels the device ran in the traced window, per STRise map."""


def read(run):
    if run["family"] != "bb":
        return None
    return run["kernels"] / run["units"]

"""Kernels the device ran in the traced window, per evaluation group."""


def read(run):
    if run["family"] != "eval":
        return None
    return run["kernels"] / run["units"]

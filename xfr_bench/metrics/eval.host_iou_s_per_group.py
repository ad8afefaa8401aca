"""Host seconds in ``intersect_over_union_thresholded_saliency`` per
evaluation group, by the harness's clock around each call."""


def read(run):
    if run["family"] != "eval":
        return None
    return run["counters"]["host_iou_s"] / run["units"]

"""Box geometry: anchors, transforms, NMS, the proposal layer and RoI
pooling (port of xfr_tpu/detection/boxes.py).

Caffe Faster R-CNN conventions (+1 widths, inclusive coords).  These run
on the host in numpy, as in the JAX package, and are the same code, so
the two packages agree bit for bit.
"""

from __future__ import annotations

import numpy as np

# generate_anchors(scales=(8,16,32)), 3 aspect ratios x 3 scales, stride 16
ANCHORS = np.array([
    [-84., -40., 99., 55.],
    [-176., -88., 191., 103.],
    [-360., -184., 375., 199.],
    [-56., -56., 71., 71.],
    [-120., -120., 135., 135.],
    [-248., -248., 263., 263.],
    [-36., -80., 51., 95.],
    [-80., -168., 95., 183.],
    [-168., -344., 183., 359.],
])
FEAT_STRIDE = 16


def shifted_anchors(height, width, feat_stride=FEAT_STRIDE, anchors=ANCHORS):
    """All anchors shifted over the feature grid -> [H*W*A, 4]
    (rows ordered (h, w, a))."""
    shift_x = np.arange(0, width) * feat_stride
    shift_y = np.arange(0, height) * feat_stride
    shift_x, shift_y = np.meshgrid(shift_x, shift_y)
    shifts = np.vstack((shift_x.ravel(), shift_y.ravel(),
                        shift_x.ravel(), shift_y.ravel())).transpose()
    A = anchors.shape[0]
    K = shifts.shape[0]
    out = (anchors.reshape((1, A, 4)) +
           shifts.reshape((1, K, 4)).transpose((1, 0, 2)))
    return out.reshape((K * A, 4))


def bbox_transform_inv(boxes, deltas):
    """Decode box regression deltas."""
    if boxes.shape[0] == 0:
        return np.zeros((0, deltas.shape[1]), dtype=deltas.dtype)
    boxes = boxes.astype(deltas.dtype, copy=False)
    widths = boxes[:, 2] - boxes[:, 0] + 1.0
    heights = boxes[:, 3] - boxes[:, 1] + 1.0
    ctr_x = boxes[:, 0] + 0.5 * widths
    ctr_y = boxes[:, 1] + 0.5 * heights

    dx = deltas[:, 0::4]
    dy = deltas[:, 1::4]
    # Clip dw/dh before exp like py-faster-rcnn's BBOX_XFORM_CLIP
    # (log(1000/16)): uncalibrated deltas otherwise overflow np.exp to
    # inf boxes.  Never binds for trained-weight deltas (|dw| ~ O(1)).
    clip = np.log(1000.0 / 16.0)
    dw = np.minimum(deltas[:, 2::4], clip)
    dh = np.minimum(deltas[:, 3::4], clip)

    pred_ctr_x = dx * widths[:, None] + ctr_x[:, None]
    pred_ctr_y = dy * heights[:, None] + ctr_y[:, None]
    pred_w = np.exp(dw) * widths[:, None]
    pred_h = np.exp(dh) * heights[:, None]

    pred = np.zeros(deltas.shape, dtype=deltas.dtype)
    pred[:, 0::4] = pred_ctr_x - 0.5 * pred_w
    pred[:, 1::4] = pred_ctr_y - 0.5 * pred_h
    pred[:, 2::4] = pred_ctr_x + 0.5 * pred_w
    pred[:, 3::4] = pred_ctr_y + 0.5 * pred_h
    return pred


def clip_boxes(boxes, im_shape):
    """Clip to image bounds."""
    boxes[:, 0::4] = np.maximum(np.minimum(boxes[:, 0::4],
                                           im_shape[1] - 1), 0)
    boxes[:, 1::4] = np.maximum(np.minimum(boxes[:, 1::4],
                                           im_shape[0] - 1), 0)
    boxes[:, 2::4] = np.maximum(np.minimum(boxes[:, 2::4],
                                           im_shape[1] - 1), 0)
    boxes[:, 3::4] = np.maximum(np.minimum(boxes[:, 3::4],
                                           im_shape[0] - 1), 0)
    return boxes


def filter_boxes(boxes, min_size):
    ws = boxes[:, 2] - boxes[:, 0] + 1
    hs = boxes[:, 3] - boxes[:, 1] + 1
    return np.where((ws >= min_size) & (hs >= min_size))[0]


def nms(dets, thresh):
    """Greedy IoU NMS."""
    x1, y1, x2, y2 = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
    scores = dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[np.where(ovr <= thresh)[0] + 1]
    return keep


def proposal_layer(rpn_cls_prob, rpn_bbox_pred, im_info, num_anchors=9,
                   feat_stride=FEAT_STRIDE, anchors=ANCHORS,
                   pre_nms_topN=6000, post_nms_topN=300, nms_thresh=0.7,
                   min_size=3):
    """RPN proposal layer: decode, clip, drop boxes under ``min_size``,
    keep the ``pre_nms_topN`` best, NMS at ``nms_thresh``, keep
    ``post_nms_topN``.  Host numpy, as in the JAX package (6000 boxes)."""
    assert rpn_cls_prob.shape[0] == 1
    scores = np.asarray(rpn_cls_prob)[:, num_anchors:, :, :]
    bbox_deltas = np.asarray(rpn_bbox_pred)
    im_height, im_width, im_scale = [float(v) for v in im_info[0]]

    height, width = scores.shape[-2:]
    all_anchors = shifted_anchors(height, width, feat_stride, anchors)

    bbox_deltas = bbox_deltas.transpose((0, 2, 3, 1)).reshape((-1, 4))
    scores = scores.transpose((0, 2, 3, 1)).reshape((-1, 1))

    proposals = bbox_transform_inv(all_anchors, bbox_deltas)
    proposals = clip_boxes(proposals, (im_height, im_width))
    keep = filter_boxes(proposals, min_size * im_scale)
    proposals = proposals[keep, :]
    scores = scores[keep]

    order = scores.ravel().argsort()[::-1]
    if pre_nms_topN > 0:
        order = order[:pre_nms_topN]
    proposals = proposals[order, :]
    scores = scores[order]

    keep = nms(np.hstack((proposals, scores)), nms_thresh)
    if post_nms_topN > 0:
        keep = keep[:post_nms_topN]
    proposals = proposals[keep, :]

    batch_inds = np.zeros((proposals.shape[0], 1), dtype=np.float32)
    return np.hstack((batch_inds, proposals.astype(np.float32, copy=False)))


def roi_pool(features, rois, output_size=(14, 14), spatial_scale=0.0625):
    """torchvision.ops.roi_pool semantics in numpy.

    features: [1, C, H, W]; rois: [R, 5] (batch_idx, x1, y1, x2, y2).

    Vectorized over the bin grid: per RoI, pool rows into [C, ph, W] with
    a running max over each bin's row range, then pool columns — two
    separable passes instead of the naive ph*pw*R python loop.
    """
    feats = np.asarray(features)
    _, C, H, W = feats.shape
    rois = np.asarray(rois)
    R = rois.shape[0]
    ph, pw = output_size
    out = np.zeros((R, C, ph, pw), feats.dtype)

    # integer bin edges for all RoIs at once [R, ph(+1)] / [R, pw(+1)].
    # Quantization is half-AWAY-FROM-ZERO (floor(x+0.5); coords are
    # clipped >= 0): torchvision's C++ roi_pool uses std::round, and
    # np.round's round-half-to-even would shift a bin edge by one cell
    # at exact .5 coordinates (clip_boxes pins x2 to integer W-1, so
    # (W-1)*1/16 lands on .5 whenever (W-1) % 16 == 8).
    def _q(v):
        return np.floor(v * spatial_scale + 0.5).astype(np.int64)

    x1, y1, x2, y2 = (_q(rois[:, 1]), _q(rois[:, 2]),
                      _q(rois[:, 3]), _q(rois[:, 4]))
    bin_w = np.maximum(x2 - x1 + 1, 1) / pw
    bin_h = np.maximum(y2 - y1 + 1, 1) / ph
    ii = np.arange(ph)
    jj = np.arange(pw)
    hstart = np.clip(y1[:, None] + np.floor(ii * bin_h[:, None])
                     .astype(np.int64), 0, H)
    hend = np.clip(y1[:, None] + np.ceil((ii + 1) * bin_h[:, None])
                   .astype(np.int64), 0, H)
    wstart = np.clip(x1[:, None] + np.floor(jj * bin_w[:, None])
                     .astype(np.int64), 0, W)
    wend = np.clip(x1[:, None] + np.ceil((jj + 1) * bin_w[:, None])
                   .astype(np.int64), 0, W)

    f = feats[0]  # [C, H, W]
    for r in range(R):
        # rows -> [C, ph, W]
        rowmax = np.zeros((C, ph, W), feats.dtype)
        rvalid = hend[r] > hstart[r]
        for i in np.nonzero(rvalid)[0]:
            rowmax[:, i] = f[:, hstart[r, i]:hend[r, i]].max(axis=1)
        # cols -> [C, ph, pw]
        cvalid = wend[r] > wstart[r]
        for j in np.nonzero(cvalid)[0]:
            out[r, :, :, j] = np.where(
                rvalid[None, :],
                rowmax[:, :, wstart[r, j]:wend[r, j]].max(axis=2), 0.0)
    return out

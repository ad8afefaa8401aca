"""Faster R-CNN detector wrapper (port of xfr_tpu/detection/detector.py).

Padding, tiny-image upscaling, optional 90/-90/180 rotation retries with
IoU-based fusion of rotated detections, class-1 (face) thresholding and
final NMS.  Returns [N, 5] arrays of (x, y, width, height, score).
"""

from __future__ import annotations

from math import ceil

import numpy as np

from xfr_torch.detection import boxes as B
from xfr_torch.detection.network import FasterRCNNNetwork
from xfr_torch.utils.image import resize as _resize

DIM_THRESH = 15
CONF_THRESH = 0.5
NMS_THRESH = 0.15
FUSION_THRESH = 0.60
PIXEL_MEANS = np.array([[[102.9801, 115.9465, 122.7717]]])  # BGR


def _get_image_blob(im, test_scales=(800,), max_size=1300):
    """Mean-subtract + scale the shortest side to each test scale, the
    longest to at most ``max_size``."""
    im_orig = im.astype(np.float32, copy=True)
    im_orig -= PIXEL_MEANS
    im_size_min = np.min(im_orig.shape[0:2])
    im_size_max = np.max(im_orig.shape[0:2])
    processed, scales = [], []
    for target_size in test_scales:
        im_scale = float(target_size) / float(im_size_min)
        if np.round(im_scale * im_size_max) > max_size:
            im_scale = float(max_size) / float(im_size_max)
        out_shape = (int(round(im_orig.shape[0] * im_scale)),
                     int(round(im_orig.shape[1] * im_scale)))
        processed.append(_resize(im_orig, out_shape, order=1))
        scales.append(im_scale)
    blob = np.stack(processed).transpose([0, 3, 1, 2])
    return blob, np.array(scales)


def im_detect(net, im, boxes=None, test_scales=(800,), max_size=1300):
    """(scores [R,K], boxes [R,4K]) for one image."""
    im_blob, im_scales = _get_image_blob(im, test_scales, max_size)
    im_info = np.array([[im_blob.shape[2], im_blob.shape[3],
                         im_scales[0]]], np.float32)
    rois, bbox_pred, cls_prob, cls_score = net(im_blob, im_info)
    assert len(im_scales) == 1, "Only single-image batch implemented"
    boxes = rois[:, 1:5] / im_scales[0]
    scores = cls_prob
    pred_boxes = B.bbox_transform_inv(boxes, bbox_pred)
    pred_boxes = B.clip_boxes(pred_boxes, im.shape)
    return scores, pred_boxes


class FasterRCNN:
    """Face detector: ``detect(image)`` -> [N, 5] (x, y, w, h, score).

    ``model_dir``/``gpu_index`` are accepted for API parity and unused:
    weights come from ``params`` (the layout of
    ``network.load_from_torch_state_dicts``) or the deterministic random
    init, on ``device`` (default the card; raises without one).  ``net``
    replaces the network with any callable of its signature."""

    def __init__(self, model_dir=None, gpu_index=-1, conf_threshold=None,
                 rotate_flags=None, rotate_thresh=None, fusion_thresh=None,
                 test_scales=800, max_size=1300, net=None, params=None,
                 device="cuda"):
        self.test_scales = (test_scales,) if np.isscalar(test_scales) \
            else tuple(test_scales)
        if len(self.test_scales) != 1:
            # fail at construction with the real constraint, not deep in
            # _get_image_blob's np.stack over mismatched shapes
            raise NotImplementedError(
                "only single-scale detection is implemented "
                "(test_scales=%r)" % (self.test_scales,))
        self.max_size = max_size
        self.net = net or FasterRCNNNetwork(params=params, device=device)
        self.conf_threshold = (CONF_THRESH if conf_threshold is None
                               else conf_threshold)
        self.rotate_flags = 0 if rotate_flags is None else rotate_flags
        self.rotate_thresh = (conf_threshold if rotate_thresh is None
                              else rotate_thresh)
        self.fusion_thresh = (FUSION_THRESH if fusion_thresh is None
                              else fusion_thresh)

    def __call__(self, img, padding=0, min_face_size=DIM_THRESH):
        return self.detect(img, padding=padding,
                           min_face_size=min_face_size)

    def detect(self, image, padding=0, min_face_size=DIM_THRESH):
        width, height = image.shape[1], image.shape[0]
        detect_width, detect_height = width, height
        img = np.array(image)
        if img.ndim == 2:
            img = np.repeat(img[:, :, None], 3, axis=2)

        if padding > 0:
            perc = padding / 100.0
            padding = int(ceil(min(width, height) * perc))
            bgr_mean = np.mean(img, axis=(0, 1))
            detect_width = width + padding * 2
            detect_height = height + padding * 2
            # match the input dtype: a uint8 pad buffer would truncate a
            # float [0,1] probe to all-0/1 and the detector would run on
            # a black image
            pad_im = np.zeros((detect_height, detect_width, 3), img.dtype)
            pad_im[:, :, ...] = bgr_mean
            pad_im[padding:padding + height,
                   padding:padding + width, ...] = img
            img = pad_im

        if width <= 16 or height <= 16:
            img = _resize(img, (32, 32)).astype(img.dtype)
            width, height = 32, 32

        rotation_angles = []
        if self.rotate_flags & 1:
            rotation_angles.append(90)
        if self.rotate_flags & 2:
            rotation_angles.append(-90)
        if self.rotate_flags & 4:
            rotation_angles.append(180)

        current_rotation = 0
        det_lists = []
        im_rotated = img
        while True:
            scores, boxes = im_detect(self.net, im_rotated,
                                      test_scales=self.test_scales,
                                      max_size=self.max_size)
            cls_ind = 1  # face class
            cls_boxes = boxes[:, 4 * cls_ind:4 * (cls_ind + 1)]
            cls_scores = scores[:, cls_ind]
            dets = np.hstack((cls_boxes,
                              cls_scores[:, None])).astype(np.float32)
            keep = B.nms(dets, NMS_THRESH)
            dets = dets[keep, :]

            thresh = self.rotate_thresh if current_rotation != 0 \
                else self.conf_threshold
            dets = dets[dets[:, 4] > (thresh if thresh is not None
                                      else CONF_THRESH)]

            # (x2,y2) -> (w,h)
            dets[:, 2] = dets[:, 2] - dets[:, 0] + 1
            dets[:, 3] = dets[:, 3] - dets[:, 1] + 1

            if current_rotation == 90:
                for det in dets:
                    x_rot, y_rot = det[0], det[1]
                    det[0] = y_rot
                    det[1] = detect_height - (x_rot + det[2])
                    det[2], det[3] = det[3], det[2]
            elif current_rotation == -90:
                for det in dets:
                    x_rot, y_rot = det[0], det[1]
                    det[0] = detect_width - (y_rot + det[3])
                    det[1] = x_rot
                    det[2], det[3] = det[3], det[2]
            elif current_rotation == 180:
                for det in dets:
                    x_rot, y_rot = det[0], det[1]
                    det[0] = detect_width - (x_rot + det[2])
                    det[1] = detect_height - (y_rot + det[3])

            if padding > 0:
                dets[:, 0] -= padding
                dets[:, 1] -= padding
            dets = dets[(dets[:, 2] > min_face_size) &
                        (dets[:, 3] > min_face_size)]
            det_lists.append(dets)

            if not rotation_angles:
                break
            current_rotation = rotation_angles.pop(0)
            if current_rotation == 90:
                im_rotated = np.flip(img.transpose(1, 0, 2), axis=1)
            elif current_rotation == -90:
                im_rotated = np.flip(img.transpose(1, 0, 2), axis=0)
            else:
                im_rotated = np.flip(np.flip(img, axis=0), axis=1)

        if len(det_lists) > 1:
            return self.select_from_rotated(det_lists)
        return det_lists[0]

    def select_from_rotated(self, det_lists):
        """IoU fusion of detections from the rotated passes."""
        dets = det_lists[0]
        for rot_dets in det_lists[1:]:
            for rot_det in rot_dets:
                rx1, ry1 = rot_det[0], rot_det[1]
                rx2, ry2 = rx1 + rot_det[2], ry1 + rot_det[3]
                rot_area = rot_det[2] * rot_det[3]
                matched = False
                for det in dets:
                    x1, y1 = det[0], det[1]
                    x2, y2 = x1 + det[2], y1 + det[3]
                    iw = min(x2, rx2) - max(x1, rx1)
                    ih = min(y2, ry2) - max(y1, ry1)
                    if iw > 0 and ih > 0:
                        inter = iw * ih
                        union = rot_area + det[2] * det[3] - inter
                        if inter / union > self.fusion_thresh:
                            matched = True
                            if rot_det[4] > det[4]:
                                det[:5] = rot_det[:5]
                            break
                if not matched:
                    dets = np.vstack((dets, rot_det))
        return dets

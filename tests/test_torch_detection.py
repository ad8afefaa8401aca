"""The port's Faster R-CNN face detector against the JAX package's.

- ``detection.boxes`` is numpy on both sides: every function equals JAX's
  bit for bit on seeded inputs (every case of tests/test_detection.py,
  deltas past the BBOX_XFORM_CLIP clip, RoIs on .5 edges and degenerate
  RoIs).
- The trunk, both RPN heads and the top run through the port's network
  and through JAX's graphs with ``interpreter.forward_clean`` called
  un-jitted, in float64 on the same numpy weights: within 1e-10 of each
  output's largest entry (the two differ only in summation order).
- ``FasterRCNN.detect`` of both packages around one shared,
  deterministic, image-dependent fake network: equal outputs, padding,
  the tiny-image upscale and the rotation retries included.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from xfr_tpu.detection import boxes as JB
from xfr_tpu.detection import detector as JD
from xfr_tpu.detection import network as JN
from xfr_tpu.ebp import interpreter as JI
from tests.torch_fixtures import FakeNet, jax_params_np

from xfr_torch.detection import boxes as TB
from xfr_torch.detection import detector as TD
from xfr_torch.detection import network as TN

# float64 forwards of the two packages differ only in summation order
F64_REL = 1e-10


def _equal(a, b):
    """Bit-for-bit equality of two numpy results (values and dtype)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                       a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _rel_err(got, want):
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else got
    want = np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


# ---------------------------------------------------------------------------
# boxes: bit for bit
# ---------------------------------------------------------------------------


def _random_dets(seed, n=60):
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * 100
    wh = rng.rand(n, 2) * 50 + 5
    scores = rng.rand(n)
    scores[:5] = scores[5]  # tied scores: argsort's order decides
    return np.hstack([xy, xy + wh, scores[:, None]]).astype(np.float32)


def _iou_inclusive(a, b):
    """Caffe-convention IoU (+1 widths)."""
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]) + 1)
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]) + 1)
    inter = ix * iy
    area = lambda bx: (bx[2] - bx[0] + 1) * (bx[3] - bx[1] + 1)  # noqa
    return inter / (area(a) + area(b) - inter)


@pytest.mark.parametrize("thresh", [0.15, 0.5, 0.7])
def test_nms_matches_jax(thresh):
    """Greedy NMS keeps the same indices in the same order, and the
    invariants of tests/test_detection.py::test_nms_invariants hold: no
    kept pair overlaps above the threshold, and every suppressed box
    overlaps a kept box of at least its score."""
    dets = _random_dets(0)
    keep = TB.nms(dets, thresh)
    assert keep == JB.nms(dets, thresh)
    assert len(set(keep)) == len(keep)
    assert TD.FasterRCNNNetwork._nms(dets, thresh) == keep
    for i in range(len(keep)):
        for j in range(i + 1, len(keep)):
            assert _iou_inclusive(dets[keep[i]], dets[keep[j]]) <= thresh
    for s in set(range(len(dets))) - set(keep):
        assert any(_iou_inclusive(dets[s], dets[k]) > thresh and
                   dets[k, 4] >= dets[s, 4] for k in keep)


def test_anchors_and_clip_filter_match_jax():
    _equal(TB.ANCHORS, JB.ANCHORS)
    assert TB.FEAT_STRIDE == JB.FEAT_STRIDE
    _equal(TB.shifted_anchors(5, 7), JB.shifted_anchors(5, 7))
    rng = np.random.RandomState(1)
    boxes = (rng.rand(50, 8) * 300 - 50).astype(np.float32)
    _equal(TB.clip_boxes(boxes.copy(), (200, 240)),
           JB.clip_boxes(boxes.copy(), (200, 240)))
    _equal(TB.filter_boxes(boxes, 16.0), JB.filter_boxes(boxes, 16.0))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bbox_transform_inv_matches_jax(dtype):
    """Random deltas, some far past the log(1000/16) clip on dw/dh (they
    would overflow exp to inf boxes without it), and the zero-delta
    round trip of tests/test_detection.py."""
    rng = np.random.RandomState(2)
    xy = rng.rand(40, 2) * 200
    boxes = np.hstack([xy, xy + rng.rand(40, 2) * 80]).astype(dtype)
    deltas = (rng.randn(40, 8) * 2).astype(dtype)
    deltas[:5, 2::4] = 100.0
    deltas[5:10, 3::4] = 1e4
    got = TB.bbox_transform_inv(boxes, deltas)
    _equal(got, JB.bbox_transform_inv(boxes, deltas))
    assert np.isfinite(got).all()
    zero = TB.bbox_transform_inv(boxes[:2], np.zeros((2, 4), dtype))
    np.testing.assert_allclose(zero, boxes[:2] + np.array([0, 0, 1, 1.]),
                               atol=1e-4)
    # dx shifts the center by the (+1) width
    out = TB.bbox_transform_inv(boxes[:2], np.array([[1.0, 0, 0, 0]] * 2,
                                                     dtype))
    np.testing.assert_allclose(out[:, 0] - boxes[:2, 0],
                               boxes[:2, 2] - boxes[:2, 0] + 1, rtol=1e-5)
    _equal(TB.bbox_transform_inv(boxes[:0], deltas[:0]),
           JB.bbox_transform_inv(boxes[:0], deltas[:0]))


def test_proposal_layer_matches_jax():
    """Random RPN outputs at 30x40 (10,800 anchors, so the pre-NMS top
    6000 cut binds) and the single-peak case of tests/test_detection.py."""
    rng = np.random.RandomState(3)
    A, H, W = 9, 30, 40
    prob = rng.rand(1, 2 * A, H, W).astype(np.float32)
    bbox = (rng.randn(1, 4 * A, H, W) * 0.3).astype(np.float32)
    im_info = np.array([[H * 16, W * 16, 1.6]], np.float32)
    got = TB.proposal_layer(prob, bbox, im_info)
    _equal(got, JB.proposal_layer(prob, bbox, im_info))
    assert got.shape == (300, 5)

    H = W = 20
    cls = np.full((1, 2 * A, H, W), -5.0, np.float32)
    cls[0, A + 3, 10, 12] = 5.0
    prob = 1 / (1 + np.exp(-cls))
    bbox = np.zeros((1, 4 * A, H, W), np.float32)
    rois = TB.proposal_layer(prob, bbox, [[320.0, 320.0, 1.0]])
    _equal(rois, JB.proposal_layer(prob, bbox, [[320.0, 320.0, 1.0]]))
    anchor = TB.ANCHORS[3] + np.array([12 * 16, 10 * 16, 12 * 16, 10 * 16])
    np.testing.assert_allclose(
        rois[0, 1:], np.clip(anchor + np.array([0, 0, 1, 1.]), 0, 319),
        atol=1e-3)


def test_roi_pool_matches_jax():
    """RoIs on .5 edges (x/16 = k + 0.5: half away from zero, where
    np.round would go to even), degenerate RoIs (x2 < x1, 1x1 at the
    border, past the feature map), and the random RoIs of
    tests/test_detection.py::test_roi_pool_vectorized_matches_naive."""
    rng = np.random.RandomState(0)
    feats = rng.rand(1, 5, 38, 50).astype(np.float32)
    R = 40
    x1 = rng.randint(0, 45, R)
    y1 = rng.randint(0, 34, R)
    rois = np.stack([
        np.zeros(R), x1 * 16.0, y1 * 16.0,
        (x1 + rng.randint(0, 20, R)) * 16.0,
        (y1 + rng.randint(0, 20, R)) * 16.0], axis=1).astype(np.float32)
    edges = np.array([
        [0, 8.0, 24.0, 200.0, 136.0],      # 0.5, 1.5, 12.5, 8.5 cells
        [0, 40.0, 56.0, 72.0, 88.0],       # 2.5, 3.5, 4.5, 5.5
        [0, 100.0, 100.0, 60.0, 50.0],     # x2 < x1, y2 < y1
        [0, 799.0, 607.0, 799.0, 607.0],   # 1x1 at the border
        [0, 900.0, 700.0, 1000.0, 800.0],  # past the feature map
    ], np.float32)
    rois = np.concatenate([rois, edges])
    got = TB.roi_pool(feats, rois, (14, 14), 1.0 / 16)
    _equal(got, JB.roi_pool(feats, rois, (14, 14), 1.0 / 16))
    # tests/test_detection.py::test_roi_pool_matches_adaptive_maxpool's
    # RoIs (200/16 = 12.5 quantizes to 13) in float64
    feats64 = rng.randn(1, 8, 32, 40)
    rois = np.concatenate([np.array([[0, 0, 0, 320, 240],
                                     [0, 64, 32, 200, 180],
                                     [0, 100, 100, 110, 120]], np.float32),
                           rois[:20]])
    _equal(TB.roi_pool(feats64, rois, (7, 7), 1.0 / 16),
           JB.roi_pool(feats64, rois, (7, 7), 1.0 / 16))


# ---------------------------------------------------------------------------
# The network: same weights, float64, against JAX's graphs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_params():
    """The JAX network's random parameters (numpy init, seeds 0/1/2) as
    numpy float32; building the network jits nothing."""
    jnet = JN.FasterRCNNNetwork(seed=0)
    return {part: jax_params_np(p) for part, p in jnet.params.items()}


@pytest.fixture(scope="module")
def tnet32():
    """The port's random detector (numpy init, seeds 0/1/2) on the CPU."""
    return TN.FasterRCNNNetwork(seed=0, device="cpu")


def test_builders_and_random_init_match_jax(jax_params, tnet32):
    """The same graphs (ops, tags, attributes, parameter names and
    shapes), and the port's random detector equals JAX's bit for bit."""
    pairs = [(TN.build_trunk(), JN.build_trunk()),
             (TN.build_rpn(), JN.build_rpn()),
             (TN.build_rpn_bbox(), JN.build_rpn_bbox()),
             (TN.build_top()[:2], JN.build_top()[:2])]
    for (tg, tshapes), (jg, jshapes) in pairs:
        assert tshapes == jshapes
        assert [(n.op, n.ins, n.out, n.tag, n.pname, n.attrs)
                for n in tg.nodes] == \
            [(n.op, n.ins, n.out, n.tag, n.pname, n.attrs)
             for n in jg.nodes]
    assert TN.build_top()[2] == JN.build_top()[2]
    tnet = tnet32
    assert tnet.dtype == torch.float32
    for part, p in jax_params.items():
        assert set(tnet.params[part]) == set(p)
        for pname, vals in p.items():
            for k, v in vals.items():
                _equal(tnet.params[part][pname][k].numpy(), v)


@pytest.fixture(scope="module")
def f64_nets(jax_params):
    """The port's network on the JAX weights in float64 on the CPU, and
    the JAX weights as float64 device arrays."""
    np64 = {part: jax_params_np(p, np.float64)
            for part, p in jax_params.items()}
    tnet = TN.FasterRCNNNetwork(
        params=TN.params_from_jax(np64, device="cpu"), device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, np64)
    return tnet, jp


def test_trunk_and_rpn_match_jax_float64(f64_nets):
    """A 64x64 image through the trunk (res4 at 4x4) and both RPN heads:
    the port computes rpn_conv_3x3 once and applies rpn_bbox_pred to its
    ReLU; JAX runs its two sibling graphs.  Features, the softmax over
    the reshaped scores, and the bbox deltas within 1e-10 of their max."""
    tnet, jp = f64_nets
    x = np.random.RandomState(4).rand(1, 3, 64, 64) * 100 - 50
    feats, prob, bbox = tnet._features_and_rpn(torch.from_numpy(x))
    tg, rg, rbg = (JN.build_trunk()[0], JN.build_rpn()[0],
                   JN.build_rpn_bbox()[0])
    jf = JI.forward_clean(tg, jp["trunk"], jnp.asarray(x))[tg.output_id]
    jcls = JI.forward_clean(rg, jp["rpn"], jf)[rg.output_id]
    jbbox = JI.forward_clean(rbg, jp["rpn"], jf)[rbg.output_id]
    n, c, h, w = jcls.shape
    jprob = jax.nn.softmax(jcls.reshape(n, 2, -1, w), axis=1).reshape(
        n, 18, -1, w)
    assert feats.shape == (1, 1024, 4, 4) and feats.dtype == torch.float64
    assert prob.shape == (1, 18, 4, 4) and bbox.shape == (1, 36, 4, 4)
    assert _rel_err(feats, jf) < F64_REL
    assert _rel_err(prob, jprob) < F64_REL
    assert _rel_err(bbox, jbbox) < F64_REL


def test_top_matches_jax_float64(f64_nets):
    """4 RoIs of 14x14 features through res5 (dilation 2) and both heads:
    bbox_pred, the class softmax and the scores within 1e-10 of their
    max."""
    tnet, jp = f64_nets
    r = np.random.RandomState(5).rand(4, 1024, 14, 14) * 4 - 1
    bbox, prob, score = tnet._top(torch.from_numpy(r))
    tg, _, cls_t = JN.build_top()
    vals = JI.forward_clean(tg, jp["top"], jnp.asarray(r))
    assert bbox.shape == (4, 8) and prob.shape == (4, 2)
    assert _rel_err(bbox, vals[tg.output_id]) < F64_REL
    assert _rel_err(score, vals[cls_t]) < F64_REL
    assert _rel_err(prob, jax.nn.softmax(vals[cls_t], axis=1)) < F64_REL


def test_network_zero_rois_and_empty_params(tnet32):
    """Every proposal under min_size (im_info's scale 1000) gives the
    empty detection set without running the top; an explicitly empty
    params part is refused before anything is built."""
    x = np.random.RandomState(6).rand(1, 3, 64, 64).astype(np.float32)
    rois, bbox, prob, score = tnet32(x, np.array([[64, 64, 1000.0]]))
    assert rois.shape == (0, 5) and bbox.shape == (0, 8)
    assert prob.shape == (0, 2) and score.shape == (0, 2)
    for part in TN.PARTS:
        with pytest.raises(ValueError, match="empty"):
            TN.FasterRCNNNetwork(params={part: {}}, device="cpu")


def test_load_from_torch_state_dicts_matches_jax(jax_params):
    """State dicts named as the reference's three modules convert to the
    same parameters in both packages."""
    def state_dict(p):
        names = {"w": "weight", "b": "bias", "gamma": "weight",
                 "beta": "bias", "mean": "running_mean",
                 "var": "running_var"}
        return {f"{pname}.{names[k]}": torch.from_numpy(np.array(v))
                for pname, vals in p.items() for k, v in vals.items()}

    sds = [state_dict(jax_params[part]) for part in TN.PARTS]
    got = TN.load_from_torch_state_dicts(*sds, device="cpu")
    want = JN.load_from_torch_state_dicts(*sds)
    for part in TN.PARTS:
        for pname, vals in want[part].items():
            for k, v in vals.items():
                _equal(got[part][pname][k].numpy(), np.asarray(v))


# ---------------------------------------------------------------------------
# FasterRCNN.detect around a shared fake network
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["plain", "padding", "rotations",
                                  "tiny", "float_padding"])
def test_detect_matches_jax_with_fake_net(case):
    """Both packages' FasterRCNN.detect around the same fake network, on
    a 90x120 uint8 image (plain; padding 10; rotate_flags 7 with padding
    10, each retry's coordinates mapped back and fused), a 12x14 image
    (the upscale to 32x32) and a float [0,1] image with padding (the pad
    keeps the input's dtype): equal [n, 5] outputs."""
    rng = np.random.RandomState(7)
    img = (rng.rand(90, 120, 3) * 255).astype(np.uint8)
    kw, det_kw = dict(conf_threshold=0.4, test_scales=96, max_size=160), {}
    if case == "padding":
        det_kw = dict(padding=10)
    elif case == "rotations":
        kw.update(rotate_flags=7, rotate_thresh=0.3)
        det_kw = dict(padding=10)
    elif case == "tiny":
        img = (rng.rand(12, 14, 3) * 255).astype(np.uint8)
        det_kw = dict(min_face_size=2)
    elif case == "float_padding":
        img = rng.rand(90, 120, 3).astype(np.float32)
        det_kw = dict(padding=10)
    tnet, jnet = FakeNet(), FakeNet()
    got = TD.FasterRCNN(net=tnet, **kw).detect(img, **det_kw)
    want = JD.FasterRCNN(net=jnet, **kw).detect(img, **det_kw)
    assert tnet.calls == jnet.calls
    assert len(tnet.calls) == (4 if case == "rotations" else 1)
    _equal(got, want)
    assert got.ndim == 2 and got.shape[1] == 5 and len(got) > 0
    assert (got[:, 2] > 0).all() and (got[:, 3] > 0).all()


def test_detector_pipeline_smoke(tnet32):
    """tests/test_detection.py::test_detector_pipeline_smoke on the port's
    random detector at test_scales 128: [n, 5] outputs with positive
    widths and heights and finite scores, with and without padding.  (The
    unscaled numpy init saturates the RPN: its deltas move every box off
    the image, so n may be 0.)"""
    det = TD.FasterRCNN(conf_threshold=-1.0, rotate_flags=0, test_scales=128,
                        max_size=160, net=tnet32)
    img = (np.random.RandomState(0).rand(96, 120, 3) * 255).astype(np.uint8)
    for out in (det(img), det.detect(img, padding=10)):
        assert out.ndim == 2 and out.shape[1] == 5
        assert (out[:, 2] > 0).all() and (out[:, 3] > 0).all()
        assert np.isfinite(out[:, 4]).all()


def test_detect_blob_and_im_detect_match_jax():
    """The mean-subtracted, scaled blob (shortest side to the test scale,
    the longest capped at max_size) and im_detect's outputs."""
    img = (np.random.RandomState(8).rand(60, 200, 3) * 255).astype(np.uint8)
    for scales, max_size in (((96,), 160), ((800,), 1300)):
        tb, ts = TD._get_image_blob(img, scales, max_size)
        jb, js = JD._get_image_blob(img, scales, max_size)
        _equal(tb, jb)
        _equal(ts, js)
    got = TD.im_detect(FakeNet(), img, test_scales=(96,), max_size=160)
    want = JD.im_detect(FakeNet(), img, test_scales=(96,), max_size=160)
    for a, b in zip(got, want):
        _equal(a, b)


def test_detector_refusals_and_device_default():
    """Multi-scale is refused at construction, before a network is built;
    the detector, its network and params conversion default to the card
    and raise without one."""
    with pytest.raises(NotImplementedError, match="single-scale"):
        TD.FasterRCNN(test_scales=(600, 800))
    with pytest.raises(NotImplementedError, match="single-scale"):
        TD.FasterRCNN(test_scales=(600, 800), net=FakeNet())
    assert TD.FasterRCNN(test_scales=[800], net=FakeNet()).test_scales == \
        (800,)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.FasterRCNN()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TN.FasterRCNNNetwork()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TN.params_from_jax({"top": {"cls_score_1": {"w": np.zeros(2)}}})


"""CPU tests of the seam through which a configuration owns its weights,
its encode and its image size (``harness.weights``, ``harness.image_hw``
and ``reference/strise_matcher.py``), at reduced depth:

    python3 -m pytest xfr_bench/test_weights_seam.py -q

The three configurations' weights through the seam equal, bit for bit,
the plain random init and, for SENet-50-256, its gates calibrated on the
seed's "gates" images; a stand-in configuration defined here (a tiny
BatchNorm residual net whose input is half its images' size) runs
through the seam with its own calibration, encode and image size.
"""

from __future__ import annotations

import os
import subprocess
import sys
import types

import pytest
import torch
import torch.nn.functional as F

from xfr_bench import harness as H
from xfr_bench.kinds import strise_matcher as SM
from xfr_bench.reference import strise_matcher as RM

SEED = 2 ** 40 + 29
SPEC = {"num_masks": 16, "mask_scale": 28, "mask_elements": 2,
        "blur_fill_pct": 4}


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)


def _reduced(name):
    cfg = H.config(name)
    cfg.update(layers=[1, 1, 1, 1], num_classes=101)
    return cfg


@pytest.mark.parametrize("name", ["resnet101_l2", "lightcnn29_v2",
                                  "senet50_256"])
def test_seam_weights_equal_the_plain_init_and_senet_calibration(name):
    cfg = _reduced(name)
    R = cfg["reference"]
    want = H.make_weights(R.param_shapes(cfg), SEED, "cpu")
    if name == "senet50_256":
        g = H.generator(SEED, "cpu", "gates")
        images = torch.randint(
            0, 256, (cfg["calibration_images"],)
            + tuple(cfg["input_chw"][1:]) + (3,), generator=g,
            dtype=torch.uint8)
        R.calibrate_gates(want, cfg, images, cfg["se_logit_std"])
    got = H.weights(cfg, SEED, "cpu")
    assert H.image_hw(cfg) == tuple(cfg["input_chw"][1:])
    assert sorted(got) == sorted(want)
    for n in want:
        assert sorted(got[n]) == sorted(want[n])
        for k in want[n]:
            assert torch.equal(got[n][k], want[n][k]), (n, k)
    plain = H.make_weights(R.param_shapes(cfg), SEED, "cpu")
    moved = {n for n in plain for k in plain[n]
             if not torch.equal(plain[n][k], got[n][k])}
    if name == "senet50_256":
        assert moved and all(n.endswith("_1x1_up") for n in moved)
    else:
        assert not moved


def _bn(params, name, x):
    p = params[name]
    return F.batch_norm(x, p["mean"], p["var"], p["gamma"], p["beta"],
                        False, 0.0, 1e-5)


def _standin():
    """A plain reference of a tiny matcher, as a configuration's module
    would be: a 3x3 stem with BatchNorm, one residual block whose branch
    is conv -> BatchNorm with no activation after the add (as in
    IResNet), a mean pool and a 16-d linear head; ``preprocess`` halves
    the images; ``calibrate`` sets each BatchNorm's running statistics to
    the images' own.  It records every calibration's and encode's
    input."""
    ref = types.SimpleNamespace(calibrated=[], encoded=[])

    def param_shapes(cfg):
        bn = {"gamma": (8,), "beta": (8,), "mean": (8,), "var": (8,)}
        return {"stem": {"w": (8, 3, 3, 3), "b": (8,)}, "bn0": dict(bn),
                "c1": {"w": (8, 8, 3, 3)}, "bn1": dict(bn),
                "fc": {"w": (16, 8), "b": (16,)}}

    def preprocess(images_hwc):
        x = ((images_hwc / 255.0 - 0.5) / 0.5).permute(0, 3, 1, 2)
        return F.avg_pool2d(x, 2).contiguous()

    def stem(params, x):
        return F.conv2d(x, params["stem"]["w"], params["stem"]["b"],
                        padding=1)

    def branch(params, x):
        return F.conv2d(x, params["c1"]["w"], padding=1)

    def encode(params, cfg, x):
        ref.encoded.append(tuple(x.shape))
        x = _bn(params, "bn0", stem(params, x))
        x = x + _bn(params, "bn1", branch(params, x))
        return F.linear(x.mean((2, 3)), params["fc"]["w"],
                        params["fc"]["b"])

    @torch.no_grad()
    def calibrate(params, cfg, images_hwc):
        ref.calibrated.append(tuple(images_hwc.shape))

        def fit(name, y):
            params[name]["mean"].copy_(y.mean((0, 2, 3)))
            params[name]["var"].copy_(y.var((0, 2, 3)))
            return _bn(params, name, y)

        x = fit("bn0", stem(params, preprocess(images_hwc.float())))
        fit("bn1", branch(params, x))

    def forward_macs(cfg, chw, head=False):
        return 8 * chw[1] * chw[2] * (27 + 72) + 16 * 8

    ref.__dict__.update(param_shapes=param_shapes, preprocess=preprocess,
                        encode=encode, calibrate=calibrate,
                        forward_macs=forward_macs)
    cfg = {"name": "standin", "reference": ref, "input_chw": [3, 112, 112],
           "image_hw": [224, 224], "calibration_images": 2}
    return ref, cfg


def test_a_stand_in_configuration_runs_through_the_seam():
    ref, cfg = _standin()
    assert H.image_hw(cfg) == (224, 224)
    params = H.weights(cfg, SEED, "cpu")
    # its calibrate, once, on the seed's images at image_hw
    assert ref.calibrated == [(2, 224, 224, 3)]
    plain = H.make_weights(ref.param_shapes(cfg), SEED, "cpu")
    assert torch.equal(params["stem"]["w"], plain["stem"]["w"])
    assert not torch.equal(params["bn0"]["mean"], plain["bn0"]["mean"])
    x = ref.preprocess(H.images(SEED, "cpu", "gates", 2, (224, 224))
                       .float())
    y = F.conv2d(x, params["stem"]["w"], params["stem"]["b"], padding=1)
    torch.testing.assert_close(params["bn0"]["mean"], y.mean((0, 2, 3)))
    H.weights(cfg, SEED + 1, "cpu")
    assert len(ref.calibrated) == 2

    # STRise's matcher reference encodes every image with the stand-in,
    # at its input, while the masks and the map are at image_hw
    pcfg = _reduced("resnet101_l2")
    pparams = H.make_weights(pcfg["reference"].param_shapes(pcfg),
                             H.derive(SEED, "proxy"), "cpu")
    tr = {"mate_noise": 32, "probe_pool": 1, "refs": 1, "gallery": 2}
    probes, refs, gallery, _ = SM.scene(SEED, "cpu", tr, H.image_hw(cfg))
    assert probes.shape == (1, 224, 224, 3)
    ref.encoded.clear()
    r = RM.saliency_map(params, cfg, pparams, pcfg, probes[0], refs,
                        gallery, 7, SPEC, block=8)
    assert r["map"].shape == (224, 224) and r["prior"].shape == (224, 224)
    assert r["cts"].shape == (16,) and torch.isfinite(r["cts"]).all()
    assert {s[1:] for s in ref.encoded} == {(3, 112, 112)}
    assert sum(s[0] for s in ref.encoded) == 1 + 2 + 1 + 16
    # a mechanism control its reference lacks raises
    with pytest.raises(TypeError, match="flat_gates"):
        RM.saliency_map(params, cfg, pparams, pcfg, probes[0], refs,
                        gallery, 7, SPEC, block=8, flat_gates=True)

    # the matcher's FLOPs at its input, the proxy's prior at the images'
    tr = {"num_masks": 6500, "score_precision": "high"}
    got = SM.Cell.stage_seconds_at_peak(types.SimpleNamespace(
        cfg=cfg, tr=tr, pcfg=pcfg))
    P = pcfg["reference"]
    enc = 2 * ref.forward_macs(cfg, (3, 112, 112))
    prior = 3 * 2 * P.forward_macs(pcfg, (3, 224, 224), head=True) \
        - 2 * P.first_conv_macs(pcfg, (3, 224, 224))
    assert got == [6500 * enc / H.PEAK_FLOPS["float32"],
                   enc / H.PEAK_FLOPS["tf32"],
                   prior / H.PEAK_FLOPS["float32"]]


def test_matcher_reference_imports_no_configuration_reference():
    code = ("import sys\n"
            "import xfr_bench.reference.strise_matcher\n"
            "bad = [m for m in sys.modules if m.startswith("
            "'xfr_bench.reference.') and m.rsplit('.', 1)[1] not in "
            "('strise_matcher', 'strise', 'resnet101_l2', 'ebp')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120,
                   cwd=os.path.dirname(H.HERE))

"""``python -m xfr_torch.cli.eccv20`` against the JAX package's figure
driver: figures 1-5 on a synthetic face directory with the toy nets (as
tests/test_cli.py runs them), every saliency map behind a montage tile
compared with the JAX driver's, and the montages themselves.

Saliency maps: the toy walks run float32 in both packages; held at rtol
1e-4 / atol 1e-6 of the map's max (tests/test_torch_whitebox.py's toy
limits), the contrastive pair's at 2e-4 of the max; the uint8 maps of
ebp_version 5 to one uint8 step, but the contrastive pair's (see
test_main_matches_jax_on_uint8_maps).  Montages
are JPEGs of overlays of those maps: held to 3 levels of 255 in the mean
and equal in size.
"""

import os
import warnings

import numpy as np
import PIL.Image
import pytest

from tests.fixtures import make_toy_wbnet
from tests.torch_fixtures import FakeNet, toy_preprocess, twin_whitebox
from xfr_tpu.cli import eccv20 as J
from xfr_tpu.ebp.engine import Whitebox as JWhitebox

from xfr_torch.cli import eccv20 as T

ALL_METHODS = ("none", "ebp", "cebp", "tcebp", "weighted-subtree")


def _corpus(root, seed=1, n_subjects=4, n_images=3):
    """tests/test_cli.py's strongly distinct synthetic identities."""
    rng = np.random.RandomState(seed)
    for sid in range(n_subjects):
        d = os.path.join(root, "s%02d" % sid)
        os.makedirs(d)
        base = (rng.rand(260, 260, 3) * 60 + 40).astype(np.uint8)
        base = np.roll(base, sid, axis=2)
        base[40 + 30 * sid:100 + 30 * sid, 60:200, sid % 3] = 240
        base[150:200, 40 + 40 * sid:90 + 40 * sid] = 30 + 60 * sid
        for k in range(n_images):
            img = np.clip(base.astype(int) +
                          rng.randint(-10, 10, base.shape),
                          0, 255).astype(np.uint8)
            PIL.Image.fromarray(img).save(os.path.join(d, "im%d.jpg" % k))
    return root


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return _corpus(str(tmp_path_factory.mktemp("eccv20") / "data"))


def _recorded(monkeypatch, module):
    """Record every saliency map a module's overlays are drawn from."""
    maps = []
    blend = module._blend

    def rec(im, smap, gamma=0.5):
        maps.append(np.array(smap, np.float64))
        return blend(im, smap, gamma=gamma)

    monkeypatch.setattr(module, "_blend", rec)
    return maps


def _maps_close(got, want, methods):
    """Maps in drawing order: 4 tiles per method with a map.  The
    contrastive pair's maps (cebp, tcebp) are differences of near-equal
    MWPs under a triplet classifier of two similar embeddings, where
    float32 rounding is amplified: held at 2e-4 of the map's max (measured
    8.5e-5); the others at rtol 1e-4 / atol 1e-6 of the max."""
    drawn = [m for m in methods if m != "none"]
    assert len(got) == len(want) == 4 * len(drawn)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape
        top = max(np.abs(b).max(), 1e-30)
        if drawn[i // 4] in ("cebp", "tcebp"):
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-4 * top)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6 * top)


def _montages_close(got, want):
    assert [os.path.basename(f) for f in got] == \
        [os.path.basename(f) for f in want]
    for a, b in zip(got, want):
        a = np.asarray(PIL.Image.open(a), np.float64)
        b = np.asarray(PIL.Image.open(b), np.float64)
        assert a.shape == b.shape and a.shape[0] > 200
        assert np.abs(a - b).mean() <= 3.0, (np.abs(a - b).mean(), a.shape)


# Figures 2 and 4 show each mate's own first image as its probe.  Then
# the probe's embedding is the mate row of the triplet classifier, the
# mate logit's gradient is zero in exact arithmetic (the L2 head), and the
# weighted-subtree gate (mate gradient >= 0) reads rounding noise: the
# two frameworks rank differently there, as two runs of either on other
# hardware would.  Those figures draw the contrastive map instead.
@pytest.mark.parametrize("fig,methods", [
    (1, ALL_METHODS),
    (2, ("none", "ebp", "cebp")),
    (3, ("none", "ebp", "weighted-subtree")),
    (4, ("none", "ebp", "tcebp")),
    (5, ("none", "ebp", "weighted-subtree"))])
def test_figure_matches_jax(corpus, tmp_path, monkeypatch, fig, methods):
    """Figure ``fig`` (sub-figures per method + the composite 'f') on 2
    subjects with the toy net (as the LightCNN of figures 3-5 too): the
    same files, the same saliency maps in the same order, montages alike."""
    jwb = make_toy_wbnet(subtree_mode="all")
    twb = twin_whitebox(jwb, preprocess=toy_preprocess)
    ds_j, ds_t = J.FaceDirectory(corpus), T.FaceDirectory(corpus)
    assert ds_t.subjects() == ds_j.subjects() and len(ds_t.subjects()) == 4
    assert ds_t.take_per_subject(2) == ds_j.take_per_subject(2)
    jmaps, tmaps = _recorded(monkeypatch, J), _recorded(monkeypatch, T)
    kw = dict(n_subjects=2, methods=methods)
    if fig in (2, 4):
        kw["topk"] = 2
    outs = {}
    for name, mod, wb in (("jax", J, jwb), ("torch", T, twb)):
        d = tmp_path / name
        d.mkdir()
        outs[name] = getattr(mod, "figure%d" % fig)(wb, ds_j if name == "jax"
                                                    else ds_t,
                                                    output_dir=str(d), **kw)
    assert len(outs["torch"]) == len(methods) + 1
    assert os.path.basename(outs["torch"][0]) == "figure%da_2.jpg" % fig
    assert os.path.basename(outs["torch"][-1]) == "figure%df_2.jpg" % fig
    _maps_close(tmaps, jmaps, methods)
    _montages_close(outs["torch"], outs["jax"])


def test_topk_nonmates_and_detection_match_jax(corpus):
    """Subject mining and the center-crop (no detector), the same as the
    JAX driver's; a detector callable's box is cropped as there."""
    jwb = make_toy_wbnet(subtree_mode="all")
    twb = twin_whitebox(jwb, preprocess=toy_preprocess)
    ds = T.FaceDirectory(corpus)
    assert T.topk_nonmates(twb, ds, 3) == J.topk_nonmates(jwb, ds, 3)
    f = ds.subjectset(ds.subjects()[1])[0]
    det = lambda arr: [[30, 20, 150, 170, 0.9]]  # noqa: E731
    for d in (None, det):
        a, b = T.f_detection(f, d), J.f_detection(f, d)
        assert a.size == (224, 224)
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _toy_factories(monkeypatch):
    """Patch both packages' create_wbnet to return ebp_version 5 toy nets
    (the CLI's setting, uint8 maps); returns the list of their calls."""
    import xfr_tpu.models
    import xfr_torch.models

    jwb0 = make_toy_wbnet(subtree_mode="all")
    jwb = JWhitebox(jwb0.net, ebp_version=5, ebp_subtree_mode="all",
                    eps=jwb0.eps)
    twb = twin_whitebox(jwb, preprocess=toy_preprocess)
    seen = []

    def factory(wb):
        def create(name, **kw):
            seen.append((name, kw))
            assert kw.get("ebp_version") == 5
            return wb
        return create

    monkeypatch.setattr(xfr_tpu.models, "create_wbnet", factory(jwb))
    monkeypatch.setattr(xfr_torch.models, "create_wbnet", factory(twb))
    return seen


def test_main_matches_jax_on_uint8_maps(corpus, tmp_path, monkeypatch):
    """main() with the factory patched to ebp_version 5 toy nets (the
    CLI's setting, uint8 maps): figures 1 and 3 with every method, the
    same files and maps (to one uint8 step)."""
    seen = _toy_factories(monkeypatch)
    jmaps, tmaps = _recorded(monkeypatch, J), _recorded(monkeypatch, T)
    argv = ["--dataset", corpus, "--figure", "1", "3", "--subjects", "2",
            "--wsebp-max-candidates", "6"]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        J.main(argv + ["--output", str(tmp_path / "j")])
    outs = T.main(argv + ["--output", str(tmp_path / "t")])
    assert [n for n, _ in seen] == ["resnetv4_pytorch", "lightcnn"] * 2
    assert seen[1][1]["ebp_subtree_mode"] == "affineonly_with_prior"
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))
    assert len(outs) == 2 * (len(ALL_METHODS) + 1)
    assert len(tmaps) == len(jmaps) == 2 * 4 * (len(ALL_METHODS) - 1)
    drawn = [m for m in ALL_METHODS if m != "none"]
    for i, (a, b) in enumerate(zip(tmaps, jmaps)):
        method = drawn[(i // 4) % len(drawn)]
        if method in ("ebp", "weighted-subtree"):
            # uint8 maps drawn as uint8 / 255: one step apart at most
            assert np.abs(a - b).max() <= 1.0 / 255 + 1e-7, (i, method)
            continue
        # the contrastive pair's uint8 maps (drawn as 0..255): their raw
        # maps agree to 1.4e-4 of the max, one level apart after the first
        # uint8 conversion; PIL's blur and the second min-max then scale a
        # level by 255/range of the blurred map (13 levels on 9 of 3,136
        # pixels of one tile here).  Held at correlation >= 0.999 and at
        # most 1% of the pixels more than one level apart.
        off = np.abs(a - b) > 1.0
        assert off.mean() <= 0.01, (i, method, int(off.sum()))
        if b.max() > 0:
            assert np.corrcoef(a.ravel(), b.ravel())[0, 1] >= 0.999, i


def test_main_use_detector_matches_jax(corpus, tmp_path, monkeypatch):
    """main(--use-detector) on figure 1 with each package's FasterRCNN
    built around the same fake network (tests/torch_fixtures.FakeNet, so
    no detector weights run here): detect() runs once for every image the
    figure reads, each face crop equals the JAX driver's, and the same
    files are written."""
    import xfr_tpu.detection
    import xfr_torch.detection

    _toy_factories(monkeypatch)
    crops = {"jax": [], "torch": []}
    detects = {"jax": 0, "torch": 0}
    found = []

    def detector(key, module):
        cls = module.FasterRCNN

        def make(**kw):
            assert kw == {}
            det = cls(net=FakeNet())
            detect = det.detect

            def counted(*a, **k):
                detects[key] += 1
                dets = detect(*a, **k)
                found.append(len(dets))
                return dets
            det.detect = counted
            return det
        return make

    def recorded_crop(key, module):
        f = module.f_detection

        def rec(imgfile, detector=None, out_size=224):
            assert detector is not None
            im = f(imgfile, detector, out_size)
            crops[key].append(np.asarray(im))
            return im
        return rec

    for key, det_mod, cli in (("jax", xfr_tpu.detection, J),
                              ("torch", xfr_torch.detection, T)):
        monkeypatch.setattr(det_mod, "FasterRCNN", detector(key, det_mod))
        monkeypatch.setattr(cli, "f_detection", recorded_crop(key, cli))
    argv = ["--dataset", corpus, "--figure", "1", "--subjects", "2",
            "--use-detector"]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        J.main(argv + ["--output", str(tmp_path / "j")])
    outs = T.main(argv + ["--output", str(tmp_path / "t")])
    assert len(outs) == len(ALL_METHODS) + 1
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))
    assert detects["torch"] == len(crops["torch"]) > 0
    assert detects["jax"] == detects["torch"]
    assert min(found) > 0  # every crop came from a detection
    for a, b in zip(crops["torch"], crops["jax"]):
        assert a.shape == (224, 224, 3)
        np.testing.assert_array_equal(a, b)


def test_jet_colormap_equals_matplotlib():
    """The overlays' jet lookup, written without matplotlib (the card's
    machine lacks it), equals matplotlib's jet bit for bit, out-of-range
    and NaN values included."""
    import matplotlib.pyplot as plt
    from xfr_torch.show import jet

    x = np.concatenate([np.linspace(-0.2, 1.2, 100000),
                        [0.0, 1.0, np.nan, 0.5, 255 / 256, 1 / 256, -1e-9,
                         1 + 1e-12]]).reshape(-1, 9)
    np.testing.assert_array_equal(jet(x),
                                  np.delete(plt.get_cmap("jet")(x), 3, 2))

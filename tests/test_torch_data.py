"""The port's data transforms, strface surface, utilities, the
``unpack_dataset`` CLI and STRise's gallery montage, against the JAX
package's.

The transforms are PIL and numpy in both packages: seeded pipelines give
equal images (exact), and the preprocessed tensors are equal to JAX's
arrays (exact: both subtract the mean in float64, then cast to float32).
The strface encodings run the toy net in float32 in both packages and are
held at rtol 1e-5 (tests/test_torch_whitebox.py's toy limits).
"""

import os
import tarfile

import numpy as np
import PIL.Image
import pytest
import torch

from tests.fixtures import make_toy_wbnet
from tests.torch_fixtures import toy_preprocess, twin_whitebox
from xfr_tpu.data import transforms as JT

from xfr_torch.data import transforms as TT


def _img(seed=0, size=(300, 260)):
    rng = np.random.RandomState(seed)
    return PIL.Image.fromarray(
        (rng.rand(size[1], size[0], 3) * 255).astype(np.uint8))


def _same_image(a, b):
    assert a.size == b.size and a.mode == b.mode
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# data/transforms
# ---------------------------------------------------------------------------


def test_prepare_image_fn_matches_jax():
    """Center crop, and the seeded jitter pipeline (random crop, flip,
    brightness/contrast/saturation and hue jitter, blur) call for call."""
    _same_image(TT.prepare_image_fn(jitter=False)(_img()),
                JT.prepare_image_fn(jitter=False)(_img()))
    tp = TT.prepare_image_fn(jitter=True, blur_radius=1.5, blur_prob=0.5,
                             seed=0)
    jp = JT.prepare_image_fn(jitter=True, blur_radius=1.5, blur_prob=0.5,
                             seed=0)
    outs = [tp(_img(s)) for s in (0, 0, 1)]
    for out, s in zip(outs, (0, 0, 1)):
        assert out.size == (224, 224)
        _same_image(out, jp(_img(s)))
    # jitter draws differ between calls
    assert not np.array_equal(np.asarray(outs[0]), np.asarray(outs[1]))


def test_adjust_hue_rounds_as_jax():
    """The hue shift rounds factor * 255 (the JAX package's quirk): 0.1
    of a turn is 25.5 steps, shifted by 26."""
    img = _img(2, (32, 24))
    for f in (0.1, -0.1, 0.03, 0.5):
        _same_image(TT._adjust_hue(img, f), JT._adjust_hue(img, f))
    h0 = np.asarray(img.convert("HSV"))[..., 0].astype(int)
    h1 = np.asarray(PIL.Image.fromarray(np.asarray(
        TT._adjust_hue(img, 0.1))).convert("HSV"))[..., 0].astype(int)
    # the RGB round trip moves some hues by a step; most move by 26
    shift = np.bincount(((h1 - h0) % 256).ravel()).argmax()
    assert shift == 26


def test_twocrop_ensemble_matches_jax():
    crops = TT.generate_twocrop_ensemble()(_img())
    want = JT.generate_twocrop_ensemble()(_img())
    assert len(crops) == 6
    for c, w in zip(crops, want):
        assert c.size == (224, 224)
        _same_image(c, w)
    # flips pair up
    np.testing.assert_array_equal(
        np.asarray(crops[1]), np.asarray(crops[0])[:, ::-1])
    arr = TT.resnet101v4_preprocess_twocrop_ensemble(device="cpu")(_img())
    assert isinstance(arr, torch.Tensor) and arr.dtype == torch.float32
    assert arr.shape == (6, 3, 224, 224)
    np.testing.assert_array_equal(
        arr.numpy(),
        np.asarray(JT.resnet101v4_preprocess_twocrop_ensemble()(_img())))


def test_induce_artifacts_blur_and_named_pipelines_match_jax():
    """The JPEG-artifact distortion and random blur (seeded), and every
    named pipeline, ending in an identity preprocess (images equal) and
    in each package's preprocess_resnet101 (tensors equal)."""
    from xfr_tpu.models.resnet101 import preprocess_resnet101 as jpre
    from xfr_torch.models.resnet101 import preprocess_resnet101

    tart = TT.generate_induce_artifacts((30, 60), (0.5, 0.9), seed=0)
    jart = JT.generate_induce_artifacts((30, 60), (0.5, 0.9), seed=0)
    for s in (0, 1):
        out = tart(_img(s))
        assert out.size == _img().size
        _same_image(out, jart(_img(s)))
    tblur = TT.generate_random_blur(2.0, 0.5, seed=3)
    jblur = JT.generate_random_blur(2.0, 0.5, seed=3)
    for s in range(4):
        _same_image(tblur(_img(s)), jblur(_img(s)))
    _same_image(
        TT.preprocess_with_artifacts(lambda im: im, (30, 60), (0.5, 0.9),
                                     seed=4)(_img()),
        JT.preprocess_with_artifacts(lambda im: im, (30, 60), (0.5, 0.9),
                                     seed=4)(_img()))

    tpre = lambda im: preprocess_resnet101(im, device="cpu")  # noqa: E731
    for name in ("minimal", "grayscale", "invert-grayscale",
                 "blur-grayscale"):
        _same_image(
            TT.create_transforms(lambda im: im, name, jitter=True,
                                 blur_radius=1.5, seed=0)(_img()),
            JT.create_transforms(lambda im: im, name, jitter=True,
                                 blur_radius=1.5, seed=0)(_img()))
        x = TT.create_transforms(tpre, name, jitter=False, blur_radius=1.5,
                                 seed=0)(_img())
        assert x.shape == (1, 3, 224, 224)
        np.testing.assert_array_equal(
            x.numpy(), np.asarray(JT.create_transforms(
                jpre, name, jitter=False, blur_radius=1.5, seed=0)(_img())))
    with pytest.raises(RuntimeError):
        TT.create_transforms(tpre, "nope", jitter=False)


# ---------------------------------------------------------------------------
# strface
# ---------------------------------------------------------------------------


def test_strface_encodings_match_jax():
    """encode_centercrop (tests/test_data_parallel.py::test_strface_shim)
    and the two-crop x 3-scale x flip template on the toy net; strface
    re-exports the port's detector."""
    from xfr_tpu import strface as JS
    from xfr_torch import detection, strface as TS

    jwb = make_toy_wbnet()
    twb = twin_whitebox(jwb, preprocess=toy_preprocess)
    img = (np.random.RandomState(0).rand(224, 224, 3) * 255).astype(np.uint8)
    e = TS.encode_centercrop(twb, img)
    assert e.shape == (12,) and np.isfinite(e).all()
    np.testing.assert_allclose(e, JS.encode_centercrop(jwb, img),
                               rtol=1e-5, atol=1e-6)
    t = TS.encode_centertwocrop_multiscale(twb, img)
    np.testing.assert_allclose(np.linalg.norm(t), 1.0, rtol=1e-6)
    np.testing.assert_allclose(t, JS.encode_centertwocrop_multiscale(
        jwb, img), rtol=1e-5, atol=1e-6)
    assert TS.FasterRCNN is detection.FasterRCNN
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TS.resnet101v6()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.resnet101v4_preprocess_twocrop_ensemble()(_img())


# ---------------------------------------------------------------------------
# utils: params, misc, profiling
# ---------------------------------------------------------------------------


def test_utils_params_match_jax():
    """The cartesian job table over multi-valued exported keys, with a
    predicated key, a None value and a missing key."""
    from xfr_tpu.utils import params as JP
    from xfr_torch.utils import (iterate_param_sets,
                                 prune_unneeded_exports)

    params = {"net": ["a", "b"], "mask": ["00002", "00005", "00007"],
              "ebp": [6], "subtree": ["norelu", "all"], "none": None}
    export = ["net", "mask", (lambda p: p["ebp"] == [6], "subtree"),
              (lambda p: False, "ebp"), "none", "missing"]
    got = list(iterate_param_sets(params, export))
    assert got == list(JP.iterate_param_sets(params, export))
    assert len(got) == 2 * 3 * 2
    assert all(len(p["net"]) == len(p["subtree"]) == 1 for p in got)
    assert prune_unneeded_exports(export, params) == \
        JP.prune_unneeded_exports(export, params) == \
        ["net", "mask", "subtree", "none"]


def test_utils_misc_match_jax(tmp_path, monkeypatch, capsys):
    from xfr_tpu.utils import misc as JM
    from xfr_torch.utils import misc as TM

    monkeypatch.delenv("XFR_TEST_VAR", raising=False)
    assert TM.set_default_print_env("XFR_TEST_VAR") is None
    assert TM.set_default_print_env("XFR_TEST_VAR", "x") == "x"
    assert os.environ["XFR_TEST_VAR"] == "x"
    assert JM.set_default_print_env("XFR_TEST_VAR", "y") == "x"
    out = capsys.readouterr().out
    assert out.splitlines() == ["XFR_TEST_VAR=<not set>",
                                "XFR_TEST_VAR=x", "XFR_TEST_VAR=x"]

    src = tmp_path / "a.txt"
    src.write_text("hi")
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    TM.copy_files([str(src)], str(tmp_path / "t"))
    JM.copy_files([str(src)], str(tmp_path / "j"))
    assert os.listdir(tmp_path / "t") == os.listdir(tmp_path / "j") == \
        [str(src).replace("/", "%")]

    x = np.random.RandomState(0).randn(3, 4)
    np.testing.assert_array_equal(TM.denormalize(x, 0.5, 0.4),
                                  JM.denormalize(x, 0.5, 0.4))

    assert TM.init_random_seed(11) == 11
    draws = (np.random.rand(), torch.rand(1).item())
    JM.init_random_seed(11)
    assert np.random.rand() == draws[0]
    torch.manual_seed(11)
    assert torch.rand(1).item() == draws[1]
    assert TM.visible_devices() == [
        torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def test_timer_and_device_trace(tmp_path):
    """Timer as tests/test_data_parallel.py::test_timer_and_profiling
    holds it; device_trace writes one torch.profiler trace file and
    yields the profiler."""
    from xfr_torch.utils.profiling import Timer, device_trace

    t = Timer()
    with t.time("a"):
        pass
    with t.time("a"):
        pass
    assert t.counts["a"] == 2
    assert "a" in t.report()
    with device_trace(str(tmp_path)) as prof:
        torch.ones(8).cumsum(0)
    assert any(e.key == "aten::cumsum" for e in prof.key_averages())
    files = os.listdir(tmp_path)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")


# ---------------------------------------------------------------------------
# cli/unpack_dataset (every case of tests/test_cli.py::test_unpack_dataset_cli)
# ---------------------------------------------------------------------------


def test_unpack_dataset_cli(tmp_path):
    import xfr_torch
    from xfr_torch.cli import unpack_dataset

    ijbc = tmp_path / "IJBC"
    (ijbc / "aligned").mkdir(parents=True)
    # two subject archives whose payload lands under aligned/<ID>/
    for subj in ("101", "202"):
        src = tmp_path / "src" / "aligned" / subj
        src.mkdir(parents=True)
        (src / "img.png").write_bytes(b"fake")
        with tarfile.open(str(ijbc / ("subj-%s.tar.gz" % subj)),
                          "w:gz") as tf:
            tf.add(str(src), arcname="aligned/%s" % subj)

    done = unpack_dataset.unpack_aligned(str(tmp_path), verbose=False)
    assert done == ["101", "202"]
    assert (ijbc / "aligned" / "101" / "img.png").read_bytes() == b"fake"

    # idempotent: a second run skips everything unless force
    assert unpack_dataset.unpack_aligned(str(tmp_path), verbose=False) == []

    # without tarfile.data_filter a fully-unpacked tree stays a no-op, but
    # any run that would extract fails before opening an archive
    with pytest.MonkeyPatch.context() as mp:
        mp.delattr(tarfile, "data_filter")
        assert unpack_dataset.unpack_aligned(str(tmp_path),
                                             verbose=False) == []
        with pytest.raises(RuntimeError, match="data_filter"):
            unpack_dataset.unpack_aligned(str(tmp_path), force=True,
                                          verbose=False)

    assert unpack_dataset.unpack_aligned(str(tmp_path), force=True,
                                         verbose=False) == ["101", "202"]

    # the argparse main drives the same path
    unpack_dataset.main(["--dataset-dir", str(tmp_path), "--force"])

    # archives with escaping paths are refused
    evil = ijbc / "subj-303.tar.gz"
    with tarfile.open(str(evil), "w:gz") as tf:
        p = tmp_path / "x.txt"
        p.write_text("nope")
        tf.add(str(p), arcname="../evil.txt")
    with pytest.raises(ValueError):
        unpack_dataset.unpack_aligned(str(tmp_path), force=True,
                                      verbose=False)

    # symlink-member escapes are refused by the tarfile data filter
    evil.unlink()
    link = ijbc / "subj-404.tar.gz"
    with tarfile.open(str(link), "w:gz") as tf:
        ti = tarfile.TarInfo("aligned/404/link")
        ti.type = tarfile.SYMTYPE
        ti.linkname = "/etc"
        tf.addfile(ti)
    with pytest.raises(tarfile.FilterError):
        unpack_dataset.unpack_aligned(str(tmp_path), force=True,
                                      verbose=False)
    link.unlink()

    # a missing IJBC/ gives a clear error, naming the default root
    with pytest.raises(FileNotFoundError):
        unpack_dataset.unpack_aligned(str(tmp_path / "nowhere"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(xfr_torch, "inpaintgame_dir", str(tmp_path / "dflt"))
        with pytest.raises(FileNotFoundError, match="dflt"):
            unpack_dataset.unpack_aligned()


# ---------------------------------------------------------------------------
# STRise's gallery montage (tests/test_blackbox.py:109-132)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_gallery", [3, 0])
def test_strise_save_gallery(tmp_path, n_gallery):
    """A 3-image gallery writes a montage; an empty gallery writes an
    empty montage instead of raising in plt.subplots."""
    import matplotlib
    matplotlib.use("Agg")

    from xfr_torch.blackbox.strise import STRise

    probe = np.zeros((224, 224, 3), np.uint8)
    probe[0, 0] = 255
    gal = [np.full((224, 224, 3), v, np.uint8)
           for v in (10, 120, 240)][:n_gallery]
    st = STRise(probe=probe, refs=[probe], gallery=gal,
                black_box_fn=lambda a, b: np.ones((len(a), max(1, len(b)))),
                prior_type="uniform", num_masks=4, device="cpu")
    out = tmp_path / "gallery.png"
    st.save_gallery(str(out))
    assert out.exists() and out.stat().st_size > 0
    if n_gallery:
        assert PIL.Image.open(out).size[0] > 100

"""The port's evaluation stage against the JAX package: TwinClsBatch on
reduced-depth ResNet-101 at full widths, the analysis end to end on the
synthetic mini dataset (tests/fixtures.make_mini_dataset) with the toy
net, the ``run_eval`` and ``hiding_game`` CLIs, and ``show``.

The saliency maps are written once by the JAX package's
``generate_wb_smaps``; each side then reads its own copy of the tree (the
analysis writes the ground-truth pseudo-methods' maps into it).
"""

import glob
import os
import shutil

import numpy as np
import pytest

import jax.numpy as jnp

from xfr_tpu.ebp.engine import Whitebox as JWhitebox
from xfr_tpu.ebp.engine import WhiteboxNetwork as JNet
from xfr_tpu.models import common as JC
from xfr_tpu.models import resnet101 as JR
from tests.fixtures import make_mini_dataset, make_toy_wbnet
from tests.torch_fixtures import jax_params_np, torch_twin

from xfr_torch.ebp.engine import Whitebox, WhiteboxNetwork
from xfr_torch.models import resnet101 as TR
from xfr_torch.models.convert import params_from_jax

METHODS = [
    "meanEBP_mode=all_v06_cpu",
    "contrastive_triplet_ebp_mode=all_v06_cpu",
    "weighted_subtree_triplet_ebp_mode=all,all_v06_top32_cpu",
    "inpaintingMask",
    "diffOrigInpaint",
    "meanEBP_VGG",
]
# |pg - pr| above which the two sides must classify alike: ten times the
# distances' float32 tolerance (test_torch_inpainting.py)
CLS_MARGIN = 1e-5


# ---------------------------------------------------------------------------
# Reduced-depth ResNet-101 at full widths
# ---------------------------------------------------------------------------


def test_twin_cls_batch_reduced_resnet101_matches_jax():
    """One TwinClsBatch of 2 maps, 21 percentiles, so each map is one
    32-row step, on ResNet-101 with one block per stage (16 classes), on
    both sides.  Embeddings within rtol 1e-4 and 1e-5 of their largest
    entry (float32 through the reduced depth: the gap measured on the CPU
    is 8.5e-7 of the largest entry), and the classifications equal
    wherever |pg - pr| > CLS_MARGIN (here every threshold: the smallest
    |pg - pr| is 8.1e-4).

    The distances are ||e - g|| of a unit-normed blend embedding e and a
    gallery embedding g that both sides share, so by the triangle
    inequality two sides' distances differ by at most gap = ||e_t - e_j||
    of their unit-normed rows, which the embedding check above bounds;
    4 float32 epsilons of the largest distance cover the rounding of the
    norms themselves.  A relative limit does not hold on a distance near
    zero: the last threshold's pg is 1.48e-3, and float32 rounding put the
    two sides 1.64e-8 apart there (1.1e-5 relative) on one host.  Measured
    on the CPU: the distance gaps are at most 5.3e-8, the row gaps at most
    5.5e-7."""
    from xfr_tpu.inpainting_game import protocol as JP
    from xfr_torch.inpainting_game import protocol as TP

    nc = 16
    graph, shapes, enc = JR.build_resnet101(num_classes=nc,
                                            layers=(1, 1, 1, 1))
    params = JC.init_params(shapes, seed=0)
    jwb = JWhitebox(JNet(graph, params, encode_tensor=enc,
                         classifier_pname="fc2", num_classes=nc),
                    ebp_version=6)
    tgraph, _, tenc = TR.build_resnet101(num_classes=nc, layers=(1, 1, 1, 1))
    twb = Whitebox(WhiteboxNetwork(
        tgraph, params_from_jax(jax_params_np(params, np.float32),
                                device="cpu"),
        encode_tensor=tenc, classifier_pname="fc2", num_classes=nc),
        ebp_version=6)
    rng = np.random.RandomState(0)
    orig = (rng.rand(3, 224, 224) * 50).astype(np.float32)
    inp = orig + (rng.rand(3, 224, 224) * 30).astype(np.float32)
    gal = np.stack([orig + rng.rand(3, 224, 224).astype(np.float32),
                    inp + rng.rand(3, 224, 224).astype(np.float32)])
    e = np.asarray(jwb.encode(jnp.asarray(gal)))
    e = e / np.linalg.norm(e, axis=1, keepdims=True)
    og, ig = e[:1], e[1:]
    smaps = []
    for _ in range(2):
        s = rng.rand(224, 224)
        s[60:120, 80:150] += 4.0
        smaps.append(s / s.sum())
    pct = np.linspace(0, 100, 21)
    kw = dict(mask_threshold_method="percent-density", percentiles=pct,
              seed=7, include_zero_elements=False)

    def run(P, wb):
        batch = P.TwinClsBatch(wb, orig, inp, og, ig, **kw)
        fins = [batch.launch(s) for s in smaps]
        batch.flush()
        return [f() for f in fins], np.asarray(batch._result)

    got, e_t = run(TP, twb)
    want, e_j = run(JP, jwb)
    assert e_t.shape == (2, 21, 512)
    np.testing.assert_allclose(e_t, e_j, rtol=1e-4,
                               atol=1e-5 * np.abs(e_j).max())
    eps32 = np.finfo(np.float32).eps
    unit = lambda e: e / np.linalg.norm(  # noqa: E731
        e.astype(np.float64), axis=-1, keepdims=True)
    gaps = np.linalg.norm(unit(e_t) - unit(e_j), axis=-1)
    for (cls_t, pg_t, pr_t), (cls_j, pg_j, pr_j), gap in zip(got, want,
                                                             gaps):
        assert len(cls_t) == 21 and not cls_t[0]
        for d_t, d_j in ((pg_t, pg_j), (pr_t, pr_j)):
            bound = gap + 4 * eps32 * np.abs(d_j).max()
            diff = np.abs(d_t.astype(np.float64) - d_j)
            assert (diff <= bound).all(), (diff.max(), gap.max())
        sure = np.abs(pg_j - pr_j) > CLS_MARGIN
        np.testing.assert_array_equal(cls_t[sure], cls_j[sure])


# ---------------------------------------------------------------------------
# The analysis end to end, and the CLIs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def game(tmp_path_factory):
    """The mini dataset (masks 2 and 5), the JAX toy net and its port
    twin, and the whitebox maps written once by the JAX package (plus the
    'vgg' tree that the meanEBP_VGG pseudo-method reads)."""
    from xfr_tpu.inpainting_game import generate as G

    root = tmp_path_factory.mktemp("eval")
    data_dir, smaps_dir = str(root / "data"), str(root / "smaps")
    os.makedirs(data_dir)
    os.makedirs(smaps_dir)
    make_mini_dataset(data_dir, net_name="toynet", mask_ids=(2, 5))
    jwb = make_toy_wbnet(subtree_mode="all")
    for mask_id in ("00002", "00005"):
        G.generate_wb_smaps(jwb, "toynet", "img/p1", 1, mask_id,
                            subtree_mode_weighted="all", ebp_ver=6,
                            overwrite=False, data_dir=data_dir,
                            smaps_dir=smaps_dir)
        src = os.path.join(smaps_dir, "toynet/subject_ID_1/img/p1/inpainted",
                           "%s-meanEBP_mode=all_v06_cpu-saliency.npz"
                           % mask_id)
        dst = os.path.join(smaps_dir, "vgg/subject_ID_1/img/p1/inpainted")
        os.makedirs(dst, exist_ok=True)
        shutil.copy(src, os.path.join(dst, "%s-meanEBP-saliency.npz"
                                      % mask_id))
    return dict(root=root, data_dir=data_dir, smaps_dir=smaps_dir, jwb=jwb,
                twb=torch_twin(jwb))


def _side_dirs(game, tmp_path, side):
    """A copy of the saliency tree and empty output and cache directories
    for one side."""
    d = {k: str(tmp_path / side / k) for k in ("smaps", "out", "cache")}
    shutil.copytree(game["smaps_dir"], d["smaps"])
    return d


def _params(game, d):
    return dict(threshold_type="percent-density", output_dir=d["out"],
                output_subdir=None, cache_dir=d["cache"],
                smap_root=d["smaps"], data_dir=game["data_dir"],
                NET=["toynet"], SUBJECT_ID=[1], MASK_ID=[2, 5],
                METHOD=list(METHODS), IMG_BASENAME=None, reprocess=False,
                seed=42, include_zero_saliency=True, mask_blur_sigma=0,
                balance_masks=True, ignore_missing_saliency_maps=False)


def _twin_cls_margins(cache_dir):
    """min |pg - pr| over every cached twin-classification curve."""
    files = glob.glob(os.path.join(cache_dir, "*twin-cls-dists*.npz"))
    assert files
    return min(float(np.ptp(np.asarray(
        np.load(f, allow_pickle=True)["arr_0"], np.float64)[1:], 0).min())
        for f in files)


def _files(out_dir):
    return sorted(os.path.relpath(f, out_dir)
                  for f in glob.glob(os.path.join(out_dir, "**", "*.png"),
                                     recursive=True))


def _assert_same_rows(got, want):
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for col in got.columns:
        for a, b in zip(got[col], want[col]):
            if isinstance(b, float) and np.isnan(b):
                assert np.isnan(a), col
            else:
                np.testing.assert_array_equal(a, b, err_msg=col)


def test_analysis_matches_jax(game, tmp_path, monkeypatch):
    """make_inpaintinggame_plots on both sides: the same
    nonmate_classification rows (CLS_AS_TWIN, IoU/FP/TP integers), the
    same results.csv and the same plot and overlay files.  A second run
    is served from the cache without a device launch; a corrupt cache
    file is recomputed with identical results."""
    from xfr_tpu.inpainting_game.analysis import (
        human_net_labels_, make_inpaintinggame_plots as jax_plots)
    from xfr_torch.inpainting_game.analysis import make_inpaintinggame_plots

    labels = dict(human_net_labels_, toynet="ToyNet")
    dj, dt = (_side_dirs(game, tmp_path, s) for s in ("jax", "torch"))
    want = jax_plots({"toynet": game["jwb"]}, _params(game, dj),
                     human_net_labels=labels)
    twb = game["twb"]
    got = make_inpaintinggame_plots({"toynet": twb}, _params(game, dt),
                                    human_net_labels=labels)
    # no twin classification sits within float32 reach of a flip
    assert _twin_cls_margins(dt["cache"]) > CLS_MARGIN
    assert len(got) == len(METHODS) * 2
    _assert_same_rows(got, want)
    with open(os.path.join(dt["out"], "results.csv")) as a, \
            open(os.path.join(dj["out"], "results.csv")) as b:
        assert a.read() == b.read()
    assert _files(dt["out"]) == _files(dj["out"])
    assert len(glob.glob(os.path.join(dt["out"], "toynet/mask-*/*/"
                                      "*-idflip.png"))) >= len(METHODS)

    def refuse(*a, **k):
        raise AssertionError("device launch on a cached run")

    with monkeypatch.context() as m:
        for name in ("launch_blend_embeddings_counts",
                     "launch_blend_embeddings_counts_multi"):
            m.setattr(twb, name, refuse)
        again = make_inpaintinggame_plots({"toynet": twb}, _params(game, dt),
                                          human_net_labels=labels)
    _assert_same_rows(again, got)

    victim = sorted(glob.glob(os.path.join(dt["cache"],
                                           "*twin-cls-dists*.npz")))[0]
    with open(victim, "wb") as f:
        f.write(b"PK\x03\x04 truncated")
    redo = make_inpaintinggame_plots({"toynet": twb}, _params(game, dt),
                                     human_net_labels=labels)
    _assert_same_rows(redo, got)
    assert np.load(victim, allow_pickle=True)["arr_0"].shape[0] == 3


def test_cli_run_eval_and_hiding_game_match_jax(game, tmp_path,
                                                monkeypatch):
    """Both CLIs through their argparse surface, the factory patched to
    each side's toy net: equal results.csv; hiding-game CSVs with equal
    keys and scores at float32 tolerance."""
    import pandas as pd

    import xfr_torch.models
    import xfr_tpu.models
    from xfr_torch.cli import hiding_game, run_eval
    from xfr_tpu.cli import hiding_game as jax_hiding_game
    from xfr_tpu.cli import run_eval as jax_run_eval

    monkeypatch.setattr(xfr_tpu.models, "create_wbnet",
                        lambda name, **kw: game["jwb"])
    monkeypatch.setattr(xfr_torch.models, "create_wbnet",
                        lambda name, **kw: game["twb"])
    for cli in (jax_run_eval, run_eval):
        monkeypatch.setitem(cli.human_net_labels_, "toynet", "ToyNet")
    out = {}
    for side, cli, hg, extra in (
            ("jax", jax_run_eval, jax_hiding_game, ["--mesh", "off"]),
            ("torch", run_eval, hiding_game, [])):
        d = _side_dirs(game, tmp_path, side)
        cli.main(["--net", "toynet", "--data-dir", game["data_dir"],
                  "--saliency-dir", d["smaps"], "--cache-dir", d["cache"],
                  "--output", d["out"], "--mask", "2", "5", "--seed", "7",
                  "--method", METHODS[0], METHODS[2], "inpaintingMask"]
                 + extra)
        hg.main(["--net", "toynet", "--method", METHODS[0],
                 "--data-dir", game["data_dir"], "--saliency-dir",
                 d["smaps"], "--output", d["out"], "--delta-pct", "25"])
        out[side] = d["out"]
    assert _twin_cls_margins(d["cache"]) > CLS_MARGIN
    with open(os.path.join(out["torch"], "results.csv")) as a, \
            open(os.path.join(out["jax"], "results.csv")) as b:
        assert a.read() == b.read()
    name = "hiding-game-%s.csv" % METHODS[0]
    got, want = (pd.read_csv(os.path.join(out[s], name))
                 for s in ("torch", "jax"))
    assert len(got) == len(want) == 2 * 5
    keys = ["SUBJECT_ID", "MASK_ID", "ORIGINAL_BASENAME", "hidden_pct"]
    assert got[keys].equals(want[keys])
    np.testing.assert_allclose(got["score"], want["score"], rtol=1e-5)


def test_loaders_and_embeddings_match_jax(game):
    """embeddings from file paths, from a DataFrame of rows and from HWC
    arrays, and preprocess_loader, against the JAX package's (float32,
    the toy net's embeddings at atol 1e-6 of their largest entry)."""
    import pandas as pd

    from xfr_tpu.utils.image import image_loader as jax_loader
    from xfr_torch.utils.image import image_loader

    files = sorted(glob.glob(os.path.join(game["data_dir"], "aligned", "*",
                                          "img", "*", "inpainted",
                                          "*.png")))[:3]
    df = pd.DataFrame({"Filename": files})
    jwb, twb = game["jwb"], game["twb"]
    arrays = list(image_loader(files))
    for a, b in zip(arrays, jax_loader(files)):
        np.testing.assert_array_equal(a, b)
    for src in (files, df, arrays):
        want = np.asarray(jwb.embeddings(src))
        np.testing.assert_allclose(twb.embeddings(src), want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())
    for (im_t, x_t, fn_t), (im_j, x_j, fn_j) in zip(
            twb.preprocess_loader(files), jwb.preprocess_loader(files)):
        assert fn_t == fn_j
        np.testing.assert_array_equal(im_t, im_j)
        np.testing.assert_array_equal(x_t.numpy(), np.asarray(x_j))


def test_eval_core_imports_without_io_packages():
    """The card's machine has no pandas, imageio or matplotlib: the
    protocol, the engine and the analysis module import without them, and
    the image loader and embeddings take a list of arrays."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "for m in ('pandas', 'imageio', 'matplotlib', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "import xfr_torch.inpainting_game.protocol, xfr_torch.show\n"
        "import xfr_torch.inpainting_game.analysis\n"
        "from xfr_torch.utils.image import image_loader\n"
        "ims = [np.zeros((224, 224, 3))] * 2\n"
        "assert len(list(image_loader(ims))) == 2\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)


def test_show_matches_jax(tmp_path):
    """The overlay, the saliency resize and create_save_smap's files."""
    from xfr_tpu import show as JS
    from xfr_torch import show as TS

    rng = np.random.RandomState(1)
    img = rng.rand(96, 80, 3)
    smap = rng.rand(24, 20)
    np.testing.assert_array_equal(TS.blend_saliency_map(img, smap),
                                  JS.blend_saliency_map(img, smap))
    np.testing.assert_array_equal(
        TS.blend_saliency_map(img, smap, blur=True, scale_factor=0.5),
        JS.blend_saliency_map(img, smap, blur=True, scale_factor=0.5))
    np.testing.assert_array_equal(TS.processSaliency(img, smap),
                                  JS.processSaliency(img, smap))
    assert TS.blend_saliency_map(img, np.ones_like(smap)) is img
    for side, S in (("t", TS), ("j", JS)):
        d = tmp_path / side
        d.mkdir()
        S.create_save_smap("m", str(d), False, lambda: smap, "00002", img,
                           None, None)
        assert S.smap_cached("m", str(d), "00002")
    for kind in ("saliency.npz", "saliency-overlay.png"):
        a, b = (str(tmp_path / s / ("00002-m-" + kind)) for s in "tj")
        if kind.endswith("npz"):
            np.testing.assert_array_equal(np.load(a)["saliency_map"],
                                          np.load(b)["saliency_map"])
        else:
            with open(a, "rb") as fa, open(b, "rb") as fb:
                assert fa.read() == fb.read()

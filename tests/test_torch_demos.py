"""The port's demos (``xfr_torch.demo.whitebox``, ``xfr_torch.demo.blackbox``)
against the repo's JAX demos (demo/test_whitebox.py, demo/blackbox_demo.py,
loaded by path and left as they are).

Both packages' ``create_wbnet`` are patched, in each whitebox demo
module, to twin nets of reduced depth from one numpy init: the toy net of
tests/fixtures.py with 101 classes for "resnetv4_pytorch" (the demo's
contrastive scenarios ask for class 100), LightCNN-29 v2 and the VGGFace2
nets at full widths with one block a stage.  The walks run in float64 on
both sides, but for the layerwise and weighted-subtree scenarios (float32:
the JAX package's weighted-subtree walk hands a float32 cotangent to a
float64 vjp).  Every map then passes each package's float32
post-processing, so the maps are held at 1e-6 of their max, the
contrastive ones at 2e-4 (tests/test_torch_eccv20.py's limit for them:
differences of near-equal MWPs, whose float32 combine the JAX package
rounds otherwise; measured 7.8e-5) and the ebp_version 5 (uint8) tiles to
one step.  Each demo's ``main`` runs on ``--device cpu`` into a
temporary directory and writes the JAX demo's file names.
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import make_toy_wbnet
from tests.test_torch_strise import _run_injected
from tests.torch_fixtures import toy_preprocess, twin_whitebox
from xfr_tpu.ebp.engine import Whitebox as JWhitebox
from xfr_tpu.ebp.engine import WhiteboxNetwork as JNet
from xfr_tpu.models import common as JC
from xfr_tpu.models import lightcnn as JL
from xfr_tpu.models import vggface2 as JV2

from xfr_torch.demo import blackbox as TB
from xfr_torch.demo import whitebox as TW
from xfr_torch.models import lightcnn as TL
from xfr_torch.models import vggface2 as TV2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the VGGFace2 nets at one block a stage (full widths)
VF2_STAGES = tuple((name, 1, planes, cout, stride)
                   for name, _, planes, cout, stride in JV2._STAGES)


def _load_jax_demo(name):
    path = os.path.join(REPO, "demo", name + ".py")
    spec = importlib.util.spec_from_file_location("jax_demo_" + name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jw():
    return _load_jax_demo("test_whitebox")


@pytest.fixture(scope="module")
def jb():
    return _load_jax_demo("blackbox_demo")


def _cast(params, dtype):
    return {k: {kk: jnp.asarray(vv, dtype) for kk, vv in v.items()}
            for k, v in params.items()}


def _jax_cast(pre, dtype):
    return lambda im: jnp.asarray(pre(im), dtype)


def _jax_net(name, ebp_version=None, ebp_subtree_mode=None,
             dtype=np.float64):
    """The JAX Whitebox that stands in for create_wbnet(name), in ``dtype``
    (its preprocessing too: encode runs in the input's dtype)."""
    if name == "lightcnn":
        graph, shapes, enc = JL.build_lightcnn29v2(num_classes=9,
                                                   layers=(1, 1, 1, 1))
        net = JNet(graph, JC.init_params(shapes, seed=0, dtype=dtype),
                   encode_tensor=enc, classifier_pname="fc2",
                   num_classes=9,
                   preprocess=_jax_cast(JL.preprocess_lightcnn, dtype),
                   embed_dim=256, name=name)
        mode = ebp_subtree_mode or "affineonly_with_prior"
    elif name in ("vggface2_resnet50", "senet50_256"):
        build = (JV2.build_senet50_256 if name == "senet50_256"
                 else JV2.build_resnet50_128)
        saved = JV2._STAGES
        JV2._STAGES = VF2_STAGES
        try:
            graph, shapes, enc = build()
        finally:
            JV2._STAGES = saved
        net = JNet(graph, JC.init_params(shapes, seed=0, dtype=dtype),
                   encode_tensor=enc, classifier_pname="fc1",
                   num_classes=2,
                   preprocess=_jax_cast(JV2.preprocess_vggface2, dtype),
                   embed_dim=int(shapes["fc1"]["w"][1]), name=name)
        mode = ebp_subtree_mode or "norelu"
    else:
        assert name == "resnetv4_pytorch"
        net = make_toy_wbnet(num_classes=101, seed=0).net
        net.params = _cast(net.params, dtype)
        net._preprocess = _jax_cast(net._preprocess, dtype)
        mode = ebp_subtree_mode or "norelu"
    return JWhitebox(net, ebp_version=ebp_version, ebp_subtree_mode=mode,
                     eps=1e-12, compute_dtype=jnp.dtype(dtype))


def _torch_preprocess(name, dtype):
    def pre(im):
        if name == "lightcnn":
            x = TL.preprocess_lightcnn(im, device="cpu")
        elif name in ("vggface2_resnet50", "senet50_256"):
            x = TV2.preprocess_vggface2(im, device="cpu")
        else:
            x = toy_preprocess(im)
        return x.to(dtype)
    return pre


def _patch_factories(jw, monkeypatch, dtype):
    """Patch both whitebox demos' create_wbnet to twin nets in ``dtype``;
    returns the list of the port's calls."""
    calls = []
    tdtype = getattr(torch, np.dtype(dtype).name)

    def tcreate(name, device="cuda", **kw):
        assert device == "cpu"
        calls.append((name, kw))
        return twin_whitebox(_jax_net(name, dtype=dtype, **kw), dtype=dtype,
                             preprocess=_torch_preprocess(name, tdtype),
                             compute_dtype=tdtype)

    monkeypatch.setattr(jw, "create_wbnet", lambda name, **kw: _jax_net(
        name, dtype=dtype, **kw))
    monkeypatch.setattr(TW, "create_wbnet", tcreate)
    return calls


@pytest.fixture
def nets(jw, monkeypatch):
    """Both demos' create_wbnet patched to float64 twins."""
    return _patch_factories(jw, monkeypatch, np.float64)


@pytest.fixture
def jax_maps(jw, monkeypatch, tmp_path):
    """Every map the JAX demo draws (its ``_blend`` recorded), written
    under tmp_path instead of beside the demo."""
    maps = []
    blend = jw._blend

    def rec(img, smap, *a, **kw):
        maps.append(np.asarray(smap))
        return blend(img, smap, *a, **kw)

    monkeypatch.setattr(jw, "_blend", rec)
    (tmp_path / "jax").mkdir()
    monkeypatch.setattr(jw, "OUTDIR", str(tmp_path / "jax"))
    return maps


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    top = max(np.abs(want).max(), 1e-30)
    assert np.isfinite(got).all() and np.abs(got).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * top)


def _tile_close(got, want):
    """A uint8 map against the tile the JAX demo drew from its own (the
    map over its max): one uint8 step apart at most."""
    assert got.dtype == np.uint8
    _close(np.float32(got) / max(np.max(got), 1e-12), want, 1.0 / 255 + 1e-6)


CONTRASTIVE = ("contrastive_ebp", "truncated_contrastive_ebp",
               "contrastive_triplet_ebp", "truncated_contrastive_triplet_ebp")


@pytest.mark.parametrize("scenario", ("ebp",) + CONTRASTIVE[:2] + (
    "triplet_ebp",) + CONTRASTIVE[2:])
def test_whitebox_scenario_matches_jax(jw, nets, jax_maps, tmp_path,
                                       scenario):
    """The six scenarios on create_wbnet("resnetv4_pytorch"): each on a
    fresh net, the same map as the JAX demo's and the same file."""
    getattr(jw, scenario)(jw.create_wbnet("resnetv4_pytorch"))
    got = getattr(TW, scenario)(TW.create_wbnet("resnetv4_pytorch",
                                                device="cpu"),
                                outdir=str(tmp_path))
    assert len(jax_maps) == 1
    _close(got, jax_maps[0], 2e-4 if scenario in CONTRASTIVE else 1e-6)
    name = "test_whitebox_%s.jpg" % scenario
    assert sorted(os.listdir(tmp_path)) == ["jax", name]
    assert os.listdir(tmp_path / "jax") == [name]


def test_layerwise_and_weighted_subtree_match_jax(jw, jax_maps, tmp_path,
                                                  monkeypatch):
    """layerwise_ebp at stride 37 on ebp_version 5 (uint8 tiles), and the
    weighted-subtree triplet scenario at top-64 over every candidate:
    the selected subtrees' maps and the merged map, tile by tile.  In
    float32 on both sides (the JAX package's weighted-subtree walk hands
    a float32 cotangent to a float64 vjp), where these uint8 maps agree
    to one step (tests/test_torch_eccv20.py's limit)."""
    _patch_factories(jw, monkeypatch, np.float32)
    kw = dict(ebp_version=5, ebp_subtree_mode="all")
    jw.layerwise_ebp(jw.create_wbnet("resnetv4_pytorch", **kw))
    got = TW.layerwise_ebp(TW.create_wbnet("resnetv4_pytorch", device="cpu",
                                           **kw), outdir=str(tmp_path))
    assert len(got) == len(jax_maps) >= 1
    for a, b in zip(got, jax_maps):
        _tile_close(a, b)
    n = len(jax_maps)
    jw.weighted_subtree_triplet_ebp(
        jw.create_wbnet("resnetv4_pytorch", ebp_version=5), topk=64)
    got = TW.weighted_subtree_triplet_ebp(
        TW.create_wbnet("resnetv4_pytorch", device="cpu", ebp_version=5),
        topk=64, outdir=str(tmp_path))
    want = jax_maps[n:]
    assert len(got) == len(want) >= 2
    for a, b in zip(got, want):
        _tile_close(a, b)
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(
        f for f in os.listdir(tmp_path) if f != "jax")


@pytest.mark.parametrize("scenario", ["ebp_lightcnn", "ebp_resnet50_128"])
def test_other_matcher_scenarios_match_jax(jw, nets, jax_maps, tmp_path,
                                           scenario):
    """ebp_lightcnn (affineonly) and ebp_resnet50_128 on their reduced
    nets: the returned maps agree."""
    want = getattr(jw, scenario)()
    got = getattr(TW, scenario)("cpu", str(tmp_path))
    _close(got, want, 1e-6)
    name = "test_whitebox_%s.jpg" % scenario
    assert sorted(os.listdir(tmp_path)) == ["jax", name]
    assert os.listdir(tmp_path / "jax") == [name]


def test_senet_scenario_raises_in_both(jw, nets):
    """ebp_senet50_256: EBP refuses the SE blocks' Sigmoid in both
    packages."""
    with pytest.raises(ValueError):
        jw.ebp_senet50_256()
    with pytest.raises(ValueError):
        TW.ebp_senet50_256("cpu")


def test_whitebox_main_writes_the_jax_demo_files(jw, nets, tmp_path):
    """main(--quick --device cpu --outdir) runs every scenario the JAX
    main runs, with the same factory calls, and writes the JAX demo's
    file names."""
    TW.main(["--quick", "--device", "cpu", "--outdir", str(tmp_path),
             "--wsebp-max-candidates", "6"])
    want = ["test_whitebox_%s.jpg" % s for s in (
        "ebp", "contrastive_ebp", "truncated_contrastive_ebp",
        "triplet_ebp", "contrastive_triplet_ebp",
        "truncated_contrastive_triplet_ebp", "ebp_resnet50_128",
        "ebp_lightcnn")] + [
        "test_whitebox_weighted_subtree_ebp_topk_64_mask_nose.jpg"]
    assert sorted(os.listdir(tmp_path)) == sorted(want)
    assert [c[0] for c in nets] == ["resnetv4_pytorch", "resnetv4_pytorch",
                                    "vggface2_resnet50", "lightcnn"]
    assert nets[1][1] == {"ebp_version": 5}
    assert nets[3][1] == {"ebp_subtree_mode": "affineonly"}


def test_blackbox_custom_bb_matches_jax(jb):
    """--custom-bb (the score-only contract, uniform prior): the port's
    STRise as its demo builds it and the JAX demo's, given the same 200
    grids and shifts (the packages draw from different generators), give
    the same mask scores and saliency map."""
    from xfr_tpu.blackbox import STRise as JSTRise

    probe, refs, gallery = jb._subject_files(0)
    tp, tr, tg = TB._subject_files(0)
    for a, b in ((tp, probe), (tr[0], refs[0]), (tg[0], gallery[0])):
        np.testing.assert_array_equal(a, b)
    jst = JSTRise(probe=probe, refs=refs, gallery=gallery,
                  black_box_fn=jb._patch_signature_bb, prior_type="uniform",
                  num_masks=200, seed=0)
    st, tag = TB.make_strise(TB.parse_args(
        ["--custom-bb", "--num-masks", "200", "--device", "cpu"]))
    assert tag == "custom" and st.prior_type == "uniform"
    assert st.black_box_fn is TB._patch_signature_bb
    rng = np.random.RandomState(3)
    grids = np.ones((200, 19 * 19), np.float32)
    for i in range(200):
        grids[i, rng.choice(19 * 19, 1, replace=False)] = 0
    grids = grids.reshape(200, 19, 19)
    shifts = rng.randint(0, 12, (200, 2)).astype(np.int32)
    _run_injected(jst, grids, shifts, jnp.asarray)
    _run_injected(st, grids, shifts, torch.from_numpy)
    assert (np.asarray(jst.mask_scores) > 0).sum() > 0
    # the float32 masks agree to 4e-6 (tests/test_torch_strise.py), and
    # the contract's means over a patch to a few parts in a million
    np.testing.assert_allclose(st.mask_scores, np.asarray(jst.mask_scores),
                               rtol=1e-5, atol=1e-9)
    np.testing.assert_array_equal(st.mask_scores > 0,
                                  np.asarray(jst.mask_scores) > 0)
    # min-max normalized after the combine: tests/test_torch_strise.py's
    # limit (measured 8.6e-5)
    _close(st.saliency_map, jst.saliency_map, 1e-3)


def test_blackbox_mains_write_the_jax_demo_files(jb, tmp_path, monkeypatch,
                                                 capsys):
    """Both demos' main with --custom-bb into temporary directories write
    the same file name and print the positive-score count of all the
    masks; the port's main without --custom-bb (its built-in scorer
    patched to the toy net) writes the JAX demo's other file name."""
    for d in ("jax", "torch", "resnet"):
        (tmp_path / d).mkdir()
    monkeypatch.setattr(jb, "OUTDIR", str(tmp_path / "jax"))
    argv = ["--custom-bb", "--num-masks", "64"]
    jb.main(argv)
    TB.main(argv + ["--device", "cpu", "--outdir", str(tmp_path / "torch")])
    assert os.listdir(tmp_path / "torch") == os.listdir(tmp_path / "jax") \
        == ["blackbox_demo_subject_0_custom.jpg"]
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("mask_scores:")]
    assert len(lines) == 2 and all(ln.endswith(" of 64") for ln in lines)

    import xfr_torch.models

    toy = make_toy_wbnet(num_classes=4, seed=0)
    twb = twin_whitebox(toy, preprocess=toy_preprocess)
    monkeypatch.setattr(xfr_torch.models, "create_wbnet",
                        lambda name, **kw: twb)
    st = TB.main(["--num-masks", "40", "--device", "cpu", "--outdir",
                  str(tmp_path / "resnet")])
    assert os.listdir(tmp_path / "resnet") == [
        "blackbox_demo_subject_0_resnetv6.jpg"]
    assert st.prior_type == "mean_ebp" and len(st.mask_scores) == 40
    assert np.isfinite(st.saliency_map).all()

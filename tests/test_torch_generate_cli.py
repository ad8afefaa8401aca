"""The port's generation-stage CLIs against the JAX package's, through
their argparse surface: the job table and its shards, the whitebox and
blackbox generators end to end with the factory patched to the toy net on
the CPU, the dataset filter, and the match-threshold calibration
(tests/test_cli.py:24-75,167-265,474 on the port)."""

import glob
import os

import numpy as np
import pytest

from tests.fixtures import make_mini_dataset, make_toy_wbnet
from tests.torch_fixtures import torch_twin

SMAP_SUBDIR = "toynet/subject_ID_1/img/p1/inpainted"


@pytest.fixture(scope="module")
def cli_env(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data_dir = str(root / "data")
    os.makedirs(data_dir)
    make_mini_dataset(data_dir, net_name="toynet", mask_ids=(2, 5))
    return dict(root=root, data_dir=data_dir)


def test_job_table_and_sharding_match_jax(cli_env):
    """build_job_table under every filter, and shard_jobs, equal to the
    JAX package's; the shards are disjoint and cover the table."""
    from xfr_torch.cli import generate_wb_saliency as T
    from xfr_tpu.cli import generate_wb_saliency as J

    d = cli_env["data_dir"]
    for args in ((None, None, None), (None, ["00002"], None),
                 ([1], [5], None), (None, None, ["p1"]),
                 (None, None, ["nope"])):
        jobs = T.build_job_table(["toynet"], *args, d)
        assert jobs == J.build_job_table(["toynet"], *args, d)
    jobs = T.build_job_table(["toynet"], None, None, None, d)
    assert len(jobs) == 2 and {j["mask_id"] for j in jobs} == {"00002",
                                                               "00005"}
    shards = [T.shard_jobs(jobs, i, 2) for i in range(2)]
    assert shards == [J.shard_jobs(jobs, i, 2) for i in range(2)]
    assert sorted(map(str, shards[0] + shards[1])) == sorted(map(str, jobs))
    assert not set(map(str, shards[0])) & set(map(str, shards[1]))

    parser = __import__("argparse").ArgumentParser()
    T.add_common_args(parser)
    assert T.resolve_shards(parser.parse_args([])) == (0, 1)
    assert T.resolve_shards(parser.parse_args(
        ["--shard-index", "1", "--num-shards", "3"])) == (1, 3)


@pytest.fixture
def toy_factory(monkeypatch):
    """create_wbnet of both packages patched to the toy net (the port's
    twin on the CPU); returns the two nets and the port's build count."""
    import xfr_torch.models
    import xfr_tpu.models

    jwb = make_toy_wbnet(subtree_mode="all")
    twb = torch_twin(jwb)
    built = []

    def create(name, **kw):
        built.append((name, kw))
        return twb

    monkeypatch.setattr(xfr_tpu.models, "create_wbnet",
                        lambda name, **kw: jwb)
    monkeypatch.setattr(xfr_torch.models, "create_wbnet", create)
    return jwb, twb, built


@pytest.mark.parametrize("batch", ["8", "0"])
def test_generate_wb_cli_end_to_end(cli_env, tmp_path, toy_factory, batch):
    """The whitebox CLI, batched (the default batch of 8) and serial
    (--batch-size 0), four methods on both masks: the JAX CLI's file
    names, finite maps; the dtype flags reach the engine."""
    import torch

    from xfr_torch.cli import generate_wb_saliency as T
    from xfr_tpu.cli import generate_wb_saliency as J

    _, twb, built = toy_factory
    out, jout = str(tmp_path / "t"), str(tmp_path / "j")
    base = ["--net", "toynet", "--data-dir", cli_env["data_dir"],
            "--batch-size", batch]
    T.main(base + ["--saliency-dir", out])
    J.main(base + ["--saliency-dir", jout, "--mesh", "off"])
    assert [name for name, _ in built] == ["toynet"]
    assert twb.wsebp_dtype == torch.bfloat16
    assert twb.contrastive_dtype == torch.float32
    names = sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(out, SMAP_SUBDIR, "*")))
    assert names == sorted(os.path.basename(f) for f in glob.glob(
        os.path.join(jout, SMAP_SUBDIR, "*")))
    npz = [n for n in names if n.endswith(".npz")]
    assert len(npz) == 8 and all(n.endswith("_cpu-saliency.npz")
                                 for n in npz)
    for n in npz:
        sm = np.load(os.path.join(out, SMAP_SUBDIR, n))["saliency_map"]
        assert sm.shape == (224, 224) and np.isfinite(sm).all()


def test_generate_bb_cli_builds_one_net(tmp_path, toy_factory):
    """The blackbox CLI on "resnetv4_pytorch" (patched to the toy net on
    the CPU), the default mean-EBP prior, 64 masks: the resident net is
    aliased under ("resnetv4_pytorch", None), so one net is built for the
    matcher and the prior, and the map is written under the JAX CLI's
    name."""
    from xfr_torch.cli import generate_bb_saliency as T

    _, twb, built = toy_factory
    data_dir = str(tmp_path / "data")
    os.makedirs(data_dir)
    make_mini_dataset(data_dir, net_name="resnetv4_pytorch", mask_ids=(2,))
    out = str(tmp_path / "smaps")
    T.main(["--data-dir", data_dir, "--saliency-dir", out, "--mask", "2",
            "--num-masks", "64"])
    assert built == [("resnetv4_pytorch", {"ebp_version": 6})]
    files = glob.glob(os.path.join(
        out, "resnetv4_pytorch/subject_ID_1/img/p1/inpainted", "*.npz"))
    assert [os.path.basename(f) for f in files] == [
        "00002-bbox-rise-2elem_blur=4_scale_12-saliency.npz"]
    sm = np.load(files[0])["saliency_map"]
    assert np.isfinite(sm).all() and sm.max() > 0


def test_bb_cli_score_precision_default_is_high(tmp_path, monkeypatch,
                                                toy_factory):
    """--score-precision defaults to "high" and maps "default" to None
    (TF32 allowed) (tests/test_cli.py:474 on the port); STRise runs where
    the net lives."""
    from xfr_torch.cli import generate_bb_saliency as T
    from xfr_torch.inpainting_game import generate as G

    make_mini_dataset(str(tmp_path), net_name="resnetv4_pytorch",
                      mask_ids=(2,))
    seen = []
    monkeypatch.setattr(G, "generate_bb_smaps", lambda *a, **kw: seen.append(
        (kw["score_precision"], str(kw["device"]))))
    base = ["--data-dir", str(tmp_path), "--saliency-dir",
            str(tmp_path / "smaps"), "--mask", "2"]
    T.main(base)
    assert seen == [("high", "cpu")]
    seen.clear()
    T.main(base + ["--score-precision", "default"])
    assert seen == [(None, "cpu")]


@pytest.mark.parametrize("average", [True, False])
def test_filter_dataset_matches_jax(tmp_path, monkeypatch, average):
    """filter_dataset on the mini dataset (masks 0 and 2; mask 0 doubles
    as the original pattern) with each side's toy net: the same
    filtered_masks_threshold CSV, with and without --average-nonmates.
    The match threshold is set midway between the probe's and the twin's
    distance to a ref, as tests/test_cli.py sets it."""
    import xfr_torch.models
    import xfr_tpu.models
    from xfr_torch.cli import filter_dataset as T
    from xfr_tpu.cli import filter_dataset as J

    data_dir = str(tmp_path / "data")
    os.makedirs(data_dir)
    make_mini_dataset(data_dir, net_name="toynet", mask_ids=(0, 2))
    jwb = make_toy_wbnet(subtree_mode="all")
    f = os.path.join(data_dir, "aligned/1/img/%s/inpainted/00000_%s.png")
    e = jwb.embeddings([f % ("p1", "truth"), f % ("p1", "out_0"),
                        f % ("ref0", "truth")])
    jwb.match_threshold = float((np.linalg.norm(e[0] - e[2])
                                 + np.linalg.norm(e[1] - e[2])) / 2)
    twb = torch_twin(jwb)
    monkeypatch.setattr(xfr_tpu.models, "create_wbnet",
                        lambda name, **kw: jwb)
    monkeypatch.setattr(xfr_torch.models, "create_wbnet",
                        lambda name, **kw: twb)
    argv = ["toynet", "--data-dir", data_dir, "--mask-ids", "0", "2"]
    if not average:
        argv.append("--no-average-nonmates")
    out = os.path.join(data_dir, "filtered_masks_threshold-toynet.csv")
    csv = {}
    for side, cli in (("jax", J), ("torch", T)):
        cli.main(argv)
        with open(out) as fh:
            csv[side] = fh.read()
        os.remove(out)
    assert csv["torch"] == csv["jax"]
    assert "PROBE" in csv["torch"] and "REF" in csv["torch"]


def test_match_threshold_calibration_matches_jax(tmp_path, monkeypatch):
    """fit_match_threshold equal to the JAX package's on synthetic
    distances; calc_subject_dists on an IJB-C-shaped fixture (4 subjects x
    2 sightings, two seeds) with each side's toy net writes the same
    files, the distances within float32 tolerance (rtol 1e-5, atol 1e-6:
    a mate distance between two unit-norm float32 embeddings of nearly
    the same image is of order 1e-3, and the frameworks' float32 encodes
    move it by 2e-7); the port's
    calc_match_threshold reads them and writes its ROC plot
    (tests/test_cli.py:75-91,167-219)."""
    import imageio.v2 as imageio
    import pandas as pd

    import xfr_torch.models
    import xfr_tpu.models
    from xfr_torch.cli import calc_match_threshold, calc_subject_dists
    from xfr_torch.inpainting_game.dists import fit_match_threshold
    from xfr_tpu.cli import calc_subject_dists as jax_calc_subject_dists
    from xfr_tpu.inpainting_game.dists import \
        fit_match_threshold as jax_fit

    rng = np.random.RandomState(0)
    mate = np.abs(rng.randn(2000) * 0.1 + 0.4)
    nonmate = np.abs(rng.randn(50000) * 0.1 + 1.4)
    got, want = fit_match_threshold(mate, nonmate), jax_fit(mate, nonmate)
    assert got[:2] == want[:2]
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_array_equal(a, b)

    rng = np.random.RandomState(9)
    rows = []
    os.makedirs(tmp_path / "protocols")
    os.makedirs(tmp_path / "images")
    for sid in range(1, 5):
        base = (rng.rand(240, 240, 3) * 120 + 40).astype(np.uint8)
        base[30 * sid // 2:120, 40:200, sid % 3] = 230
        for k in range(2):
            img = np.clip(base.astype(int) + rng.randint(-12, 12, base.shape),
                          0, 255).astype(np.uint8)
            fn = "images/s%d_%d.png" % (sid, k)
            imageio.imwrite(tmp_path / fn, img)
            rows.append({"SUBJECT_ID": sid, "FILENAME": fn, "FACE_X": 8,
                         "FACE_Y": 8, "FACE_WIDTH": 220, "FACE_HEIGHT": 220})
    pd.DataFrame(rows).to_csv(tmp_path / "protocols" / "ijbc_metadata.csv",
                              index=False)
    monkeypatch.setenv("IJBC_PATH", str(tmp_path))
    jwb = make_toy_wbnet(subtree_mode="all")
    twb = torch_twin(jwb)
    monkeypatch.setattr(xfr_tpu.models, "create_wbnet",
                        lambda name, **kw: jwb)
    monkeypatch.setattr(xfr_torch.models, "create_wbnet",
                        lambda name, **kw: twb)
    outs = {}
    for side, cli in (("jax", jax_calc_subject_dists),
                      ("torch", calc_subject_dists)):
        outs[side] = str(tmp_path / side)
        cli.main(["--net", "toynet", "--seeds", "0", "1", "--num-subjects",
                  "4", "--num-nonmates", "3", "--output", outs[side]])
    names = sorted(os.listdir(outs["torch"]))
    assert names == sorted(os.listdir(outs["jax"])) == [
        "dists_net=toynet_seed=0.npz", "dists_net=toynet_seed=1.npz"]
    for n in names:
        a, b = (np.load(os.path.join(outs[s], n)) for s in ("torch", "jax"))
        for k in ("mate_dists", "nonmate_dists"):
            assert a[k].shape == b[k].shape and len(a[k]) >= 2
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6)
    calc_match_threshold.main(["toynet", "--dists-dir", outs["torch"]])
    assert os.path.exists(os.path.join(outs["torch"], "roc.png"))

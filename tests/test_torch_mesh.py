"""The inference side under a device mesh: every batched entry point of
the port in gloo groups of 2 and 4 processes (one (world, 1) mesh each)
against the un-meshed port and against the JAX package under its own mesh
on 4 of the 8 virtual CPU devices (tests/conftest.py), on the toy net
(tests/fixtures.make_toy_wbnet's graph and parameters).

The ranks import no JAX: tests/torch_fixtures.mesh_entry_results runs
every entry point from one npz of inputs, the same code for the plain
port in this process and for each rank.  Every rank must return the same
arrays, bit for bit.

Tolerances.  The batched entry points cast their probes to float32 on
both sides (as tests/test_torch_whitebox.py says), and a rank encodes
fewer rows per batch than one process does, so the meshed port stands
from the plain port by float32 rounding of another batch shape: MESH_REL
of each array's largest value (read: 4.9e-7 at most).  Against JAX the
existing parity tolerances hold: maps rtol 1e-4 / atol 1e-6
(tests/test_torch_whitebox.py), embeddings rtol 1e-5 / atol 1e-6
(tests/test_sharding.py), STRise scores 2.5e-7 absolute and maps 1e-3
(tests/test_torch_strise.py).  The per-probe weighted-subtree and subtree
paths run in float64 and cast each candidate map to float32 as the
reference does: F32_STEPS of the map's max on both comparisons
(tests/test_torch_generate.py; read: 0 on the toy net).
"""

import functools
import glob
import os
import shutil

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.fixtures import make_mini_dataset, make_toy_wbnet
from tests.torch_fixtures import (MESH_CLI_METHODS, MESH_T, MESH_T_MULTI,
                                  WS_TOPK, jax_params_np, load_params,
                                  mesh_entry_results, save_params,
                                  spawn_ranks, toy_whitebox)

MESH_REL = 2e-6
RTOL, ATOL = 1e-4, 1e-6
EMB_RTOL, EMB_ATOL = 1e-5, 1e-6
SCORE_ATOL, MAP_ATOL = 2.5e-7, 1e-3
F32_STEPS = 1e-6
NUM_CLASSES, SEED, MODE = 4, 5, "all"
WORLDS = (2, 4)


def _toy_jax():
    return make_toy_wbnet(num_classes=NUM_CLASSES, seed=SEED,
                          subtree_mode=MODE)


def _toy_port(dtype=None):
    """The port's toy Whitebox over the JAX toy net's parameters."""
    params = {k: {kk: torch.tensor(vv) for kk, vv in v.items()}
              for k, v in jax_params_np(_toy_jax().net.params).items()}
    return toy_whitebox(params, NUM_CLASSES, MODE, dtype)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The inputs of every entry point and the toy net's parameters, in
    one npz the ranks read."""
    jwb = _toy_jax()
    rng = np.random.RandomState(11)
    probes = rng.rand(5, 3, 224, 224).astype(np.float32)
    ems, ens = (v / np.linalg.norm(v, axis=1, keepdims=True)
                for v in rng.rand(2, 5, 12).astype(np.float32))
    orig, inp = rng.rand(2, 3, 224, 224).astype(np.float32)
    # the mask-0 blend (the original) must classify as the original
    gal_o = np.asarray(jwb.embeddings(orig[None])[0], np.float64)
    gal_i = rng.rand(12)
    smaps = rng.rand(3, 224, 224)
    r8 = np.random.RandomState(8)
    st_probe = r8.randint(0, 256, (224, 224, 3)).astype(np.uint8)
    st_probe[32:80, 32:80] = 220  # textured probe, as test_torch_strise's
    st_gal = r8.randint(0, 256, (224, 224, 3)).astype(np.uint8)
    r0 = np.random.RandomState(0)
    grids = np.ones((40, 64), np.float32)
    for g in grids:
        g[r0.choice(64, 2, replace=False)] = 0
    path = str(tmp_path_factory.mktemp("mesh") / "data.npz")
    save_params(
        path, jax_params_np(jwb.net.params), num_classes=NUM_CLASSES,
        mode=np.asarray(MODE), probes=probes, ems=ems, ens=ens,
        probe64=rng.rand(1, 3, 224, 224) * 50, orig=orig, inp=inp,
        counts=rng.randint(0, MESH_T + 1, 224 * 224).astype(np.uint8),
        counts_multi=rng.randint(0, MESH_T_MULTI + 1,
                                 (3, 224 * 224)).astype(np.uint8),
        masks_general=rng.rand(10, 224, 224) > 0.5,
        smaps=smaps / smaps.sum(axis=(1, 2), keepdims=True),
        gal_o=gal_o / np.linalg.norm(gal_o),
        gal_i=gal_i / np.linalg.norm(gal_i), pct=np.arange(0, 101, 10),
        st_probe=st_probe, st_gal=st_gal, st_grids=grids.reshape(40, 8, 8),
        st_shifts=r0.randint(0, 28, (40, 2)).astype(np.int32))
    return path


@pytest.fixture(scope="module")
def plain(data):
    return mesh_entry_results(data)


@pytest.fixture(scope="module", params=WORLDS)
def ranks(request, data, tmp_path_factory):
    """Every rank's results in a gloo group of ``world`` processes."""
    world = request.param
    out = tmp_path_factory.mktemp("ranks%d" % world)
    spawn_ranks("mesh_entry_worker", world, out, data, str(out),
                timeout=300)
    return [dict(np.load(str(out / ("rank%d.npz" % r))))
            for r in range(world)]


@pytest.fixture(scope="module")
def jax_mesh(data, monkeypatch_module):
    """The JAX package's results under a (4, 1) mesh of 4 virtual CPU
    devices: the same calls on the same inputs, its fused-blend kernel in
    interpret mode."""
    from xfr_tpu.blackbox import pallas_blend
    from xfr_tpu.blackbox.strise import STRise
    from xfr_tpu.inpainting_game.protocol import TwinClsBatch
    from xfr_tpu.parallel.mesh import make_mesh

    monkeypatch_module.setattr(
        pallas_blend, "fused_mask_blend_preprocess", functools.partial(
            pallas_blend.fused_mask_blend_preprocess, interpret=True))
    mesh = make_mesh((4, 1), ("dp", "mp"), devices=jax.devices()[:4])
    _, d = load_params(data)
    d = {k: v.numpy() if torch.is_tensor(v) else v for k, v in d.items()}
    res = {}

    def fresh(dtype=None):
        wb = _toy_jax()
        if dtype is not None:
            wb.net.params = jax.tree.map(lambda a: jnp.asarray(a, dtype),
                                         wb.net.params)
        wb.batch_size = 8
        return wb.use_mesh(mesh)

    wb = fresh()
    res["emb"] = wb.embeddings(d["probes"])
    for B in (3, 5):
        wb.set_triplet_classifier_batch(d["ems"][:B], d["ens"][:B])
        x = jnp.asarray(d["probes"][:B])
        res["ebp%d" % B] = np.stack(wb.ebp_batch(x))
        res["con1_%d" % B] = np.stack(wb.contrastive_ebp_batch(x, 20))
        con, trunc = wb.contrastive_ebp_batch_both(x, 20)
        res["con%d" % B], res["trunc%d" % B] = np.stack(con), np.stack(trunc)
        res["ws%d" % B] = np.stack([r[0] for r in (
            wb.weighted_subtree_ebp_batch(x, topk=WS_TOPK,
                                          subtree_mode=MODE))])
    wb64 = fresh(jnp.float64)
    # the JAX package's float32 one-hot cotangent is refused by its
    # float64 walk's vjp (tests/test_torch_generate.py does the same)
    wb64._onehot = lambda k: jnp.asarray(
        np.eye(wb64.net.num_classes())[k:k + 1])
    wb64.net.set_triplet_classifier(jnp.asarray(d["ems"][0], jnp.float64),
                                    jnp.asarray(d["ens"][0], jnp.float64))
    for path, host in (("fused", False), ("host", True)):
        smap, _, scores, ks = wb64.weighted_subtree_ebp(
            jnp.asarray(d["probe64"]), 0, 1, topk=WS_TOPK, subtree_mode=MODE,
            return_subtree_maps=host)
        res["ws_" + path], res["ws_%s_k" % path] = smap, np.asarray(ks)
    smap, _, ks = wb64.subtree_ebp(jnp.asarray(d["probe64"]), 0, 1, topk=2)
    res["subtree"], res["subtree_k"] = smap, np.asarray(ks)
    orig, inp = d["orig"], d["inp"]
    res["counts"] = wb.launch_blend_embeddings_counts(orig, inp, d["counts"],
                                                      MESH_T)()
    res["counts_multi"] = wb.launch_blend_embeddings_counts_multi(
        orig, inp, d["counts_multi"], MESH_T_MULTI)()
    res["blend_general"] = wb.launch_blend_embeddings(orig, inp,
                                                      d["masks_general"])()
    batch = TwinClsBatch(wb, orig, inp, d["gal_o"], d["gal_i"],
                         "percent-density", percentiles=d["pct"], seed=0)
    fins = [batch.launch(s) for s in d["smaps"]]
    batch.flush()
    for i, fin in enumerate(fins):
        res["twin_cls%d" % i], res["twin_pg%d" % i], res["twin_pr%d" % i] = \
            (np.asarray(v) for v in fin())
    for name, fused_blend in (("scan", False), ("k1", True)):
        w = fresh()
        st = STRise(probe=d["st_probe"], refs=[d["st_probe"]],
                    gallery=[d["st_gal"]], black_box="resnetv6_pytorch",
                    net_dict={("resnetv6_pytorch", 6): w,
                              ("resnetv4_pytorch", None): w},
                    prior_type="mean_ebp", num_masks=40, mask_scale=28,
                    num_mask_elements=2, mask_fill_type="blur", seed=5,
                    batch_size=16, mesh=mesh, use_pallas_blend=fused_blend)
        st.priors[st.prior_type]()
        st._grids_dev = jnp.asarray(d["st_grids"])
        st._shifts_dev = jnp.asarray(d["st_shifts"])
        st._masks_dev_cache = st._masks_np = None
        st.apply_masks()
        st.score_masks()
        st.compute_saliency_map()
        res["st_%s_ref" % name] = st.masked_probe_ref_scores
        res["st_%s_scores" % name] = st.mask_scores
        res["st_%s_map" % name] = np.asarray(st.saliency_map)
    return res


@pytest.fixture(scope="module")
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as m:
        yield m


def _near(got, want, rel):
    """``got`` within ``rel`` of ``want``'s largest value."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


def _meshed_vs_plain_and_jax(ranks, plain, jax_mesh, keys, rtol, atol,
                             rel=MESH_REL):
    for k in keys:
        _near(ranks[0][k], plain[k], rel)
        np.testing.assert_allclose(ranks[0][k], np.asarray(jax_mesh[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def test_every_rank_returns_the_same(ranks, plain):
    """Every rank returns the same (un-meshed) result, bit for bit."""
    for k in plain:
        for r in range(1, len(ranks)):
            np.testing.assert_array_equal(ranks[r][k], ranks[0][k],
                                          err_msg=f"{k} rank {r}")


def test_embeddings_under_mesh(ranks, plain, jax_mesh):
    """embeddings (5 rows over batch_size 8) and encode (4 rows) under the
    mesh."""
    _meshed_vs_plain_and_jax(ranks, plain, jax_mesh, ["emb"], EMB_RTOL,
                             EMB_ATOL)
    _near(ranks[0]["encode"], plain["encode"], MESH_REL)


def test_ebp_batch_under_mesh(ranks, plain, jax_mesh):
    """ebp_batch with B=3 and B=5 probes (padded to a 'dp' multiple)."""
    _meshed_vs_plain_and_jax(ranks, plain, jax_mesh, ["ebp3", "ebp5"], RTOL,
                             ATOL)
    for B in (3, 5):
        _near(ranks[0]["ebp_mwp%d" % B], plain["ebp_mwp%d" % B], MESH_REL)


def test_contrastive_under_mesh(ranks, plain, jax_mesh):
    """contrastive_ebp_batch and the contrastive pair's launch/finish."""
    _meshed_vs_plain_and_jax(
        ranks, plain, jax_mesh,
        ["con1_3", "con3", "trunc3", "con1_5", "con5", "trunc5"], RTOL, ATOL)


def test_weighted_subtree_batch_under_mesh(ranks, plain, jax_mesh):
    """weighted_subtree_ebp_batch with B not a 'dp' multiple (3 and 5
    probes over 2 and 4 ranks): the fused batch path (probes over 'dp')
    with the same selected subtrees, and the host path (per-probe sweeps,
    rows over 'dp')."""
    _meshed_vs_plain_and_jax(ranks, plain, jax_mesh, ["ws3", "ws5"], RTOL,
                             ATOL)
    for B in (3, 5):
        np.testing.assert_array_equal(ranks[0]["ws_sel%d" % B],
                                      plain["ws_sel%d" % B])
        _near(ranks[0]["ws_host%d" % B], plain["ws_host%d" % B], MESH_REL)


def test_per_probe_sweep_rows_over_dp(ranks, plain, jax_mesh):
    """The per-probe weighted_subtree_ebp (fused and host paths) and
    subtree_ebp in float64, their candidate rows over 'dp': the same
    subtrees, and the maps within F32_STEPS of their max."""
    for k in ("ws_fused", "ws_host", "subtree"):
        _near(ranks[0][k], plain[k], F32_STEPS)
        _near(ranks[0][k], jax_mesh[k], F32_STEPS)
        np.testing.assert_array_equal(ranks[0][k + "_k"], plain[k + "_k"])
        np.testing.assert_array_equal(ranks[0][k + "_k"],
                                      jax_mesh[k + "_k"])
    for k in ("ws_fused_scores", "ws_host_scores"):
        np.testing.assert_allclose(ranks[0][k], plain[k], rtol=1e-12)


def test_blend_embeddings_under_mesh(ranks, plain, jax_mesh):
    """launch_blend_embeddings_counts at T=13 (one chunk, padded to a 'dp'
    multiple of chunks, as tests/test_mesh_fastpaths.py:29-51), the
    three-map _counts_multi at T=11, and a general (non-monotone) family."""
    _meshed_vs_plain_and_jax(ranks, plain, jax_mesh,
                             ["counts", "counts_multi", "blend_general"],
                             EMB_RTOL, EMB_ATOL)
    assert ranks[0]["counts"].shape == (MESH_T, 12)
    assert ranks[0]["counts_multi"].shape == (3, MESH_T_MULTI, 12)


def test_counts_multi_pair_refuses_mesh(ranks, plain):
    """launch_blend_embeddings_counts_multi_pair has no mesh form (the
    JAX package asserts); the un-meshed call runs."""
    assert bool(ranks[0]["multi_pair_refused"])
    assert not bool(plain["multi_pair_refused"])


def test_twin_cls_batch_under_mesh(ranks, plain, jax_mesh):
    """TwinClsBatch keeps its multi-map program under a meshed net: the
    same classifications, distances at the embeddings' tolerance."""
    for i in range(3):
        k = "twin_cls%d" % i
        np.testing.assert_array_equal(ranks[0][k], plain[k])
        np.testing.assert_array_equal(ranks[0][k], jax_mesh[k])
        _meshed_vs_plain_and_jax(ranks, plain, jax_mesh,
                                 ["twin_pg%d" % i, "twin_pr%d" % i],
                                 EMB_RTOL, EMB_ATOL)


def test_strise_under_mesh(ranks, plain, jax_mesh):
    """STRise(mesh=) on injected grids and shifts: the materialized-mask
    path (chunks over 'dp') and the fused-blend path (each chunk's rows
    over 'dp'; the kernel's plain version on the CPU), both against JAX
    under its mesh; the one-fetch fused finish and a map from the seeded
    generator's own draws against the plain port."""
    for name in ("scan", "k1"):
        ref, sc, sm = ("st_%s_%s" % (name, s) for s in ("ref", "scores",
                                                         "map"))
        _meshed_vs_plain_and_jax(ranks, plain, jax_mesh, [ref, sc], 0,
                                 SCORE_ATOL)
        _meshed_vs_plain_and_jax(ranks, plain, jax_mesh, [sm], 0, MAP_ATOL)
        np.testing.assert_array_equal(ranks[0][sc] > 0, jax_mesh[sc] > 0)
    for k in ("st_fused_scores", "st_fused_map", "st_drawn_scores",
              "st_drawn_map"):
        _near(ranks[0][k], plain[k], MESH_REL)


def test_strise_refuses_ranks_with_different_draws(ranks):
    """Ranks that drew different masks (seeded by their rank) fail the
    all-gathered checksum, every rank alike."""
    assert all(bool(r["draws_refused"]) for r in ranks)


def test_mesh_helpers(ranks):
    """local_rows splits a padded leading dim; gather_rows returns every
    rank's rows in rank order without the pad rows (bool too); all_true
    and all_equal reduce over the ranks; replicate broadcasts rank 0's
    values and returns them on the device asked for."""
    world = len(ranks)
    per = -(-7 // world)
    rows = np.arange(14, dtype=np.float64).reshape(7, 2)
    for r, res in enumerate(ranks):
        assert res["local_rows"].tolist() == [r * per, (r + 1) * per]
        np.testing.assert_array_equal(res["gathered"], rows)
        assert res["gathered_bool"].tolist() == [i % 2 == 0
                                                 for i in range(world)]
        assert res["all_true"].tolist() == [True, False]
        assert res["all_equal"].tolist() == [True, False]
        assert bool(res["replicate_meta"])
        np.testing.assert_array_equal(res["replicated"], np.zeros(3))


@pytest.mark.parametrize("n_buckets,count", [(1, 4), (2, 2), (3, 3),
                                              (12, 4)])
def test_row_shard_splits_every_bucket(n_buckets, count):
    """ebp_backward_allevents(row_shard=(r, count)): each rank walks its
    run of every bucket (so each rank holds rows of shallow and deep
    buckets), padded to equal shapes; the runs of all ranks, put back in
    event order by row_shard_order, equal the un-sharded bucketed walk bit
    for bit and the cascaded walk within float64 rounding."""
    from xfr_torch.ebp import interpreter as I

    wb = _toy_port(torch.float64)
    graph, n_cand = wb.net.graph, wb.net.graph.n_events - 1
    x = torch.from_numpy(np.random.RandomState(2).rand(1, 3, 224, 224))
    _, values, posvals = wb._capture(wb.net.params, x)
    rng = np.random.RandomState(3)
    elems = torch.as_tensor([rng.randint(0, values[e.tensor][0].numel())
                             for e in graph.events[:n_cand]])
    vals = torch.from_numpy(rng.rand(n_cand))

    def walk(**kw):
        return I.ebp_backward_allevents(
            graph, wb.net.params, values, posvals, elems, vals,
            subtree_mode=MODE, eps=wb.eps, n_buckets=n_buckets, **kw)

    parts = [walk(row_shard=(r, count)) for r in range(count)]
    assert len({p[0].shape for p in parts}) == 1
    order = I.row_shard_order(n_cand, n_buckets, count)
    P = torch.cat([p[0] for p in parts])[order]
    m = torch.cat([p[1] for p in parts])[order]
    P_ref, m_ref = walk()
    torch.testing.assert_close(P, P_ref, rtol=0, atol=0)
    torch.testing.assert_close(m, m_ref, rtol=0, atol=0)
    P_casc, _ = walk(cascade=True)
    torch.testing.assert_close(P, P_casc, rtol=1e-12, atol=0)
    # rank 0's block holds the first row of the first and of the last
    # bucket: every rank walks shallow and deep candidates
    ranges = I._bucket_ranges(n_cand, n_buckets)
    for lo in {ranges[0][0], ranges[-1][0]}:
        assert order.index(lo) < parts[0][0].shape[0]


def test_non_mesh_is_refused():
    """use_mesh, STRise and the mesh helpers refuse what is not a
    DeviceMesh with a 'dp' dim; use_mesh(None) is the un-meshed engine."""
    from xfr_torch.parallel import mesh as M

    wb = _toy_port()
    for bad in (object(), "dp", 2):
        with pytest.raises(ValueError, match="DeviceMesh with a 'dp' dim"):
            wb.use_mesh(bad)
        with pytest.raises(ValueError, match="DeviceMesh"):
            M.dp_size(bad)
    assert wb.use_mesh(None) is wb and wb.mesh is None and wb._dp == 1


# ---------------------------------------------------------------------------
# The CLIs' --mesh in a 2-rank group
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cli_runs(data, tmp_path_factory):
    """The generation CLIs under --mesh auto and --mesh off and run_eval
    under --mesh auto, in a gloo group of 2 (torch_fixtures.
    mesh_cli_worker), on a mini dataset of the "resnetv4_pytorch" net
    (two jobs, masks 2 and 5) with the factory patched to the toy net."""
    root = tmp_path_factory.mktemp("cli")
    data_dir = str(root / "data")
    os.makedirs(data_dir)
    make_mini_dataset(data_dir, net_name="resnetv4_pytorch", mask_ids=(2, 5))
    out = str(root / "out")
    spawn_ranks("mesh_cli_worker", 2, root, data, data_dir, out,
                timeout=400)
    return dict(out=out, data_dir=data_dir, root=root)


def _files(top):
    """{path under ``top``: path} of every file below ``top``."""
    return {os.path.relpath(f, top): f
            for f in glob.glob(os.path.join(top, "**", "*"), recursive=True)
            if os.path.isfile(f)}


@pytest.mark.parametrize("run", ["wb8", "wb0", "bb"])
def test_cli_mesh_auto_writes_what_off_writes(cli_runs, run):
    """--mesh auto (every rank runs both jobs on its rows; rank 0 writes)
    writes the files that --mesh off (one job a rank) writes between its
    ranks, with the same maps; under auto, rank 1 writes nothing.  The
    whitebox CLI batched (8) and serial (0), and the blackbox CLI."""
    out = cli_runs["out"]
    auto = {k: v for k, v in _files(os.path.join(out, run + "_auto",
                                                 "rank0")).items()
            # run_eval's backup method map, written later into this tree
            if "inpaintingMask" not in k}
    assert not _files(os.path.join(out, run + "_auto", "rank1"))
    off = {}
    for r in (0, 1):
        part = _files(os.path.join(out, run + "_off", "rank%d" % r))
        assert part and not set(part) & set(off)
        off.update(part)
    assert sorted(auto) == sorted(off)
    npz = [k for k in auto if k.endswith(".npz")]
    assert len(npz) == (2 if run == "bb" else 8)
    for k in npz:
        got = np.load(auto[k])["saliency_map"]
        want = np.load(off[k])["saliency_map"]
        assert np.isfinite(got).all()
        _near(got, want, MESH_REL)


def test_run_eval_under_mesh(cli_runs, tmp_path, monkeypatch):
    """run_eval --mesh auto in the 2-rank group gives the results.csv of
    one process without a mesh, and rank 1 writes no cache, table or
    plot."""
    import pandas as pd

    import xfr_torch.models
    from xfr_torch.cli import run_eval

    out = cli_runs["out"]
    monkeypatch.setattr(xfr_torch.models, "create_wbnet",
                        lambda name, **kw: _toy_port())
    smaps = str(tmp_path / "smaps")
    shutil.copytree(os.path.join(out, "wb8_auto", "rank0"), smaps)
    run_eval.main(["--net", "resnetv4_pytorch", "--data-dir",
                   cli_runs["data_dir"], "--saliency-dir", smaps,
                   "--cache-dir", str(tmp_path / "cache"), "--output",
                   str(tmp_path / "eval"), "--mask", "2", "5", "--seed", "7",
                   "--mesh", "auto", "--method"] + MESH_CLI_METHODS)
    for kind in ("cache_auto", "eval_auto"):
        assert not _files(os.path.join(out, kind, "rank1"))
        assert _files(os.path.join(out, kind, "rank0"))
    got = pd.read_csv(os.path.join(out, "eval_auto", "rank0", "results.csv"))
    want = pd.read_csv(str(tmp_path / "eval" / "results.csv"))
    assert list(got["method"]) == list(want["method"])
    assert len(got) == len(MESH_CLI_METHODS)
    for col in ("all,far=1e-2", "all,far=5e-2"):
        np.testing.assert_allclose(got[col].values, want[col].values,
                                   rtol=1e-6, atol=1e-9)

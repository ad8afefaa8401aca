"""The port's per-probe weighted-subtree path and the inpainting game's
generation stage against the JAX package.

The walks run on the toy net of ``tests/fixtures.make_toy_wbnet`` with the
JAX net's parameters carried across, in float64 where the test says so
(both sides cast each candidate's map to float32 before its channel sum,
and the ranking scores and injection values to float32 on the host, as
the reference does); the engine's float32 paths on reduced-depth
ResNet-101 (one block per stage) at the limits of
test_torch_whitebox.py's 4-map mix.  The generators run on
``tests/fixtures.make_mini_dataset`` with the toy net on both sides.
"""

import glob
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from xfr_tpu.ebp import interpreter as JI
from xfr_tpu.ebp.engine import Whitebox as JWhitebox
from xfr_tpu.ebp.engine import WhiteboxNetwork as JNet
from xfr_tpu.models import common as JC
from xfr_tpu.models import resnet101 as JR
from tests.fixtures import make_mini_dataset, make_toy_wbnet
from tests.test_endtoend_game import _toy_bb_fn as jax_toy_bb_fn
from tests.torch_fixtures import jax_params_np, torch_twin

from xfr_torch.ebp import interpreter as TI
from xfr_torch.ebp.engine import Whitebox, WhiteboxNetwork
from xfr_torch.models import resnet101 as TR
from xfr_torch.models.convert import params_from_jax

MODES = ["affineonly", "affineonly_with_prior", "norelu", "all"]
# Candidate maps are float64 walks cast to float32, as the reference casts
# them.  The two frameworks' float64 walks agree to about 1e-10 relative,
# so 0.3% of the cast values land one float32 step apart (1.2e-7
# relative): such maps are held at a few float32 steps.
F32_STEPS = 1e-6


def _pair64(mode, seed=3, num_classes=4):
    """The JAX toy net with float64 params and its float64 port twin, both
    with the same unit-norm float64 triplet classifier installed."""
    jwb = make_toy_wbnet(num_classes=num_classes, seed=seed,
                         subtree_mode=mode)
    twb = torch_twin(jwb, np.float64)
    jwb.net.params = {k: {kk: jnp.asarray(vv, jnp.float64)
                          for kk, vv in v.items()}
                      for k, v in jwb.net.params.items()}
    # the JAX package's float32 one-hot cotangent is refused by its
    # float64 walk's vjp: give this instance a float64 one
    jwb._onehot = lambda k: jnp.asarray(
        np.eye(jwb.net.num_classes())[k:k + 1])
    rng = np.random.RandomState(seed + 4)
    em, en = (v / np.linalg.norm(v) for v in rng.rand(2, 12))
    for wb in (jwb, twb):
        wb.net.set_triplet_classifier(em, en)
    return jwb, twb, rng.rand(1, 3, 224, 224)


def _close_to_max(got, want, tol):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# ---------------------------------------------------------------------------
# The traced injection of the EBP walk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cot", ["zero", "random"])
@pytest.mark.parametrize("mode", MODES)
def test_inject_spec_matches_jax(mode, cot):
    """Six (event, element, value) picks, one per row of one port walk,
    against one JAX walk each with the same traced inject_spec, every
    event's MWP at float64 rtol 1e-10.  The picks cover the first and
    last candidate events, event 1, the middle, and one event twice; the
    zero cotangent is the weighted-subtree sweep's, a random one also
    drives the rows' rule where nothing is injected."""
    jwb, twb, x = _pair64(mode)
    g, tg = jwb.net.graph, twb.net.graph
    n_ev = g.n_events
    jp = jwb.net.params
    jv = JI.forward_clean(g, jp, jnp.asarray(x))
    jpv = JI.forward_positive(g, jp, jv)
    tv = TI.forward_clean(tg, twb.net.params, torch.from_numpy(x))
    tpv = TI.forward_positive(tg, twb.net.params, tv)
    rng = np.random.RandomState(MODES.index(mode))
    ev_ids = np.array([0, 1, n_ev // 2, n_ev // 2, n_ev - 3, n_ev - 2],
                      np.int32)
    sizes = [int(np.prod(tv[g.events[e].tensor].shape[1:])) for e in ev_ids]
    elems = np.array([rng.randint(s) for s in sizes], np.int32)
    vals = rng.rand(len(ev_ids))
    R = len(ev_ids)
    cots = (np.zeros((R, 1, 2)) if cot == "zero" else rng.randn(R, 1, 2))
    got = TI.ebp_backward(
        tg, twb.net.params, tv, tpv, torch.from_numpy(cots),
        subtree_mode=mode, eps=jwb.eps,
        inject_spec=tuple(torch.from_numpy(a) for a in (ev_ids, elems,
                                                        vals)))
    for r in range(R):
        want = JI.ebp_backward(
            g, jp, jv, jpv, jnp.asarray(cots[r]), subtree_mode=mode,
            eps=jwb.eps, inject_spec=(jnp.int32(ev_ids[r]),
                                      jnp.int32(elems[r]),
                                      jnp.float64(vals[r])))
        assert sorted(want) == sorted(got)
        for k in want:
            np.testing.assert_allclose(got[k][r].numpy(),
                                       np.asarray(want[k]), rtol=1e-10,
                                       atol=0, err_msg=f"row {r} event {k}")
        inj = got[int(ev_ids[r])][r].reshape(-1)
        assert inj[elems[r]] == vals[r] and int((inj != 0).sum()) == 1


def _ranking64(jwb, twb, x, gating=True):
    """The per-probe ranking pass on both sides, float64: scores and
    injection values at float64 rtol 1e-10, equal argmaxes.  Returns the
    port's as numpy, cast as _wsebp_post casts them."""
    js, ji, jv = jwb._wsebp_grad_fn()(jwb.net.params, jnp.asarray(x),
                                      jwb._onehot(0), gating=gating)
    ts, ti, tv = twb._wsebp_grad_fn()(twb.net.params, torch.from_numpy(x),
                                      twb._onehot(0), gating)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-10,
                               atol=1e-300)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-10,
                               atol=1e-300)
    return (ts.numpy().astype(np.float32), ti.numpy(),
            tv.numpy().astype(np.float32))


@pytest.mark.parametrize("mode", ["norelu", "affineonly_with_prior"])
def test_wsebp_inject_fn_matches_jax_and_the_full_sweep(mode):
    """_wsebp_inject_fn on the 8 top-ranked candidates against the JAX
    program, float64 walks (maps and maxima at rtol 1e-10); with every
    candidate in event order, against the port's own full sweep
    (_wsebp_sweep_fn, bucketed and cascaded, the static one-hot rows of
    _sweep_event_rule) at the same limit."""
    jwb, twb, x = _pair64(mode)
    scores, idxs, vals = _ranking64(jwb, twb, x)
    sub = np.argsort(scores, kind="stable")[-8:].astype(np.int32)
    j_P, j_m = jwb._wsebp_inject_fn()(
        jwb.net.params, jnp.asarray(x), jnp.asarray(sub),
        jnp.asarray(idxs[sub].astype(np.int32)), jnp.asarray(vals[sub]))
    xt = torch.from_numpy(x)
    t_P, t_m = twb._wsebp_inject_fn()(
        twb.net.params, xt, torch.from_numpy(sub),
        torch.from_numpy(idxs[sub].astype(np.int32)),
        torch.from_numpy(vals[sub]))
    assert tuple(t_P.shape) == (8, 1, 56, 56) and t_m.max() > 0
    np.testing.assert_allclose(t_P.numpy(), np.asarray(j_P), rtol=F32_STEPS,
                               atol=0)
    np.testing.assert_allclose(t_m.numpy(), np.asarray(j_m), rtol=F32_STEPS,
                               atol=0)

    n_cand = twb._n_events - 1
    a_P, a_m = twb._wsebp_inject_fn()(
        twb.net.params, xt, torch.arange(n_cand, dtype=torch.int32),
        torch.from_numpy(idxs.astype(np.int32)), torch.from_numpy(vals))
    s_P, s_m = twb._wsebp_sweep_fn(n_buckets=4)(
        twb.net.params, xt, torch.from_numpy(idxs.astype(np.int32)),
        torch.from_numpy(vals))
    np.testing.assert_allclose(a_P.numpy(), s_P.numpy(), rtol=F32_STEPS,
                               atol=0)
    np.testing.assert_allclose(a_m.numpy(), s_m.numpy(), rtol=F32_STEPS,
                               atol=0)


# ---------------------------------------------------------------------------
# Per-probe weighted_subtree_ebp
# ---------------------------------------------------------------------------


def _same_wsebp(got, want, tol, score_rtol):
    """Equal k_subtree_valid, P_subtree_valid at ``score_rtol``, the map
    and each subtree map within ``tol`` of their max."""
    (s_t, maps_t, sc_t, k_t), (s_j, maps_j, sc_j, k_j) = got, want
    assert k_t == k_j and len(k_t) >= 1
    np.testing.assert_allclose(sc_t, sc_j, rtol=score_rtol)
    _close_to_max(s_t, s_j, tol)
    assert len(maps_t) == len(maps_j)
    for a, b in zip(maps_t, maps_j):
        _close_to_max(a, b, tol)


PATHS = {"fused": dict(return_subtree_maps=False),
         "host": dict(return_subtree_maps=True),
         "max_candidates": dict(max_candidates=8, return_subtree_maps=True)}


@pytest.mark.parametrize("gating,do_max", [(True, False), (False, True)])
@pytest.mark.parametrize("path", sorted(PATHS))
def test_weighted_subtree_ebp_matches_jax_float64(path, gating, do_max):
    """The three paths of the per-probe weighted_subtree_ebp on the toy
    net in float64, norelu, topk 3: equal k_subtree_valid,
    P_subtree_valid at rtol 1e-9, the map and P_img_valid within 1e-9 of
    their max.  The engine's subtree mode is restored afterwards."""
    jwb, twb, x = _pair64("affineonly")
    kw = dict(topk=3, subtree_mode="norelu", do_max_subtree=do_max,
              do_mated_similarity_gating=gating, **PATHS[path])
    want = jwb.weighted_subtree_ebp(jnp.asarray(x), 0, 1, **kw)
    got = twb.weighted_subtree_ebp(x, 0, 1, **kw)
    _same_wsebp(got, want, F32_STEPS, 1e-9)
    assert (len(got[1]) > 0) == kw["return_subtree_maps"]
    assert twb.ebp_subtree_mode() == "affineonly"


def test_max_candidates_all_equals_full_sweep():
    """max_candidates = n_events - 1 (the traced-injection walk over every
    candidate) gives the full sweep's selection and maps, float32
    (tests/test_wsebp_sweep.py:52-66 on the port: scores rtol 1e-6, maps
    rtol 1e-4 / atol 1e-8)."""
    jwb = make_toy_wbnet(num_classes=4, seed=3, subtree_mode="all")
    twb = torch_twin(jwb)
    rng = np.random.RandomState(7)
    probe = rng.rand(1, 3, 224, 224).astype(np.float32)
    em, en = (v / np.linalg.norm(v) for v in rng.rand(2, 12).astype(
        np.float32))
    twb.net.set_triplet_classifier(em, en)
    full = twb.weighted_subtree_ebp(probe, 0, 1, topk=3, subtree_mode="all")
    every = twb.weighted_subtree_ebp(probe, 0, 1, topk=3, subtree_mode="all",
                                     max_candidates=twb._n_events - 1)
    assert full[3] == every[3]
    np.testing.assert_allclose(every[2], full[2], rtol=1e-6)
    np.testing.assert_allclose(every[0], full[0], rtol=1e-4, atol=1e-8)
    for a, b in zip(every[1], full[1]):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-8)


def test_wsebp_buckets_match_jax():
    jwb = make_toy_wbnet(num_classes=4, seed=3)
    twb = torch_twin(jwb)
    for n in (1, 3, 6):
        assert twb._wsebp_buckets(n) == jwb._wsebp_buckets(n)


@pytest.mark.parametrize("gating", [True, False])
def test_batch_return_subtree_maps_matches_jax(gating):
    """weighted_subtree_ebp_batch(return_subtree_maps=True) against the
    JAX package (float32, as its batch path casts): equal selections,
    scores rtol 1e-5, maps and subtree maps rtol 1e-4 / atol 1e-6
    (test_batched_ebp.py's); each probe equals the per-probe path under
    its own 2-class classifier (test_wsebp_sweep.py:69-100's limits)."""
    jwb = make_toy_wbnet(num_classes=4, seed=5, subtree_mode="all")
    twb = torch_twin(jwb)
    rng = np.random.RandomState(11)
    B = 2
    probes = rng.rand(B, 3, 224, 224).astype(np.float32)
    ems, ens = (v / np.linalg.norm(v, axis=1, keepdims=True)
                for v in rng.rand(2, B, 12).astype(np.float32))
    kw = dict(topk=3, subtree_mode="all", do_mated_similarity_gating=gating,
              return_subtree_maps=True)
    for wb in (jwb, twb):
        wb.set_triplet_classifier_batch(ems, ens)
    want = jwb.weighted_subtree_ebp_batch(jnp.asarray(probes), **kw)
    got = twb.weighted_subtree_ebp_batch(probes, **kw)
    for (s_t, m_t, sc_t, k_t), (s_j, m_j, sc_j, k_j) in zip(got, want):
        assert k_t == k_j and len(m_t) == len(k_t)
        np.testing.assert_allclose(sc_t, sc_j, rtol=1e-5)
        np.testing.assert_allclose(s_t, s_j, rtol=1e-4, atol=1e-6)
        for a, b in zip(m_t, m_j):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)
    for i in range(B):
        twb.net.set_triplet_classifier(ems[i], ens[i])
        s_s, m_s, sc_s, k_s = twb.weighted_subtree_ebp(
            probes[i:i + 1], 0, 1, **kw)
        assert k_s == got[i][3]
        np.testing.assert_allclose(got[i][2], sc_s, rtol=1e-5)
        np.testing.assert_allclose(got[i][0], s_s, rtol=1e-4, atol=1e-7)
        for a, b in zip(got[i][1], m_s):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-7)


def test_weighted_subtree_ebp_reduced_resnet101_matches_jax():
    """The three per-probe paths on ResNet-101 at full widths with one
    block per stage (59 candidate events), float32, norelu, top-32
    (max_candidates 32): equal
    selections, scores at rtol 5e-5 and maps within 1e-4 of their max
    (test_torch_whitebox.py's limits for this net: its float32 walks
    reassociate sums)."""
    nc = 16
    graph, shapes, enc = JR.build_resnet101(num_classes=nc,
                                            layers=(1, 1, 1, 1))
    params = JC.init_params(shapes, seed=0)
    jwb = JWhitebox(JNet(graph, params, encode_tensor=enc,
                         classifier_pname="fc2", num_classes=nc),
                    ebp_version=6, ebp_subtree_mode="norelu")
    tgraph, _, tenc = TR.build_resnet101(num_classes=nc, layers=(1, 1, 1, 1))
    twb = Whitebox(WhiteboxNetwork(
        tgraph, params_from_jax(jax_params_np(params, np.float32),
                                device="cpu"),
        encode_tensor=tenc, classifier_pname="fc2", num_classes=nc),
        ebp_version=6, ebp_subtree_mode="norelu")
    rng = np.random.RandomState(0)
    probe = (rng.rand(1, 3, 224, 224) * 50).astype(np.float32)
    e = np.asarray(jwb.encode(jnp.asarray(rng.rand(2, 3, 224, 224) * 50,
                                          jnp.float32)))
    em, en = e[0] / np.linalg.norm(e[0]), e[1] / np.linalg.norm(e[1])
    for wb in (jwb, twb):
        wb.net.set_triplet_classifier(em, en)
    for kw in (dict(return_subtree_maps=False),
               dict(return_subtree_maps=True),
               dict(max_candidates=32, return_subtree_maps=False)):
        want = jwb.weighted_subtree_ebp(jnp.asarray(probe), 0, 1, topk=32,
                                        subtree_mode="norelu", **kw)
        got = twb.weighted_subtree_ebp(probe, 0, 1, topk=32,
                                       subtree_mode="norelu", **kw)
        # 24 of the 59 candidates are valid; 14 of the top 32
        assert got[0].shape == (112, 112) and len(got[3]) >= 14
        _same_wsebp(got, want, 1e-4, 5e-5)


# ---------------------------------------------------------------------------
# Generation on the mini dataset
# ---------------------------------------------------------------------------

SMAP_SUBDIR = "toynet/subject_ID_1/img/p1/inpainted"
MASKS = ("00002", "00005")


def _tree(root):
    """The files of a saliency tree, relative to its root."""
    return sorted(os.path.relpath(f, root) for f in glob.glob(
        os.path.join(root, "**", "*.*"), recursive=True))


@pytest.fixture(scope="module")
def gen(tmp_path_factory):
    """The mini dataset (masks 2 and 5), the JAX toy net and its port
    twin, and the maps of the JAX package's serial generator."""
    from xfr_tpu.inpainting_game import generate as JG

    root = tmp_path_factory.mktemp("gen")
    data_dir, jax_dir = str(root / "data"), str(root / "jax")
    os.makedirs(data_dir)
    make_mini_dataset(data_dir, net_name="toynet", mask_ids=(2, 5))
    jwb = make_toy_wbnet(subtree_mode="all")
    twb = torch_twin(jwb)  # before the JAX run installs a triplet head
    for mask_id in MASKS:
        JG.generate_wb_smaps(jwb, "toynet", "img/p1", 1, mask_id,
                             subtree_mode_weighted="all", ebp_ver=6,
                             overwrite=False, data_dir=data_dir,
                             smaps_dir=jax_dir)
    return dict(root=root, data_dir=data_dir, jax_dir=jax_dir, jwb=jwb,
                twb=twb)


def _same_tree_and_maps(gen, out):
    """The JAX generator's file names, letter for letter; every npz map
    within rtol 1e-3 / atol 1e-5 of the JAX package's
    (test_endtoend_game.py:236: the truncated percentile-mass boundary
    can flip a few pixels under float32 sum reassociation)."""
    names = _tree(out)
    assert names == _tree(gen["jax_dir"])
    npz = [n for n in names if n.endswith("-saliency.npz")]
    assert len(npz) == 8
    for n in npz:
        assert n.replace("-saliency.npz", "-saliency-overlay.png") in names
        a = np.load(os.path.join(out, n))["saliency_map"]
        b = np.load(os.path.join(gen["jax_dir"], n))["saliency_map"]
        assert a.shape == (224, 224) and np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-5, err_msg=n)


def test_generate_wb_smaps_serial_matches_jax(gen, tmp_path):
    """The serial generator (four methods, two masks) writes the JAX
    generator's files with its maps; a second run recomputes nothing (the
    files' mtimes are unchanged)."""
    from xfr_torch.inpainting_game import generate as G

    out = str(tmp_path / "serial")
    for mask_id in MASKS:
        G.generate_wb_smaps(gen["twb"], "toynet", "img/p1", 1, mask_id,
                            subtree_mode_weighted="all", ebp_ver=6,
                            overwrite=False, data_dir=gen["data_dir"],
                            smaps_dir=out)
    _same_tree_and_maps(gen, out)
    files = glob.glob(os.path.join(out, SMAP_SUBDIR, "*"))
    mtimes = {f: os.path.getmtime(f) for f in files}
    G.generate_wb_smaps(gen["twb"], "toynet", "img/p1", 1, "00002",
                        subtree_mode_weighted="all", ebp_ver=6,
                        overwrite=False, data_dir=gen["data_dir"],
                        smaps_dir=out)
    assert all(os.path.getmtime(f) == mtimes[f] for f in files)
    assert gen["twb"].net.num_classes() == 2  # the last method's head


@pytest.mark.parametrize("batch_size", [2, 3])
def test_generate_wb_smaps_batched_matches_jax(gen, tmp_path, batch_size):
    """The batched generator at batch 2 and at batch 3 (its one group
    padded with a duplicate of the first job) writes the JAX serial
    generator's files with its maps and counts 2 jobs; a second run
    without overwrite finds every map cached and drains nothing."""
    from xfr_torch.inpainting_game import generate as G

    out = str(tmp_path / "batched")
    jobs = [(1, m, "img/p1") for m in MASKS]
    kw = dict(subtree_mode_weighted="all", ebp_ver=6,
              data_dir=gen["data_dir"], smaps_dir=out, batch_size=batch_size)
    assert G.generate_wb_smaps_batched(gen["twb"], "toynet", jobs,
                                       overwrite=True, **kw) == 2
    _same_tree_and_maps(gen, out)
    assert G.generate_wb_smaps_batched(gen["twb"], "toynet", jobs,
                                       overwrite=False, **kw) == 0


def test_generate_wb_smaps_batched_failure_isolation(gen, tmp_path):
    """A bad job (no such image) does not stop the batched run: the good
    jobs' maps land on disk and the failure is raised at the end; a
    meanEBP-only run encodes no triplet (test_endtoend_game.py:240-270)."""
    from xfr_torch.inpainting_game import generate as G

    twb = gen["twb"]
    out = str(tmp_path / "fail")
    jobs = [(1, "00002", "img/NO_SUCH_IMAGE"), (1, "00002", "img/p1"),
            (1, "00005", "img/p1")]
    with pytest.raises(RuntimeError, match="NO_SUCH_IMAGE|failed"):
        G.generate_wb_smaps_batched(
            twb, "toynet", jobs, subtree_mode_weighted="all", ebp_ver=6,
            overwrite=True, data_dir=gen["data_dir"], smaps_dir=out,
            batch_size=2)
    assert len(glob.glob(os.path.join(out, SMAP_SUBDIR,
                                      "*-saliency.npz"))) == 8

    out2 = str(tmp_path / "mean")
    encodes = []
    real = G._avg_encodings
    G._avg_encodings = lambda *a: encodes.append(1) or real(*a)
    try:
        n = G.generate_wb_smaps_batched(
            twb, "toynet", jobs[1:], subtree_mode_weighted="all", ebp_ver=6,
            overwrite=True, method="meanEBP", data_dir=gen["data_dir"],
            smaps_dir=out2, batch_size=2)
    finally:
        G._avg_encodings = real
    assert n == 2 and not encodes
    maps = glob.glob(os.path.join(out2, SMAP_SUBDIR, "*-saliency.npz"))
    assert len(maps) == 2 and all("meanEBP" in m for m in maps)


def test_group_launch_fails_group_locally(gen):
    """run_wb_groups over in-memory jobs: a group whose launch raises is
    recorded under its jobs' labels, and the next group still drains."""
    from xfr_torch.inpainting_game import generate as G

    twb = gen["twb"]
    rng = np.random.RandomState(3)
    todo = dict.fromkeys(("meanEBP", "contrastive", "trunc",
                          "weighted-subtree"), False)
    todo["meanEBP"] = True
    pend = [dict(label=("job", i), todo=dict(todo)) for i in range(3)]
    images = [rng.rand(224, 224, 3) for _ in pend]

    def resolve(j):
        i = j["label"][1]
        if i == 0:
            j["x"] = torch.zeros((1, 3, 7, 7))  # wrong shape: launch fails
            return j
        return G.prepare_wb_job(twb, j, images[i])

    written, failures = [], []
    done = G.run_wb_groups(
        twb, pend, resolve, lambda j, k, m: written.append((j["label"], k)),
        batch_size=2, subtree_mode_weighted="all", ebp_ver=6,
        failures=failures)
    assert done == 1 and written == [(("job", 2), "meanEBP")]
    assert [f[0] for f in failures] == [("job", 0), ("job", 1)]


def _toy_bb_fn(wb):
    """Embedding-similarity scorer through the port's toy net (the host
    contract of tests/test_endtoend_game.py's _toy_bb_fn)."""
    from xfr_torch.utils.image import image_loader

    def embed(images):
        ims = [np.asarray(im, np.float64) for im in image_loader(
            list(images))]
        ims = [(a / 255.0 if a.max() > 1.5 else a).transpose(2, 0, 1)
               for a in ims]
        return wb.embeddings(np.stack(ims).astype(np.float32))

    def bb_fn(probes, gallery):
        pe, ge = embed(probes), embed(gallery)
        return 1.0 - 0.5 * np.linalg.norm(pe[:, None] - ge[None], axis=2)

    return bb_fn


def test_generate_bb_smaps_names_and_map(gen, tmp_path):
    """generate_bb_smaps (uniform prior, 200 masks, the toy host matcher,
    on the CPU) writes the JAX generator's file name, and its map is the
    port's own STRise.evaluate() for the same seed, written the same way
    (torch's generator cannot draw the JAX package's masks)."""
    from xfr_tpu.inpainting_game import generate as JG
    from xfr_torch.inpainting_game import generate as G
    from xfr_torch.show import create_save_smap

    twb, jwb = gen["twb"], gen["jwb"]
    out, jout, ref = (str(tmp_path / d) for d in ("bb", "jbb", "ref"))
    kw = dict(ebp_ver=6, overwrite=False, num_masks=200,
              prior_type="uniform", data_dir=gen["data_dir"])
    G.generate_bb_smaps(_toy_bb_fn(twb), twb.convert_from_numpy, "toynet",
                        "img/p1", 1, "00002", smaps_dir=out, device="cpu",
                        **kw)
    JG.generate_bb_smaps(
        lambda p, g: jax_toy_bb_fn(jwb, p, g), jwb.convert_from_numpy,
        "toynet", "img/p1", 1, "00002", smaps_dir=jout, **kw)
    assert _tree(out) == _tree(jout) == [
        SMAP_SUBDIR + "/00002-bbox-rise-2elem_blur=4_scale_12-saliency"
        + s for s in ("-overlay.png", ".npz")]

    _, probes, _, mates, nonmates = G._load_triplet(
        "toynet", 1, "00002", "img/p1", data_dir=gen["data_dir"])
    from xfr_torch.utils.image import image_loader
    probe_im = next(iter(image_loader(probes)))
    smap = G.create_bbox(_toy_bb_fn(twb), probe_im, mates, nonmates, 12, 2,
                         "blur", 4, device="cpu", num_masks=200,
                         prior_type="uniform")()
    os.makedirs(ref)
    create_save_smap("m", ref, True, lambda: smap, "00002", probe_im, None,
                     probe_im)
    np.testing.assert_array_equal(
        np.load(os.path.join(out, SMAP_SUBDIR, "00002-bbox-rise-2elem_"
                             "blur=4_scale_12-saliency.npz"))["saliency_map"],
        np.load(os.path.join(ref, "00002-m-saliency.npz"))["saliency_map"])


def test_bb_pipeline_records_failures_under_their_own_label(gen, tmp_path):
    """A failed pending writer is recorded under its own label when a later
    push drains it, and the later maps are still written; BBPipeline
    alone keeps at most one writer pending."""
    from xfr_torch.inpainting_game import generate as G

    ran = []
    pipe = G.BBPipeline()

    def bad():
        raise ValueError("writer broke")

    pipe.push(bad, label="bad")
    pipe.push(lambda: ran.append("a"), label="a")
    assert pipe.failures == [("bad", repr(ValueError("writer broke")))]
    assert ran == []
    twb = gen["twb"]
    out = str(tmp_path / "bb")
    for mask_id in MASKS:
        G.generate_bb_smaps(_toy_bb_fn(twb), twb.convert_from_numpy,
                            "toynet", "img/p1", 1, mask_id, ebp_ver=6,
                            overwrite=False, num_masks=64,
                            prior_type="uniform", data_dir=gen["data_dir"],
                            smaps_dir=out, device="cpu", pipeline=pipe)
    assert ran == ["a"]
    pipe.drain()
    assert len(pipe.failures) == 1
    assert len(glob.glob(os.path.join(out, SMAP_SUBDIR,
                                      "*bbox-rise*-saliency.npz"))) == 2


def test_generation_core_imports_without_io_packages():
    """The card's machine has no pandas, imageio, matplotlib or PIL: the
    generation module and the engine import without them."""
    import subprocess
    import sys

    code = (
        "import sys\n"
        "for m in ('pandas', 'imageio', 'matplotlib', 'PIL'):\n"
        "    sys.modules[m] = None\n"
        "import xfr_torch.ebp.engine\n"
        "import xfr_torch.inpainting_game.generate as G\n"
        "assert callable(G.run_wb_groups)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=120)

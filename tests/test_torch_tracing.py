"""The port's spans and counters (``xfr_torch/utils/profiling.py``) on the
CPU: off, each is one check that records nothing; on, while a
torch.profiler records, a STRise launch and finish and a two-map
TwinClsBatch put their steps in the trace, nested as the program nests
them, and count the blend+encode rows exactly; the results are the same
bits either way.  The matchers are the toy net (tests/fixtures
.make_toy_wbnet's port twin) at test_torch_strise's and
test_torch_inpainting's sizes.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from tests.fixtures import make_toy_wbnet
from tests.torch_fixtures import torch_twin

from xfr_torch.blackbox.strise import STRise
from xfr_torch.inpainting_game import protocol as P
from xfr_torch.utils import profiling

PCT = np.arange(0, 101)


@pytest.fixture(scope="module")
def wb():
    return torch_twin(make_toy_wbnet(num_classes=4, seed=0,
                                     subtree_mode="norelu"))


def _strise(wb):
    rng = np.random.RandomState(8)
    probe = rng.randint(0, 256, (224, 224, 3)).astype(np.uint8)
    probe[32:80, 32:80] = 220
    gal = rng.randint(0, 256, (224, 224, 3)).astype(np.uint8)
    return STRise(probe=probe, refs=[probe], gallery=[gal],
                  black_box="resnetv6_pytorch",
                  net_dict={("resnetv6_pytorch", 6): wb,
                            ("resnetv4_pytorch", None): wb},
                  prior_type="mean_ebp", num_masks=40, mask_scale=28,
                  num_mask_elements=2, mask_fill_type="blur", seed=5,
                  batch_size=16, device="cpu")


def _eval_group(wb):
    """Two maps through one TwinClsBatch, one through the single-map
    launch, and one IoU curve: (the batch's embeddings, each map's
    results, the IoU)."""
    rng = np.random.RandomState(2)
    orig = (rng.rand(3, 224, 224) * 50).astype(np.float32)
    inp = orig + (rng.rand(3, 224, 224) * 30).astype(np.float32)
    smaps = []
    for _ in range(2):
        s = rng.rand(224, 224)
        s[40:120, 60:160] += 4.0
        smaps.append(s / s.sum())
    og, ig = [e / np.linalg.norm(e, axis=1, keepdims=True) for e in
              (wb.embeddings(im[None]) for im in (orig, inp))]
    kw = dict(mask_threshold_method="percent-density", percentiles=PCT,
              seed=7, include_zero_elements=False)
    batch = P.TwinClsBatch(wb, orig, inp, og, ig, **kw)
    fins = [batch.launch(s) for s in smaps]
    batch.flush()
    res = [f() for f in fins]
    res.append(P.launch_classified_as_inpainted_twin(
        wb, orig, inp, og, ig, smaps[0], **kw)())
    gt = np.zeros((224, 224), bool)
    gt[40:120, 60:160] = True
    iou = P.intersect_over_union_thresholded_saliency(smaps[0], gt, **kw)
    return batch._result, res, iou


def _strise_run(wb):
    st = _strise(wb)
    smap = st.launch_evaluate()()
    return smap, st.mask_scores


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _spans(events):
    """{name: [the names of the xfr spans enclosing each call]}."""
    out = {}
    for e in events:
        if not e.name.startswith("xfr."):
            continue
        up, p = [], e.cpu_parent
        while p is not None:
            if p.name.startswith("xfr."):
                up.append(p.name)
            p = p.cpu_parent
        out.setdefault(e.name, []).append(up)
    return out


def test_off_span_is_the_shared_null_and_records_nothing(wb, monkeypatch):
    def refuse(name, *a, **k):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert profiling.span("xfr.any") is profiling.span("xfr.other") \
        is profiling._NULL
    counters, seconds = profiling.counters(), profiling.span_seconds()
    profiling.count("xfr.eval.steps", 5)
    _strise_run(wb)
    _eval_group(wb)
    assert profiling.counters() == counters
    assert profiling.span_seconds() == seconds


def test_live_exactly_while_a_profiler_records():
    prof = profile(activities=[ProfilerActivity.CPU])
    assert profiling.span("xfr.t") is profiling._NULL
    prof.start()
    try:
        before = profiling.counters().get("xfr.t", 0)
        live = profiling.span("xfr.t")
        assert live is not profiling._NULL
        with live:
            profiling.count("xfr.t", 3)
        assert profiling.counters()["xfr.t"] == before + 3
    finally:
        prof.stop()
    assert profiling.span("xfr.t") is profiling._NULL
    profiling.count("xfr.t", 3)
    assert profiling.counters()["xfr.t"] == before + 3
    assert [e.name for e in prof.events()].count("xfr.t") == 1


def test_strise_launch_spans_nest_as_the_program(wb):
    seconds = profiling.span_seconds()
    _, events = _profiled(lambda: _strise_run(wb))
    spans = _spans(events)
    for name in ("xfr.bb.prior", "xfr.bb.masks", "xfr.bb.score"):
        assert spans[name] == [["xfr.bb.launch"]], (name, spans)
    assert spans["xfr.bb.launch"] == [[]]
    assert spans["xfr.bb.finish"] == [[]]
    after = profiling.span_seconds()
    for name in spans:
        assert after[name] > seconds.get(name, 0.0), name


def test_eval_spans_nest_and_rows_are_counted(wb):
    before = profiling.counters()
    _, events = _profiled(lambda: _eval_group(wb))
    spans = _spans(events)
    got = {k: v - before.get(k, 0) for k, v in profiling.counters().items()
           if v != before.get(k, 0)}
    # T = 101 rows a map in steps of 32: 4 steps, 128 rows, 27 of them pad
    assert wb.blend_batch == 32
    maps = 3  # the batch's two, then the single-map launch
    # every encode counts its BatchNorm rows (the toy net has one), all
    # in a fused epilogue: the steps' rows and the two embeddings' padded
    # batches
    bn = wb.net.graph.n_bn * (128 * maps + 2 * wb.batch_size)
    assert (wb.net.graph.n_bn, wb.batch_size) == (1, 32)
    assert got == {"xfr.eval.steps": 4 * maps,
                   "xfr.eval.rows_encoded": 128 * maps,
                   "xfr.eval.rows_needed": 101 * maps,
                   "xfr.enc.bn_rows": bn, "xfr.enc.bn_rows_fused": bn}
    assert spans["xfr.eval.plane"] == [[]] * 3
    assert spans["xfr.eval.encode"] == [[]] * 2
    assert spans["xfr.eval.blend"] == [["xfr.eval.encode"]] * 4 * maps
    assert spans["xfr.eval.finish"] == [[]] * 2
    assert spans["xfr.eval.iou"] == [[]]


def test_results_are_the_same_bits_traced(wb):
    plain = _strise_run(wb), _eval_group(wb)
    traced, _ = _profiled(lambda: (_strise_run(wb), _eval_group(wb)))
    (smap, scores), (emb, res, iou) = plain
    (smap_t, scores_t), (emb_t, res_t, iou_t) = traced
    np.testing.assert_array_equal(smap_t, smap)
    np.testing.assert_array_equal(scores_t, scores)
    np.testing.assert_array_equal(emb_t, emb)
    np.testing.assert_array_equal(iou_t, iou)
    for got, want in zip(res_t, res):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)

"""Benchmark: the three stages of the inpainting-game pipeline on one CUDA
card with the PyTorch port (``xfr_torch``), each against the reference's
published wall-clock for the same workload on 1x Titan X.  A port of
bench.py function by function, on the same inputs: ``RandomState(0)``
and the same draws in the same order.  The baselines and their
derivations are bench.py's (its docstring).

    python3 bench_torch.py

Prints one JSON line per metric, each with the card's ``name`` and
``power_limit`` as nvidia-smi gives them.  The whitebox line is printed
first, right after it is measured, and again last.  Every net runs at
random weights from the numpy init (no checkpoint is committed).

Besides bench.py's checks (finite maps, 101 classifications a map), a
card run is repeatable, so the outputs are held exactly; a failed check
raises and the script exits non-zero:

* every timed whitebox mix's 32 maps equal the warm-up mix's bit for bit
  (the same probes each time);
* eval group p equals group p-2 (the pairs alternate on p % 2), and
  group 0 the warm-up group;
* each STRise function reruns seed 0 after its timed maps and holds the
  map to the warm-up map.

Each rate is timed with the host clock, ended by the drain's copy to the
host, as bench.py times it.  The functions run on the net's device: the
tests hand them CPU nets.
"""

import json
import time

import numpy as np
import torch

BASELINE_WB_MAPS_PER_SEC = 0.04     # Titan X, standard 4-map mix
BASELINE_BB_MAPS_PER_SEC = 0.0201   # Titan X, 6500-mask STRise map
BASELINE_EVAL_PER_SEC = 0.72        # Titan X-era, twin-cls + IoU sweep

WB_METRIC = ("whitebox EBP saliency maps/sec/chip (4-map eval mix, "
             "ResNet-101+L2)")
BB_METRIC = ("blackbox STRise saliency maps/sec/chip (6500 masks, mean-EBP "
             "prior, blur fill, ResNet-101+L2 fused scorer)")
BB_HIGH_METRIC = ("blackbox STRise saliency maps/sec/chip (6500 masks, "
                  "score_precision=high — the xfr-generate-bb CLI default)")
EVAL_METRIC = ("inpainting-game eval probe-method evals/sec/chip "
               "(percent-density sweep: 101 blend embeddings + twin-cls + "
               "IoU)")


def _emit(metric, times, unit, baseline, card, per=1):
    """One JSON metric line (bench.py's), plus the card's fields
    (``utils.device.card_name_and_power_limit``).  Per-iteration wall
    seconds ``times``, each covering ``per`` units; ``value`` is the MEDIAN of the per-iteration
    rates, so one stalled iteration does not move it, beside the mean
    rate and the min/max/raw times.  Returns the record."""
    rec = {"metric": metric, "unit": unit}
    t = np.asarray(times, np.float64)
    value = per / float(np.median(t))
    rec["mean"] = round(per * len(t) / float(t.sum()), 4)
    rec["min"] = round(per / float(t.max()), 4)
    rec["max"] = round(per / float(t.min()), 4)
    rec["iter_times_s"] = [round(float(x), 4) for x in t]
    rec["value"] = round(value, 4)
    rec["vs_baseline"] = round(value / baseline, 2)
    rec.update(card)
    print(json.dumps(rec), flush=True)
    return rec


def _same_bits(a, b):
    if isinstance(a, dict) or isinstance(b, dict):
        return (isinstance(a, dict) and isinstance(b, dict)
                and a.keys() == b.keys()
                and all(_same_bits(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)) or isinstance(b, (list, tuple)):
        return (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
                and len(a) == len(b)
                and all(_same_bits(x, y) for x, y in zip(a, b)))
    a, b = np.asarray(a), np.asarray(b)
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.tobytes() == b.tobytes())


def check_same(what, got, want):
    """Raise AssertionError unless ``got`` equals ``want`` bit for bit
    (arrays, or nested dicts, lists and tuples of them)."""
    if not _same_bits(got, want):
        raise AssertionError(f"{what}: not the same bits as before on the "
                             "same inputs")


def bench_blackbox(wb, rng, n_maps=5, num_masks=6500, mesh=None,
                   score_precision=None):
    """Sustained STRise map rate with the production launch/finish
    pipeline: map k+1 is launched before map k is drained.  On the card
    the launch enqueues until CUDA's launch queue is full and then blocks
    until the card takes more work, so it returns only near the end of
    its map's device work: map k's host post does not overlap map k+1's
    device work, the first interval holds two maps' work and the last
    almost none.
    ``mesh``: a DeviceMesh with a 'dp' dim for the scorer's mesh path.
    ``score_precision``: None = the constructor's default (TF32 allowed
    in the scoring encode); "high" = the generate_bb_saliency CLI's
    default (full float32).  The fused-blend kernel stays off, as in
    bench.py.  Seed 0 runs again after the timed maps and must give the
    warm-up map bit for bit."""
    from xfr_torch.blackbox import STRise

    # distinct probe per map (like production generation: refs/gallery
    # repeat across a job's probes, and hit the embed memo, but each
    # probe is new)
    probes = [(rng.rand(224, 224, 3) * 255).astype(np.uint8)
              for _ in range(n_maps + 2)]
    refs = [(rng.rand(224, 224, 3) * 255).astype(np.uint8)
            for _ in range(2)]
    gals = [(rng.rand(224, 224, 3) * 255).astype(np.uint8)
            for _ in range(2)]
    # one net serves matcher + mean-EBP prior (the CLI's net_dict reuse)
    net_dict = {("resnetv6_pytorch", 6): wb,
                ("resnetv4_pytorch", None): wb}

    def launch(seed):
        st = STRise(probe=probes[seed % len(probes)], refs=refs,
                    gallery=gals,
                    black_box="resnetv6_pytorch", net_dict=net_dict,
                    mask_scale=12, num_mask_elements=2,
                    mask_fill_type="blur", blur_fill_sigma_percent=4,
                    num_masks=num_masks, seed=seed,
                    prior_type="mean_ebp", mesh=mesh,
                    score_precision=score_precision, device=wb.device)
        return st.launch_evaluate()

    warm = launch(0)()  # warm-up: fills the refs' and gallery's memo
    assert np.isfinite(warm).all()

    times, maps = [], []
    t0 = time.time()
    pend = launch(1)
    for s in range(2, n_maps + 1):
        fin = launch(s)
        maps.append(pend())  # the drain's copy to the host ends the map
        t1 = time.time()
        times.append(t1 - t0)
        t0 = t1
        pend = fin
    maps.append(pend())
    times.append(time.time() - t0)
    for smap in maps:
        assert np.isfinite(smap).all()
    check_same("STRise seed 0 after the timed maps", launch(0)(), warm)
    return times


PERCENTILES = np.unique(np.sort(np.append(np.arange(0, 100, 1), [0, 100])))


def eval_workload(wb, rng, percentiles=PERCENTILES, chw=(3, 224, 224)):
    """bench.py's eval inputs, drawn from ``rng`` in its order: 2
    probe/twin pairs (probe 0..50, twin = probe + 0..30), galleries of 2
    noisy copies each (unit-normed mean embeddings from ``wb``), 4
    saliency maps with the salient box [60:120, 80:150] and the same
    ground-truth box; percent-density, seed 7, zero elements excluded.
    ``chw`` is the net's input shape; the box scales with it."""
    C, H, W = chw
    pairs = []
    for _ in range(2):
        orig = (rng.rand(C, H, W) * 50).astype(np.float32)
        inp = orig + (rng.rand(C, H, W) * 30).astype(np.float32)
        pairs.append((orig, inp))

    def embed(ims):
        e = np.asarray(wb.embeddings(np.stack(ims)))
        e = e / np.linalg.norm(e, axis=1, keepdims=True)
        m = e.mean(axis=0, keepdims=True)
        return m / np.linalg.norm(m, axis=1, keepdims=True)

    gals = [(embed([o + rng.rand(C, H, W).astype(np.float32)
                    for _ in range(2)]),
             embed([i + rng.rand(C, H, W).astype(np.float32)
                    for _ in range(2)]))
            for o, i in pairs]
    box = (slice(60 * H // 224, 120 * H // 224),
           slice(80 * W // 224, 150 * W // 224))
    smaps = []
    for _ in range(4):
        smap = rng.rand(H, W)
        smap[box] += 4.0  # salient region
        smaps.append(smap / smap.sum())
    gt = np.zeros((H, W), bool)
    gt[box] = True
    return {"pairs": pairs, "gals": gals, "smaps": smaps, "gt": gt,
            "kw": dict(mask_threshold_method="percent-density",
                       percentiles=percentiles, seed=7,
                       include_zero_elements=False)}


def launch_eval_group(wb, w, p):
    """One probe group as bench.py's launch_group: the 4 maps of pair
    p % 2 into one TwinClsBatch, each map's host IoU curve computed after
    its launch, then the flush that enqueues the one multi-map program.
    Returns (finishes, IoU curves, host IoU seconds)."""
    from xfr_torch.inpainting_game import protocol as ipg

    orig, inp = w["pairs"][p % 2]
    og, ig = w["gals"][p % 2]
    kw = w["kw"]
    batch = ipg.TwinClsBatch(wb, orig, inp, og, ig, **kw)
    fins, ious, iou_s = [], [], 0.0
    for smap in w["smaps"]:
        fins.append(batch.launch(smap))
        t0 = time.time()
        ious.append(ipg.intersect_over_union_thresholded_saliency(
            smap, w["gt"], kw["mask_threshold_method"],
            percentiles=kw["percentiles"], seed=kw["seed"],
            include_zero_elements=kw["include_zero_elements"]))
        iou_s += time.time() - t0
    batch.flush()
    return fins, ious, iou_s


def drain_eval_group(launched):
    """Finish a group and check it: every classification vector has one
    entry a threshold and a false first entry; distances and IoU curves
    finite.  Returns each map's (classified as twin, pg, pr)."""
    fins, ious, _ = launched
    out = [f() for f in fins]
    T = len(ious[0])
    for (cls, pg, pr), iou in zip(out, ious):
        assert len(cls) == T and not cls[0], (len(cls), cls[:3])
        assert np.isfinite(pg).all() and np.isfinite(pr).all()
        assert np.isfinite(iou).all() and len(iou) == T
    return out


def bench_eval(wb, rng, n_groups=10):
    """Sustained probe-method eval rate: percent-density threshold sweep
    (101 blends + twin classification) + IoU curve, the analysis stage's
    per-unit work AND overlap: all 4 method maps of a probe group into
    ONE multi-map blend+encode program (TwinClsBatch), the host IoU
    curves computed while it runs, and one probe group in flight
    (analysis.run_inpaintinggame_analysis).  Group p must equal group
    p-2, and group 0 the warm-up group, bit for bit."""
    w = eval_workload(wb, rng)
    warm = drain_eval_group(launch_eval_group(wb, w, 0))  # warm-up
    assert all(len(c[0]) == len(PERCENTILES) for c in warm)
    wb._upload_memo.clear()  # first timed group re-pays its upload

    # one probe group in flight, like run_inpaintinggame_analysis:
    # group p+1 launches (and computes its host IoU curves) before
    # group p drains
    times, groups = [], []
    t0 = time.time()
    pend = launch_eval_group(wb, w, 0)
    for p in range(1, n_groups):
        nxt = launch_eval_group(wb, w, p)
        groups.append(drain_eval_group(pend))
        t1 = time.time()
        times.append(t1 - t0)
        t0 = t1
        pend = nxt
    groups.append(drain_eval_group(pend))
    times.append(time.time() - t0)
    check_same("eval group 0 against the warm-up group", groups[0], warm)
    for p in range(2, n_groups):
        check_same(f"eval group {p} against group {p - 2}", groups[p],
                   groups[p - 2])
    return times


def whitebox_workload(wb, rng, B=8):
    """bench.py's whitebox inputs, drawn from ``rng`` in its order, as
    float32 on the net's device: two mate and two nonmate images (0..50)
    whose mean encodings, unit-normed, make the triplet classifiers, and
    B probes."""
    def imgs(n):
        return torch.as_tensor(rng.rand(n, 3, 224, 224) * 50,
                               dtype=torch.float32, device=wb.device)

    mates, nonmates = imgs(2), imgs(2)
    em, en = (e / torch.linalg.norm(e) for e in (
        wb.encode(mates).mean(0), wb.encode(nonmates).mean(0)))
    return {"probes": imgs(B), "em": em, "en": en}


def launch_mix(wb, w, mode="norelu"):
    """Enqueue the 4-map mix, launch-all-then-drain as the batched
    generator does: every method's device work before any host read.  The
    classifier swaps between launches are safe: each launch captures the
    params it was given.  ``mode`` is the weighted subtree's (norelu for
    the ResNets, affineonly_with_prior for LightCNN)."""
    probes, em, en = w["probes"], w["em"], w["en"]
    B = probes.shape[0]
    wb.net.reset_classifier()
    Pn_mean = torch.ones((B, wb.net.num_classes()), dtype=torch.float32,
                         device=probes.device)
    pooled, _ = wb._ebp_pooled_fn()(wb.net.params, probes, Pn_mean)
    wb.set_triplet_classifier_batch((em / 2500.0).expand(B, -1),
                                    (en / 2500.0).expand(B, -1))
    finish_ct = wb.launch_contrastive_ebp_batch_both(
        probes, truncate_percent=20)
    wb.set_triplet_classifier_batch(em.expand(B, -1), en.expand(B, -1))
    finish_ws = wb.launch_weighted_subtree_ebp_batch(
        probes, topk=32, subtree_mode=mode)
    return pooled, finish_ct, finish_ws


def drain_mix(wb, launched):
    """The host side of one mix: {method: [B maps]} and each probe's
    selected subtrees."""
    pooled, finish_ct, finish_ws = launched
    pooled = pooled.cpu().numpy()
    contr, trunc = finish_ct()
    ws = finish_ws()
    return {"mean_ebp": [wb._mwp_to_saliency(p) for p in pooled],
            "contrastive": contr, "truncated_contrastive": trunc,
            "weighted_subtree": [r[0] for r in ws],
            "subtrees": [r[3] for r in ws]}


def bench_whitebox(wb, rng, n_iters=6):
    """The inpainting-game standard per-probe 4-map method mix on the
    flagship STR-Janus ResNet-101+L2 matcher, probe-batched B=8 via the
    production launch-all-then-drain pipeline.  Every timed mix's maps
    and subtrees must equal the warm-up mix's bit for bit."""
    w = whitebox_workload(wb, rng)
    warm = drain_mix(wb, launch_mix(wb, w))  # warm-up
    # Double-buffered groups exactly like the generation pipeline: group
    # i+1 is launched before group i's host drain (transfers + saliency
    # post).
    times, outs = [], []
    t0 = time.time()
    prev = launch_mix(wb, w)
    for _ in range(n_iters - 1):
        st = launch_mix(wb, w)
        outs.append(drain_mix(wb, prev))
        t1 = time.time()
        times.append(t1 - t0)
        t0 = t1
        prev = st
    outs.append(drain_mix(wb, prev))
    times.append(time.time() - t0)
    assert sum(len(v) for k, v in warm.items() if k != "subtrees") == 32
    for i, out in enumerate(outs):
        for k, maps in out.items():
            if k != "subtrees":
                assert all(np.isfinite(s).all() for s in maps), k
        check_same(f"whitebox mix {i} against the warm-up mix", out, warm)
    return times


def run(wb, card, wb_iters=6, bb_maps=5, bb_high_maps=3, eval_groups=10,
        num_masks=6500):
    """bench.py's five lines in its order on ``wb`` from
    ``RandomState(0)``: the whitebox mix, STRise at score_precision None
    and at "high", the eval, and the whitebox line again.  ``card`` is
    ``utils.device.card_name_and_power_limit()``'s dict.  Returns the
    five records."""
    rng = np.random.RandomState(0)
    wbt = bench_whitebox(wb, rng, n_iters=wb_iters)
    recs = [_emit(WB_METRIC, wbt, "maps/sec/chip", BASELINE_WB_MAPS_PER_SEC,
                  card, per=32)]
    # restore the full classifier: the STRise prior's Pn shape depends on
    # net.num_classes()
    wb.net.reset_classifier()

    bbt = bench_blackbox(wb, rng, n_maps=bb_maps, num_masks=num_masks)
    recs.append(_emit(BB_METRIC, bbt, "maps/sec/chip",
                      BASELINE_BB_MAPS_PER_SEC, card, per=1))

    # the generate_bb_saliency CLI defaults score_precision="high":
    # record the production generation rate too, not just the fast one
    bbht = bench_blackbox(wb, rng, n_maps=bb_high_maps, num_masks=num_masks,
                          score_precision="high")
    recs.append(_emit(BB_HIGH_METRIC, bbht, "maps/sec/chip",
                      BASELINE_BB_MAPS_PER_SEC, card, per=1))

    evt = bench_eval(wb, rng, n_groups=eval_groups)
    recs.append(_emit(EVAL_METRIC, evt, "evals/sec/chip",
                      BASELINE_EVAL_PER_SEC, card, per=4))

    recs.append(_emit(WB_METRIC, wbt, "maps/sec/chip",
                      BASELINE_WB_MAPS_PER_SEC, card, per=32))
    return recs


def main():
    from xfr_torch.models import create_wbnet
    from xfr_torch.utils.device import card_name_and_power_limit

    wb = create_wbnet("resnetv6_pytorch")  # on the card; raises without one
    # production default: weighted-subtree sweep in bfloat16
    # (generate_wb_saliency --wsebp-dtype bfloat16), everything else
    # float32
    wb.wsebp_dtype = torch.bfloat16
    run(wb, card_name_and_power_limit())


if __name__ == "__main__":
    main()

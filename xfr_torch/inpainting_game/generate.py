"""Inpainting-game saliency-map generation (port of
xfr_tpu/inpainting_game/generate.py; reference:
python/xfr/inpainting_game/generate_whitebox_saliency.py and
generate_blackbox_saliency.py).

Per (net, subject, image, mask_id): load the filtered triplet table, build
mate/nonmate averaged encodings, set the 2-class triplet classifier, and
write one saliency overlay png + npz per method under the reference's
exact method-slug filename conventions (parsed back at analysis time).

The whitebox slugs end in a device tag, "cpu" unless a ``device`` is
passed, as in the JAX package, whose CLIs never pass one: a tree written
by the port reads the same as one written by the JAX package.  ``device``
names nothing else for the whitebox generators (the engine runs where its
net lives); the blackbox generators run STRise on it (None: the card).

The batched whitebox generator's group launch and drain are module-level
functions over in-memory jobs and a ``write(job, slug_key, smap)``
callback (``prepare_wb_job``, ``launch_wb_group``, ``drain_wb_group``,
``run_wb_groups``), so they run without pandas or imageio; the file
generators read the CSV and the images and write the files around them.

Under a device mesh (a whitebox net with ``use_mesh``, or ``mesh=`` for
the blackbox generators, which passes it to STRise) every rank of the
``torch.distributed`` group runs the same jobs and joins each method's
gathers; only the first rank writes the files.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

import xfr_torch
from xfr_torch.parallel.distributed import writes
from xfr_torch.show import create_save_smap, smap_cached
from xfr_torch.utils.image import image_loader

ORIG_PATTERN = ("aligned/{SUBJECT_ID}/{ORIGINAL_BASENAME}/inpainted/"
                "{MASK_ID:05d}_truth.png")
INPAINTED_PATTERN = ("aligned/{SUBJECT_ID}/{ORIGINAL_BASENAME}/inpainted/"
                     "{MASK_ID:05d}_out_0.png")
MASK_PATTERN = "aligned/{SUBJECT_ID}/{ORIGINAL_BASENAME}/masks/{MASK_ID:05d}.png"

# the weighted-subtree method's top-k and the truncated-contrastive
# percentile of every generator
WSEBP_TOPK = 32
TRUNCATE_PERCENT = 20


def shorten_subtree_mode(ebp_subtree_mode):
    if ebp_subtree_mode == "affineonly_with_prior":
        return "awp"
    return ebp_subtree_mode


def wb_slugs(wb, subtree_mode_weighted, ebp_ver, dev_tag):
    """The whitebox methods' file slugs: {"meanEBP", "contrastive",
    "trunc", "weighted-subtree"} -> slug."""
    mode = shorten_subtree_mode(wb.ebp_subtree_mode())
    return {
        "meanEBP": "meanEBP_mode=%s_v%02d_%s" % (mode, ebp_ver, dev_tag),
        "contrastive": "contrastive_triplet_ebp_mode=%s_v%02d_%s"
                       % (mode, ebp_ver, dev_tag),
        "trunc": "trunc_contrastive_triplet_ebp_mode=%s_v%02d_pct%d_%s"
                 % (mode, ebp_ver, TRUNCATE_PERCENT, dev_tag),
        "weighted-subtree":
            "weighted_subtree_triplet_ebp_mode=%s,%s_v%02d_top%d_%s"
            % (mode, shorten_subtree_mode(subtree_mode_weighted), ebp_ver,
               WSEBP_TOPK, dev_tag),
    }


def _avg_encodings(wb, im_mates, im_nonmates):
    """Average + L2-normalize mate/nonmate encodings
    (reference: generate_whitebox_saliency.py:85-98), through
    ``embeddings`` (padded to wb.batch_size).  Returns float32 numpy."""
    x = torch.cat([wb.convert_from_numpy(im)
                   for im in list(im_mates) + list(im_nonmates)])
    e = wb.embeddings(x, norm=False)
    e = e.reshape(e.shape[0], -1)
    em = e[:len(im_mates)].mean(axis=0)
    en = e[len(im_mates):].mean(axis=0)
    return em / np.linalg.norm(em), en / np.linalg.norm(en)


def mean_ebp(wb, probe_im, net_name=None, ebp_version=None, device=None):
    """Mean EBP over all classes (uniform output prior)
    (reference: generate_whitebox_saliency.py:207-214).

    The reference builds a fresh net per job, so meanEBP always runs over
    the ORIGINAL full classifier; restore it in case a previous method on
    this shared engine installed a 2-class triplet head."""
    wb.net.reset_classifier()
    x_probe = wb.convert_from_numpy(probe_im)
    P = torch.ones((1, wb.net.num_classes()), dtype=torch.float32,
                   device=wb.device)
    return wb.ebp(x_probe, P)


def run_contrastive_triplet_ebp(wb, im_mates, im_nonmates, probe_im,
                                truncate_percent, net_name=None,
                                ebp_version=None, device=None):
    """(Truncated-)contrastive triplet EBP
    (reference: generate_whitebox_saliency.py:79-115)."""
    avg_x_mate, avg_x_nonmate = _avg_encodings(wb, im_mates, im_nonmates)
    img_probe = wb.convert_from_numpy(probe_im)
    wb.net.set_triplet_classifier((1.0 / 2500.0) * avg_x_mate,
                                  (1.0 / 2500.0) * avg_x_nonmate)
    if truncate_percent is None:
        return wb.contrastive_ebp(img_probe, k_poschannel=0, k_negchannel=1)
    return wb.truncated_contrastive_ebp(
        img_probe, k_poschannel=0, k_negchannel=1,
        percentile=truncate_percent)


# ebp_version -> weighted-subtree flags
# (reference: generate_whitebox_saliency.py:148-195, whitebox.py:267-271)
_WSEBP_FLAGS = {
    7: dict(do_max_subtree=True, do_mated_similarity_gating=True),
    8: dict(do_max_subtree=False, do_mated_similarity_gating=True),
    9: dict(do_max_subtree=True, do_mated_similarity_gating=False),
    10: dict(do_max_subtree=True, do_mated_similarity_gating=True),
    11: dict(do_max_subtree=True, do_mated_similarity_gating=True),
    12: dict(do_max_subtree=False, do_mated_similarity_gating=True),
}


def _wsebp_flags(ebp_ver):
    return _WSEBP_FLAGS.get(ebp_ver, dict(do_max_subtree=False,
                                          do_mated_similarity_gating=False))


def run_weighted_subtree_triplet_ebp(wb, im_mates, im_nonmates, probe_im,
                                     subtree_mode_weighted, topk=1,
                                     net_name=None, ebp_version=None,
                                     device=None, max_candidates=None):
    """Weighted-subtree triplet EBP
    (reference: generate_whitebox_saliency.py:119-205)."""
    avg_x_mate, avg_x_nonmate = _avg_encodings(wb, im_mates, im_nonmates)
    img_probe = wb.convert_from_numpy(probe_im)
    wb.net.set_triplet_classifier(avg_x_mate, avg_x_nonmate)
    img_subtree, _, _, _ = wb.weighted_subtree_ebp(
        img_probe, k_poschannel=0, k_negchannel=1, topk=topk,
        subtree_mode=subtree_mode_weighted, verbose=False,
        max_candidates=max_candidates, return_subtree_maps=False,
        **_wsebp_flags(ebp_version))
    return img_subtree


def _load_triplet(net_name, subj_id, mask_id, img_base, data_dir=None):
    """Read the filtered-masks CSV and resolve file lists
    (reference: generate_whitebox_saliency.py:244-286)."""
    import pandas as pd

    data_dir = data_dir or xfr_torch.inpaintgame2_dir
    orig_image_pattern = os.path.join(data_dir, ORIG_PATTERN)
    inpainted_image_pattern = os.path.join(data_dir, INPAINTED_PATTERN)
    mask_pattern = os.path.join(data_dir, MASK_PATTERN)

    data = pd.read_csv(os.path.join(
        data_dir,
        "filtered_masks_threshold-{NET}.csv".format(NET=net_name)))
    data = data.loc[(data["MASK_ID"] == int(mask_id)) &
                    (data["SUBJECT_ID"] == int(subj_id))]

    probe_rows, probes, mates, nonmates = [], [], [], []
    probe_masks = []
    for _, row in data.iterrows():
        d = row.to_dict()
        f = orig_image_pattern.format(**d)
        fm = mask_pattern.format(**d)
        finp = inpainted_image_pattern.format(**d)
        if os.path.exists(f):
            if d["TRIPLET_SET"] == "REF":
                mates.append(f)
            elif d["ORIGINAL_BASENAME"] == img_base:
                probe_rows.append(row)
                probes.append(f)
                probe_masks.append(fm)
        else:
            print("Original file %s does not exist!" % f)
        if d["TRIPLET_SET"] == "REF":
            assert os.path.exists(finp)
            nonmates.append(finp)

    assert len(probes) == 1
    return pd.DataFrame(probe_rows), probes, probe_masks, mates, nonmates


def generate_wb_smaps(wb, net_name, img_base, subj_id, mask_id,
                      subtree_mode_weighted, ebp_ver, overwrite,
                      device=None, method=None, wsebp_max_candidates=None,
                      data_dir=None, smaps_dir=None):
    """Generate all whitebox method maps for one (net, subject, image, mask)
    (reference: generate_whitebox_saliency.py:222-417), one method after
    the other."""
    subject_id = subj_id
    data_dir = data_dir or xfr_torch.inpaintgame2_dir
    smaps_dir = smaps_dir or xfr_torch.inpaintgame_saliencymaps_dir
    cropped_data_dir = os.path.join(data_dir,
                                    "aligned/{}".format(subject_id))
    multiprobe_data_dir = os.path.join(
        smaps_dir,
        "{}/subject_ID_{}".format(net_name, subject_id))

    probe_data, probes, probe_masks, mates, nonmates = _load_triplet(
        net_name, subject_id, mask_id, img_base, data_dir=data_dir)
    im_mates = list(image_loader(mates))
    im_nonmates = list(image_loader(nonmates))

    slugs = wb_slugs(wb, subtree_mode_weighted, ebp_ver,
                     "cpu" if device is None else str(device))

    for (probe_im, probe_fn), probe_mask_fn, (_, probe_row) in zip(
            image_loader(probes, returnFileName=True), probe_masks,
            probe_data.iterrows()):
        extra_dirs = os.path.split(
            os.path.relpath(probe_fn, cropped_data_dir))[0]
        output_dir = os.path.join(multiprobe_data_dir, extra_dirs)
        os.makedirs(output_dir, exist_ok=True)
        mask_im = next(iter(image_loader([probe_mask_fn])))

        def save(slug_key, smap_fn):
            create_save_smap(
                slugs[slug_key], output_dir, overwrite, smap_fn=smap_fn,
                probe_im=probe_im, probe_info=probe_row, mask_im=mask_im,
                mask_id=mask_id, write=writes(wb.mesh))

        result_calculated = False
        if method is None or method == "meanEBP":
            result_calculated = True
            save("meanEBP", lambda: mean_ebp(wb, probe_im,
                                             ebp_version=ebp_ver))

        if method is None or method == "contrastive":
            result_calculated = True
            for key, truncate_percent in (("contrastive", None),
                                          ("trunc", TRUNCATE_PERCENT)):
                save(key, lambda tp=truncate_percent:
                     run_contrastive_triplet_ebp(
                         wb, im_mates, im_nonmates, probe_im,
                         truncate_percent=tp, ebp_version=ebp_ver))

        if method is None or method == "weighted-subtree":
            result_calculated = True
            save("weighted-subtree", lambda: run_weighted_subtree_triplet_ebp(
                wb, im_mates, im_nonmates, probe_im,
                subtree_mode_weighted=subtree_mode_weighted,
                topk=WSEBP_TOPK, ebp_version=ebp_ver,
                max_candidates=wsebp_max_candidates))

        if not result_calculated:
            raise RuntimeError(
                "Unknown method type %s (valid types: 'meanEBP', "
                "'contrastive', 'weighted-subtree')" % method)


def create_bbox(blackbox_fn, probe_im, mates, nonmates, rise_scale,
                num_mask_elements, mask_fill_type, blur_sigma_percent,
                device=None, num_masks=6500, seed=0,
                prior_type="mean_ebp", mesh=None, score_precision=None):
    """STRise closure for one probe (reference:
    generate_blackbox_saliency.py:48-73); STRise runs on ``device`` (None:
    the card), its scoring split over ``mesh`` if one is given.
    ``bbox()`` evaluates and returns the map; ``bbox.launch()`` enqueues
    the device work and returns a ``finish()`` that returns it."""
    def build():
        from xfr_torch.blackbox.strise import STRise

        kwargs = dict(
            probe=probe_im, refs=mates, gallery=nonmates,
            mask_scale=rise_scale,
            num_mask_elements=num_mask_elements,
            mask_fill_type=mask_fill_type,
            blur_fill_sigma_percent=blur_sigma_percent,
            num_masks=num_masks, seed=seed, prior_type=prior_type,
            device=device, mesh=mesh, score_precision=score_precision)
        if isinstance(blackbox_fn, str):
            # builtin matcher name: the fused on-device scorer (embeds each
            # masked probe once for both galleries)
            return STRise(black_box=blackbox_fn, **kwargs)
        elif isinstance(blackbox_fn, tuple):
            name, net_dict = blackbox_fn
            return STRise(black_box=name, net_dict=net_dict, **kwargs)
        return STRise(black_box_fn=blackbox_fn, **kwargs)

    def bbox():
        strise = build()
        strise.evaluate()
        return strise.saliency_map

    bbox.launch = lambda: build().launch_evaluate()
    return bbox


class BBPipeline:
    """Cross-job double-buffer for blackbox generation.

    Holds at most one pending finish+write closure: pushing job k+1's
    writer first LAUNCHES k+1's device work, then drains job k — so job
    k's score transfers, saliency post-processing and png/npz writes
    overlap job k+1's device queue.  A single generate_bb_smaps call uses
    a local instance; the blackbox CLI threads one instance through all its
    jobs to pipeline across (subject, mask, image) boundaries.

    A pending map's failure is recorded in ``failures`` under its own
    label instead of raising — the drain happens during a LATER map's
    push, and raising there would both misattribute the error and abort
    that later map's remaining work."""

    def __init__(self):
        self._pend = None
        self.failures = []  # (label, repr(exception))

    def push(self, writer, label=None):
        prev, self._pend = self._pend, (label, writer)
        if prev is not None:
            self._run(prev)

    def drain(self):
        if self._pend is not None:
            prev, self._pend = self._pend, None
            self._run(prev)

    def _run(self, item):
        label, writer = item
        try:
            writer()
        except Exception as e:  # recorded, never propagated cross-map
            print("Blackbox map failed: %s (%s)" % (label, e))
            self.failures.append((label, repr(e)))


def generate_bb_smaps(bb_score_fn, convert_from_numpy, net_name, img_base,
                      subj_id, mask_id, ebp_ver, overwrite, device=None,
                      rise_scale=12, num_masks=6500, data_dir=None,
                      smaps_dir=None, prior_type="mean_ebp", mesh=None,
                      pipeline=None, score_precision=None):
    """Generate the blackbox RISE map for one (net, subject, image, mask)
    (reference: generate_blackbox_saliency.py:76-227).  Under ``mesh``
    every rank scores its share of the masks and the first rank writes.

    ``pipeline``: optional BBPipeline shared across calls; when omitted a
    local one is created and fully drained before returning."""
    subject_id = subj_id
    data_dir = data_dir or xfr_torch.inpaintgame2_dir
    smaps_dir = smaps_dir or xfr_torch.inpaintgame_saliencymaps_dir
    cropped_data_dir = os.path.join(data_dir,
                                    "aligned/{}".format(subject_id))
    multiprobe_data_dir = os.path.join(
        smaps_dir,
        "{}/subject_ID_{}".format(net_name, subject_id))

    probe_data, probes, probe_masks, mates, nonmates = _load_triplet(
        net_name, subject_id, mask_id, img_base, data_dir=data_dir)

    # Double-buffered probe pipeline: probe k+1's STRise launches (prior,
    # mask sampling and every scoring chunk enqueue on the device) BEFORE
    # probe k's results are drained, so probe k's host post-processing
    # and png/npz writes overlap probe k+1's device queue; the reference
    # runs strictly serially.
    local = pipeline is None
    if local:
        pipeline = BBPipeline()

    mask_fill_type = "blur"
    blur_sigma_percent = 4
    try:
        for (probe_im, probe_fn), probe_mask_fn, (_, probe_row) in zip(
                image_loader(probes, returnFileName=True), probe_masks,
                probe_data.iterrows()):
            extra_dirs = os.path.split(
                os.path.relpath(probe_fn, cropped_data_dir))[0]
            output_dir = os.path.join(multiprobe_data_dir, extra_dirs)
            os.makedirs(output_dir, exist_ok=True)
            mask_im = next(iter(image_loader([probe_mask_fn])))

            for num_mask_elements in [2]:
                fn = "bbox-rise-%delem_%s=%d_scale_%s" % (
                    num_mask_elements, mask_fill_type, blur_sigma_percent,
                    rise_scale)
                if not overwrite and smap_cached(fn, output_dir, mask_id):
                    continue  # same skip create_save_smap would take
                t0 = time.time()
                finish = create_bbox(
                    blackbox_fn=bb_score_fn, probe_im=probe_im,
                    mates=mates, nonmates=nonmates, rise_scale=rise_scale,
                    num_mask_elements=num_mask_elements,
                    mask_fill_type=mask_fill_type,
                    blur_sigma_percent=blur_sigma_percent,
                    device=device, num_masks=num_masks,
                    prior_type=prior_type, mesh=mesh,
                    score_precision=score_precision).launch()

                def _write(finish=finish, fn=fn, output_dir=output_dir,
                           probe_im=probe_im, mask_im=mask_im,
                           probe_row=probe_row, t0=t0):
                    create_save_smap(
                        fn, output_dir, overwrite, smap_fn=finish,
                        probe_im=probe_im, mask_im=mask_im, mask_id=mask_id,
                        probe_info=probe_row, write=writes(mesh))
                    dt = time.time() - t0
                    print("Time: %dm %fs" % (int(dt // 60), dt % 60))

                pipeline.push(_write, label="%s subj %s mask %s %s" % (
                    net_name, subj_id, mask_id, fn))
    finally:
        # a later probe's failure must not discard an earlier probe's
        # pending, fully-computed map
        if local:
            pipeline.drain()
    if local and pipeline.failures:
        raise RuntimeError("blackbox map(s) failed: %r"
                           % (pipeline.failures,))


# ---------------------------------------------------------------------------
# Batched whitebox generation over in-memory jobs
# ---------------------------------------------------------------------------
#
# A job is a dict with "todo" ({slug key: bool}, the methods still to
# write), "label" (how a failure names it), and, once prepared, "x" (the
# [1,C,H,W] probe on the net's device) and, when a triplet method is to
# run, "em"/"en" (the unit-norm mate/nonmate encodings on the device).
# Callers may keep other keys in it (file paths, output dirs).


def _needs_triplet(todo):
    return todo["contrastive"] or todo["trunc"] or todo["weighted-subtree"]


def prepare_wb_job(wb, job, probe_im, im_mates=None, im_nonmates=None):
    """The heavy half of a job's resolve: the probe on the device, and the
    mate/nonmate encodings when a triplet method needs them (a
    meanEBP-only job skips their encode).  The encodings go to the device
    here, so the group launch copies nothing from the host."""
    job["probe_im"] = probe_im
    if _needs_triplet(job["todo"]):
        em, en = _avg_encodings(wb, im_mates, im_nonmates)
        job["em"], job["en"] = wb._upload(em), wb._upload(en)
    job["x"] = wb.convert_from_numpy(probe_im)
    return job


def launch_wb_group(wb, group, batch_size, subtree_mode_weighted, ebp_ver,
                    wsebp_max_candidates=None):
    """Enqueue every method's device programs for one job group; returns
    the state ``drain_wb_group`` reads.

    Launch-all-then-drain: nothing waits for the card here, so host work
    overlaps the device queue.  Classifier swaps between launches are
    safe: each launch takes the params it was given.

    A tail group pads to ``batch_size`` by DUPLICATING its first job, so
    every group has one shape; duplicate rows give valid results, and
    the drain writes only the group's own jobs."""
    padded = group + [group[0]] * (batch_size - len(group))
    x = torch.cat([j["x"] for j in padded])
    flags = _wsebp_flags(ebp_ver)

    pooled_dev = None
    if any(j["todo"]["meanEBP"] for j in group):
        wb.net.reset_classifier()
        Pn = torch.ones((len(padded), wb.net.num_classes()),
                        dtype=torch.float32, device=x.device)
        pooled_dev, _ = wb._ebp_pooled_fn()(wb.net.params, x, Pn)

    def embed_stacks():
        # meanEBP-only jobs skipped their em/en encode; their rows in a
        # mixed group carry any valid pair (results discarded by the
        # per-job todo gates in the drain, like the padding duplicates)
        em0 = next(j["em"] for j in group if "em" in j)
        en0 = next(j["en"] for j in group if "en" in j)
        return (torch.stack([j.get("em", em0) for j in padded]),
                torch.stack([j.get("en", en0) for j in padded]))

    finish_ct = None
    if any(j["todo"]["contrastive"] or j["todo"]["trunc"] for j in group):
        ems, ens = embed_stacks()
        wb.set_triplet_classifier_batch(ems / 2500.0, ens / 2500.0)
        finish_ct = wb.launch_contrastive_ebp_batch_both(
            x, truncate_percent=TRUNCATE_PERCENT)

    finish_ws = None
    if any(j["todo"]["weighted-subtree"] for j in group) and \
            wsebp_max_candidates is None:
        # batched ranking pass + probe-batched candidate sweeps
        ems, ens = embed_stacks()
        wb.set_triplet_classifier_batch(ems, ens)
        finish_ws = wb.launch_weighted_subtree_ebp_batch(
            x, topk=WSEBP_TOPK, subtree_mode=subtree_mode_weighted,
            verbose=False, **flags)

    return dict(group=group, x=x, pooled_dev=pooled_dev,
                finish_ct=finish_ct, finish_ws=finish_ws,
                subtree_mode_weighted=subtree_mode_weighted, flags=flags,
                wsebp_max_candidates=wsebp_max_candidates)


def drain_wb_group(wb, st, write):
    """Fetch one group's results and hand each map to
    ``write(job, slug_key, smap)``."""
    group = st["group"]
    if st["pooled_dev"] is not None:
        pooled = st["pooled_dev"].cpu().numpy().astype(np.float32)
        for i, j in enumerate(group):
            if j["todo"]["meanEBP"]:
                write(j, "meanEBP", wb._mwp_to_saliency(pooled[i]))
    if st["finish_ct"] is not None:
        cons, truncs = st["finish_ct"]()
        for i, j in enumerate(group):
            if j["todo"]["contrastive"]:
                write(j, "contrastive", cons[i])
            if j["todo"]["trunc"]:
                write(j, "trunc", truncs[i])
    if st["finish_ws"] is not None:
        for j, (smap, _, _, _) in zip(group, st["finish_ws"]()):
            if j["todo"]["weighted-subtree"]:
                write(j, "weighted-subtree", smap)

    if st["wsebp_max_candidates"] is not None:
        # the bounded-candidate path stays per probe (a dynamic candidate
        # subset -> the traced-injection walk)
        for i, j in enumerate(group):
            if not j["todo"]["weighted-subtree"]:
                continue
            wb.net.set_triplet_classifier(j["em"], j["en"])
            smap, _, _, _ = wb.weighted_subtree_ebp(
                st["x"][i:i + 1], 0, 1, topk=WSEBP_TOPK,
                subtree_mode=st["subtree_mode_weighted"], verbose=False,
                max_candidates=st["wsebp_max_candidates"],
                return_subtree_maps=False, **st["flags"])
            write(j, "weighted-subtree", smap)


def run_wb_groups(wb, pend, resolve, write, batch_size,
                  subtree_mode_weighted, ebp_ver, wsebp_max_candidates=None,
                  failures=None):
    """Generate the maps of ``pend`` (jobs) in groups of ``batch_size``,
    double-buffered: group N+1 is resolved (``resolve(job)`` returns the
    prepared job) and launched before group N drains, so group N's host
    drain (transfers, saliency post-processing, ``write``) runs while
    group N+1's programs execute.  Failures stay group-local: a bad job
    or a device error drops that job or group, is appended to
    ``failures`` as (label, repr(exception)), and the run continues.
    Returns the number of jobs drained."""
    failures = [] if failures is None else failures

    def fail_group(group, e, stage):
        print("Job group failed in %s: %s" % (stage, e))
        for j in group:
            failures.append((j["label"], repr(e)))

    def drain(st):
        try:
            drain_wb_group(wb, st, write)
            return len(st["group"])
        except Exception as e:
            fail_group(st["group"], e, "drain")
            return 0

    done = 0
    prev = None
    for lo in range(0, len(pend), batch_size):
        group = []
        for j in pend[lo:lo + batch_size]:
            try:
                group.append(resolve(j))
            except Exception as e:
                print("Job failed: %s (%s)" % (j["label"], e))
                failures.append((("resolve",) + tuple(j["label"]),
                                 repr(e)))
        st = None
        if group:
            try:
                st = launch_wb_group(wb, group, batch_size,
                                     subtree_mode_weighted, ebp_ver,
                                     wsebp_max_candidates)
            except Exception as e:
                fail_group(group, e, "launch")
        if prev is not None:
            done += drain(prev)
        prev = st
    if prev is not None:
        done += drain(prev)
    return done


def generate_wb_smaps_batched(wb, net_name, jobs, subtree_mode_weighted,
                              ebp_ver, overwrite, method=None,
                              wsebp_max_candidates=None, data_dir=None,
                              smaps_dir=None, batch_size=8, device=None):
    """Cross-job batched whitebox generation.

    ``jobs``: list of (subject_id, mask_id, img_base).  meanEBP and
    (truncated-)contrastive run as probe batches (one launch per method
    per batch: meanEBP batches over the shared full classifier,
    contrastive uses the interleaved per-probe classifier); so does
    weighted-subtree unless ``wsebp_max_candidates`` sends it per probe.
    Outputs follow generate_wb_smaps's conventions.  Failed jobs are
    reported in one RuntimeError after every other map is written.
    Returns the number of jobs drained."""
    data_dir = data_dir or xfr_torch.inpaintgame2_dir
    smaps_dir = smaps_dir or xfr_torch.inpaintgame_saliencymaps_dir
    slugs = wb_slugs(wb, subtree_mode_weighted, ebp_ver,
                     "cpu" if device is None else str(device))
    want = {"meanEBP": method in (None, "meanEBP"),
            "contrastive": method in (None, "contrastive"),
            "trunc": method in (None, "contrastive"),
            "weighted-subtree": method in (None, "weighted-subtree")}

    # Light resolve: triplet CSV + paths + cached-method filtering only —
    # image loads, uploads and encodes wait for the group loop so memory
    # stays O(batch) instead of O(jobs).  A bad job (missing probe row,
    # unreadable CSV, ...) is recorded and skipped, like the serial
    # generator's per-job catch (reference pool semantics).
    pend, failures = [], []
    for (subj_id, mask_id, img_base) in jobs:
        try:
            probe_data, probes, probe_masks, mates, nonmates = \
                _load_triplet(net_name, subj_id, mask_id, img_base,
                              data_dir=data_dir)
            cropped = os.path.join(data_dir, "aligned/%s" % subj_id)
            outdir = os.path.join(
                smaps_dir, "%s/subject_ID_%s" % (net_name, subj_id),
                os.path.split(os.path.relpath(probes[0], cropped))[0])
            os.makedirs(outdir, exist_ok=True)
            # smap_cached (not a hand-rolled npz check): the overlay png
            # and npz are one cache unit, so an interrupted earlier run
            # regenerates instead of being skipped forever
            todo = {m: want[m] and (overwrite or
                                    not smap_cached(slugs[m], outdir,
                                                    mask_id))
                    for m in slugs}
            if not any(todo.values()):
                continue
            probe_row = probe_data.iloc[0]
            pend.append(dict(label=(probe_row.get("SUBJECT_ID", "?"),
                                    mask_id),
                             mask_id=mask_id, outdir=outdir, probes=probes,
                             probe_masks=probe_masks, mates=mates,
                             nonmates=nonmates, probe_row=probe_row,
                             todo=todo))
        except Exception as e:
            print("Job failed: %r (%s)" % ((subj_id, mask_id, img_base),
                                           e))
            failures.append(((subj_id, mask_id, img_base), repr(e)))

    def resolve(j):
        probe_im = next(iter(image_loader(j.pop("probes"))))
        j["mask_im"] = next(iter(image_loader(j.pop("probe_masks"))))
        mates, nonmates = j.pop("mates"), j.pop("nonmates")
        if not _needs_triplet(j["todo"]):
            return prepare_wb_job(wb, j, probe_im)
        return prepare_wb_job(wb, j, probe_im, list(image_loader(mates)),
                              list(image_loader(nonmates)))

    def write(j, slug_key, smap):
        create_save_smap(
            slugs[slug_key], j["outdir"], True, smap_fn=lambda: smap,
            probe_im=j["probe_im"], probe_info=j["probe_row"],
            mask_im=j["mask_im"], mask_id=j["mask_id"],
            write=writes(wb.mesh))

    done = run_wb_groups(wb, pend, resolve, write, batch_size,
                         subtree_mode_weighted, ebp_ver,
                         wsebp_max_candidates, failures)
    if failures:
        # completed maps are on disk; fail the run like the serial
        # generator's failure report (and the blackbox pipeline above)
        raise RuntimeError("whitebox job(s) failed: %r" % (failures,))
    return done

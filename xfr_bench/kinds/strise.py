"""STRise maps, one probe a unit, as ``generate_bb_saliency`` makes them.

Traffic keys: ``num_masks``, ``mask_scale``, ``mask_elements``,
``blur_fill_pct``, ``prior`` ("mean_ebp"), ``score_precision`` (the
program's option: "high" is full float32), ``chunk`` (masks scored a
step), ``refs``, ``gallery`` (images shared by every probe of the run, as
one job's probes share them), ``probe_pool`` (distinct probes drawn; the
window takes them in turn), ``check_units`` (maps compared with the
reference after the window), ``trace_units`` (maps in a traced window).

Every image is uint8 RGB at the configuration's ``image_hw``
(``harness.image_hw``), drawn on the device from the run's seed.  A
unit's mask seed is derived from the run's seed and the unit's index.
"""

from __future__ import annotations

import numpy as np

from xfr_bench import harness as H

FAMILY = "bb"
RATE = "bb_maps_per_s"
RANGES = ("bb.launch", "bb.drain")


# the control: the reference with every stage one precision lower
CONTROL = {"lower": True}


# the program's score_precision -> the stage precision it states
SCORE = {"high": "float32", "highest": "float32", None: "tf32"}


def per_unit(tr):
    """Maps a unit."""
    return 1


class Cell:
    """The program's side of one run: set-up in the constructor, then
    ``launch``/``drain`` per unit, then ``release``."""

    def __init__(self, cfg, tr, seed, device, ranges):
        from xfr_torch.blackbox.strise import STRise

        self.cfg, self.tr, self.seed, self.device = cfg, tr, seed, device
        self.ranges = ranges
        self._STRise = STRise
        hw = H.image_hw(cfg)
        self.params = H.weights(cfg, seed, device)
        wb = cfg["program"].program(cfg, self.params, device)
        self.net_dict = {("resnetv6_pytorch", 6): wb,
                         ("resnetv4_pytorch", None): wb}
        self.wb = wb
        self.probes = H.images(seed, device, "probes", tr["probe_pool"],
                               hw).cpu().numpy()
        self.refs = list(H.images(seed, device, "refs", tr["refs"], hw)
                         .cpu().numpy())
        self.gallery = list(H.images(seed, device, "gallery",
                                     tr["gallery"], hw).cpu().numpy())
        self.out = {}
        warm = H.images(seed, device, "warm", 1, hw).cpu().numpy()[0]
        self._launch(warm, H.derive(seed, "warm-masks"))[1]()

    def _launch(self, probe, mask_seed):
        tr = self.tr
        st = self._STRise(
            probe=probe, refs=self.refs, gallery=self.gallery,
            black_box="resnetv6_pytorch", net_dict=self.net_dict,
            prior_type=tr["prior"], num_mask_elements=tr["mask_elements"],
            num_masks=tr["num_masks"], mask_scale=tr["mask_scale"],
            mask_fill_type="blur", blur_fill_sigma_percent=tr[
                "blur_fill_pct"], seed=mask_seed, batch_size=tr["chunk"],
            score_precision=tr["score_precision"], device=self.device)
        return st, st.launch_evaluate()

    def mask_seed(self, u):
        return H.derive(self.seed, "masks", u)

    def launch(self, u):
        with self.ranges("bb.launch"):
            probe = self.probes[u % len(self.probes)]
            return self._launch(probe, self.mask_seed(u))

    def drain(self, launched, u):
        with self.ranges("bb.drain"):
            st, finish = launched
            smap = finish()
            self.out[u] = {"map": np.asarray(smap, np.float32),
                           "cts": np.asarray(st.mask_scores, np.float32),
                           "prior": st.prior.float().cpu().numpy()}

    def release(self):
        """Drop every device reference of the program."""
        self.wb = self.net_dict = self.params = None

    def stage_seconds_at_peak(self):
        """Seconds one map's needed FLOPs take at the H100's peak, by
        stage: the masked probes' encodes at the scoring precision, the
        probe's encode (TF32 allowed), and the mean-EBP prior (two
        forward passes and the walk's input gradients down to the first
        convolution), all in float32 but the probe's encode."""
        R, cfg, tr = self.cfg["reference"], self.cfg, self.tr
        enc = 2 * R.forward_macs(cfg, tuple(cfg["input_chw"]))
        full = 2 * R.forward_macs(cfg, tuple(cfg["input_chw"]), head=True)
        conv1 = 2 * R.first_conv_macs(cfg, tuple(cfg["input_chw"]))
        return [tr["num_masks"] * enc
                / H.PEAK_FLOPS[SCORE[tr["score_precision"]]],
                enc / H.PEAK_FLOPS["tf32"],
                (3 * full - conv1) / H.PEAK_FLOPS["float32"]]


def reference_outputs(cfg, tr, seed, device, units, lower=False):
    """The reference's {unit: {"map", "cts", "prior"}} for ``units``, every
    step from the seed's images; with ``lower`` every stage computes one
    precision lower (the control, put in the program's place)."""
    from xfr_bench.reference import strise as RS

    params = H.weights(cfg, seed, device)
    hw = H.image_hw(cfg)
    probes = H.images(seed, device, "probes", tr["probe_pool"], hw)
    refs = H.images(seed, device, "refs", tr["refs"], hw)
    gallery = H.images(seed, device, "gallery", tr["gallery"], hw)
    spec = {k: tr[k] for k in ("num_masks", "mask_scale", "mask_elements",
                               "blur_fill_pct")}
    out = {}
    for u in units:
        r = RS.saliency_map(params, cfg, probes[u % len(probes)], refs,
                            gallery, H.derive(seed, "masks", u), spec,
                            score=SCORE[tr["score_precision"]], lower=lower,
                            block=tr["chunk"])
        out[u] = {k: v.cpu().numpy().astype(np.float64)
                  for k, v in r.items()}
    return out


def compare(got, want):
    """The worst over the units of ``want`` of: the map's largest gap (the
    maps lie in [0, 1]); the mask scores' largest gap, each side less its
    mean over the masks (the probe's own scores, common to every mask,
    drop out), as a share of the reference's largest such magnitude; and
    the median of the prior's gaps as a share of its largest value (a
    near-tie in the stem's max pool, which float32 rounding routes either
    way, moves a patch of the prior on some seeds; a lower precision
    moves every pixel)."""
    worst = {"map_gap": 0.0, "cts_gap": 0.0, "prior_gap": 0.0}
    for u, ref in want.items():
        g = got[u]
        worst["map_gap"] = max(worst["map_gap"], float(
            np.abs(g["map"] - ref["map"]).max()))
        gc, rc = g["cts"] - g["cts"].mean(), ref["cts"] - ref["cts"].mean()
        worst["cts_gap"] = max(worst["cts_gap"], float(
            np.abs(gc - rc).max() / np.abs(rc).max()))
        worst["prior_gap"] = max(worst["prior_gap"], float(
            np.median(np.abs(g["prior"] - ref["prior"]))
            / ref["prior"].max()))
    return worst

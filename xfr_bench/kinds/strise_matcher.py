"""STRise maps over a matcher that is not the prior's net, one probe a
unit, as ``generate_bb_saliency --net <matcher>`` makes them: the
masked probes are scored by the configuration's matcher on the card, the
mean-EBP prior comes from the ResNet-101 ``resnetv4_pytorch`` proxy that
the configuration's ``proxy`` names.

Traffic keys as ``kinds/strise.py``'s, and ``mate_noise``: the probes
and the references are one subject, as one job's probes and their mates
are (``scene``).  Images are drawn at the configuration's ``image_hw``
(``harness.image_hw``), which STRise masks and the matcher's reference
preprocesses to its input.  The matcher's weights come from the run's
seed through ``harness.weights``, which applies the configuration's own
calibration where its reference has one; the proxy's come from a seed
derived under "proxy", uncalibrated; program and reference are handed
the same weights.
"""

from __future__ import annotations

import numpy as np
import torch

from xfr_bench import harness as H
from xfr_bench.kinds import strise as S
from xfr_bench.kinds.strise import SCORE, compare  # noqa: F401

FAMILY = "bb"
RATE = "bb_maps_per_s"
RANGES = ("bb.launch", "bb.drain")

# the control: the reference with every stage one precision lower
CONTROL = {"lower": True}

per_unit = S.per_unit


def weights(cfg, seed, device):
    """(the matcher's params, the proxy's configuration, the proxy's
    params), the same for program and reference."""
    params = H.weights(cfg, seed, device)
    pcfg = H.config(cfg["proxy"]["config"])
    pcfg["program_name"] = cfg["proxy"]["program_name"]
    pparams = H.make_weights(pcfg["reference"].param_shapes(pcfg),
                             H.derive(seed, "proxy"), device)
    return params, pcfg, pparams


def scene(seed, device, tr, hw):
    """The run's uint8 [N,H,W,3] images on the device: (probes, refs,
    gallery, the warm-up's probe).  Probes, references and the warm-up's
    probe are one subject: a base image drawn from the seed plus uniform
    noise of up to ``mate_noise`` a pixel each; the gallery is other
    images.  (With references unrelated to the probe, a random-weight
    matcher scores no mask positively in about one map in nine, as
    SENet-50-256 did, and no map can be formed.)"""
    hw = tuple(hw)
    base = H.images(seed, device, "subject", 1, hw).int()
    g = H.generator(seed, device, "mates")
    a = tr["mate_noise"]

    def mates(n):
        noise = torch.randint(-a, a + 1, (n,) + hw + (3,), generator=g,
                              device=device)
        return (base + noise).clamp(0, 255).to(torch.uint8)

    probes, refs = mates(tr["probe_pool"]), mates(tr["refs"])
    gallery = H.images(seed, device, "gallery", tr["gallery"], hw)
    return probes, refs, gallery, mates(1)[0]


class Cell(S.Cell):
    """The program's side of one run: set-up in the constructor, then
    ``launch``/``drain`` per unit, then ``release``."""

    def __init__(self, cfg, tr, seed, device, ranges):
        from xfr_torch.blackbox.strise import STRise, _launch_end, \
            _reading_after

        self.cfg, self.tr, self.seed, self.device = cfg, tr, seed, device
        self.ranges = ranges
        self._STRise = STRise
        self._launch_end, self._reading_after = _launch_end, _reading_after
        hw = H.image_hw(cfg)
        self.params, self.pcfg, self.pparams = weights(cfg, seed, device)
        self.wb = cfg["program"].program(cfg, self.params, device)
        self.proxy = self.pcfg["program"].program(self.pcfg, self.pparams,
                                                  device)
        self.net_dict = {(cfg["program_name"], 6): self.wb,
                         (self.pcfg["program_name"], None): self.proxy}
        probes, refs, gallery, warm = scene(seed, device, tr, hw)
        self.probes = probes.cpu().numpy()
        self.refs = list(refs.cpu().numpy())
        self.gallery = list(gallery.cpu().numpy())
        self.out = {}
        self._launch(warm.cpu().numpy(), H.derive(seed, "warm-masks"))[1]()

    def _launch(self, probe, mask_seed):
        """(STRise, its finish, an event at the launch's end on a card)."""
        tr = self.tr
        st = self._STRise(
            probe=probe, refs=self.refs, gallery=self.gallery,
            black_box=self.cfg["program_name"], net_dict=self.net_dict,
            prior_type=tr["prior"], num_mask_elements=tr["mask_elements"],
            num_masks=tr["num_masks"], mask_scale=tr["mask_scale"],
            mask_fill_type="blur", blur_fill_sigma_percent=tr[
                "blur_fill_pct"], seed=mask_seed, batch_size=tr["chunk"],
            score_precision=tr["score_precision"], device=self.device)
        finish = st.launch_evaluate()
        return st, finish, self._launch_end(torch.device(self.device))

    def drain(self, launched, u):
        """The map, its mask scores and its prior, read after the map's
        own launch: on a card the prior is read on a side stream that
        waits for the launch's end alone, so the drain does not wait for
        the next map, queued behind it, as ``generate_bb_saliency``'s
        pipeline does not."""
        with self.ranges("bb.drain"):
            st, finish, end = launched
            smap = finish()
            with self._reading_after(end, torch.device(self.device)):
                prior = st.prior.float().cpu()
            self.out[u] = {"map": np.asarray(smap, np.float32),
                           "cts": np.asarray(st.mask_scores, np.float32),
                           "prior": prior.numpy()}

    def release(self):
        """Drop every device reference of the program."""
        super().release()
        self.proxy = self.pparams = None

    def stage_seconds_at_peak(self):
        """Seconds one map's needed FLOPs take at the H100's peak, by
        stage: the masked probes' encodes by the matcher at the scoring
        precision, the probe's encode by the matcher (TF32 allowed), both
        at the matcher's ``input_chw``, and the mean-EBP prior on the
        proxy in float32 at the images' ``image_hw`` (two forward passes
        and the walk's input gradients down to the first convolution)."""
        cfg, tr, pcfg = self.cfg, self.tr, self.pcfg
        enc = 2 * cfg["reference"].forward_macs(cfg, tuple(cfg["input_chw"]))
        P, chw = pcfg["reference"], (3,) + H.image_hw(cfg)
        full = 2 * P.forward_macs(pcfg, chw, head=True)
        conv1 = 2 * P.first_conv_macs(pcfg, chw)
        return [tr["num_masks"] * enc
                / H.PEAK_FLOPS[SCORE[tr["score_precision"]]],
                enc / H.PEAK_FLOPS["tf32"],
                (3 * full - conv1) / H.PEAK_FLOPS["float32"]]


def reference_outputs(cfg, tr, seed, device, units, lower=False,
                      **controls):
    """The reference's {unit: {"map", "cts", "prior"}} for ``units``, every
    step from the seed's images; with ``lower`` every stage computes one
    precision lower (the control, put in the program's place);
    ``controls`` are the configuration's mechanism controls, handed to
    its reference's encode (SENet's ``flat_gates=True`` flattens every
    gate over its channels); one its encode lacks raises."""
    from xfr_bench.reference import strise_matcher as RM

    params, pcfg, pparams = weights(cfg, seed, device)
    probes, refs, gallery, _ = scene(seed, device, tr, H.image_hw(cfg))
    spec = {k: tr[k] for k in ("num_masks", "mask_scale", "mask_elements",
                               "blur_fill_pct")}
    out = {}
    for u in units:
        r = RM.saliency_map(params, cfg, pparams, pcfg,
                            probes[u % len(probes)], refs, gallery,
                            H.derive(seed, "masks", u), spec,
                            score=SCORE[tr["score_precision"]], lower=lower,
                            block=tr["chunk"], **controls)
        out[u] = {k: v.cpu().numpy().astype(np.float64)
                  for k, v in r.items()}
    return out

"""Plain reference of one STRise saliency map over a matcher other than
the prior's net (stresearch/xfr ``python/xfr/models/strise.py``): the
mean-EBP prior always comes from the ResNet-101 ``resnetv4_pytorch``
proxy, whatever the black box; the masked probes, the references and the
gallery are encoded by the configuration's matcher, its plain reference
``cfg["reference"]`` (its ``preprocess``, which takes the images from
``image_hw`` to the matcher's input, and its ``encode``).

The prior, the mask draw, the blur fill and the scores are
``reference/strise.py``'s; only the matcher's encode is this file's.
Every function works on the tensors' device in their dtype.
"""

from __future__ import annotations

import torch

from xfr_bench.reference import strise as RS


def _encoder(params, cfg, prec, controls):
    """Unit embeddings of [N,H,W,3] images by the configuration's matcher
    at a stage precision: "float32" (TF32 off), "tf32" (TF32 allowed) or
    "bfloat16" (weights and activations in bfloat16); ``controls`` are
    handed to its ``encode``."""
    R = cfg["reference"]
    if prec == "bfloat16":
        params = {n: {k: v.to(torch.bfloat16) for k, v in p.items()}
                  for n, p in params.items()}

    def embed(images):
        with RS.precision(prec == "tf32"):
            x = R.preprocess(images)
            if prec == "bfloat16":
                x = x.to(torch.bfloat16)
            return RS.unit_rows(R.encode(params, cfg, x, **controls)
                                .float())

    return embed


def saliency_map(params, cfg, proxy_params, proxy_cfg, probe, refs,
                 gallery, seed, spec, score="float32", lower=False,
                 block=64, **controls):
    """STRise's map for one probe, every step from the images, as
    ``reference/strise.py``'s ``saliency_map`` with two nets: the prior on
    the proxy (``proxy_params``, ``proxy_cfg``: ResNet-101) in float32,
    every embedding by the matcher (``params``, ``cfg``), the probe's,
    references' and gallery's with TF32 allowed, the masked probes' at
    ``score``; with ``lower`` each stage one precision below.
    ``controls`` are the configuration's mechanism controls, keywords of
    its reference's ``encode`` handed to every encode (SENet's
    ``flat_gates`` flattens every squeeze-excite gate); one its encode
    lacks raises.  Returns {"prior", "cts" [N], "map" [H,W]}."""
    def at(prec):
        return RS.LOWER[prec] if lower else prec

    with RS.precision(at("float32") == "tf32"):
        probe = probe.float()
        prior = RS.prior_map(proxy_params, proxy_cfg, probe)
        masks = RS.draw_masks(prior, seed, spec["num_masks"],
                              spec["mask_scale"], spec["mask_elements"])
        fill = RS.gaussian_blur(probe, spec["blur_fill_pct"] / 100.0
                                * max(probe.shape))
    embed = _encoder(params, cfg, at("tf32"), controls)
    score_embed = _encoder(params, cfg, at(score), controls)
    ref_e = embed(refs.float())
    gal_e = embed(gallery.float())
    pe = embed(probe[None])
    orig_r, orig_g = RS.scores(pe, ref_e), RS.scores(pe, gal_e)
    cts = []
    with RS.precision(False):
        for i in range(0, masks.shape[0], block):
            m = masks[i:i + block, :, :, None]
            e = score_embed(m * probe + (1.0 - m) * fill)
            cts.append(((orig_r - RS.scores(e, ref_e))
                        - (orig_g - RS.scores(e, gal_e))).mean(1))
        cts = torch.cat(cts)
        sel = (cts > 0).float()
        smap = 1.0 - torch.einsum("n,nhw->hw", cts * sel, masks) \
            / torch.clamp(sel.sum(), min=1.0)
        smap = smap - smap.min()
        smap = smap / smap.max()
    return {"prior": prior, "cts": cts, "map": smap}

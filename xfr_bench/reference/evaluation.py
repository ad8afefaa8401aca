"""Plain reference of the inpainting game's evaluation of one saliency
map (stresearch/xfr ``python/xfr/inpainting_game/inpainting_game.py``):
the percent-density threshold masks, the probe blended toward its
inpainted twin under each, the blends' embeddings, their distances to the
original's and the twin's gallery centroids, the twin classification,
and the IoU of each mask with the inpainted region.
"""

from __future__ import annotations

import numpy as np
import torch


def threshold_masks(smap, percentiles, seed, max_noise=1e-9,
                    include_zero=False):
    """[T,H,W] boolean masks: mask t holds the pixels above the threshold
    1 - percentiles[t]/100 of the map's normalized cumulative mass, after
    seeded tie-breaking noise (inpainting_game.py:12-64)."""
    rng = np.random.RandomState(seed)
    nonzero = 1 if include_zero else smap != 0
    noisy = smap + nonzero * rng.rand(*smap.shape) * max_noise
    noisy = noisy / noisy.sum()
    order = np.argsort(noisy.flat)
    noisy.flat[order] = np.cumsum(noisy.flat[order])
    noisy = noisy / noisy.max()
    thr = 1.0 - np.asarray(percentiles, noisy.dtype) / 100
    if percentiles[-1] == 100:
        thr[-1] = 0
    return noisy[None] > thr[:, None, None]


def iou(masks, gt):
    """IoU of each mask with the boolean region ``gt``."""
    tp = (masks & gt[None]).sum(axis=(1, 2))
    union = gt.sum() + masks.sum(axis=(1, 2)) - tp
    return tp / (union + 1e-9)


def centroid(embed, images):
    """Unit mean of the unit embeddings of ``images``."""
    e = embed(images)
    e = e / torch.linalg.norm(e, dim=1, keepdim=True)
    m = e.mean(0, keepdim=True)
    return m / torch.linalg.norm(m, dim=1, keepdim=True)


def evaluate_map(embed, orig, inp, gal_orig, gal_inp, masks, block=128):
    """Blends (1-m)*orig + m*inp of the [T,H,W] masks, embedded by
    ``embed`` (a [N,C,H,W] -> [N,D] function) in blocks; returns the unit
    embeddings [T,D] and the distances to the original's and the twin's
    centroids."""
    m_all = torch.as_tensor(masks, device=orig.device)
    out = []
    for i in range(0, m_all.shape[0], block):
        m = m_all[i:i + block, None].to(orig.dtype)
        out.append(embed((1.0 - m) * orig[None] + m * inp[None]))
    e = torch.cat(out)
    e = e / torch.linalg.norm(e, dim=1, keepdim=True)
    pr = torch.linalg.norm(e - gal_orig, dim=1)
    pg = torch.linalg.norm(e - gal_inp, dim=1)
    return e, pg, pr

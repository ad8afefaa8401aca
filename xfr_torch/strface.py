"""strface compatibility surface (port of xfr_tpu/strface.py).

The reference ships a standalone ``strface`` package with face detection
(Faster R-CNN) and recognition (the STR-Janus ResNet-101).  Here both map
onto the main package:

  * detection -> xfr_torch.detection.FasterRCNN
  * recognition -> the resnet101 graph + the encode helpers below

kept as one module so that users of ``strface`` find the same entry
points.
"""

from __future__ import annotations

import numpy as np

from xfr_torch.detection import FasterRCNN  # noqa: F401  (re-export)


def resnet101v6(pthfile=None, device="cuda"):
    """Recognition network constructor: the ResNet-101+L2 encoder on
    ``device`` (default the card; raises without one)."""
    from xfr_torch.models import create_wbnet

    return create_wbnet("resnetv6_pytorch", weights_path=pthfile,
                        device=device)


def encode_centercrop(wb, img):
    """Single center-crop encoding: PIL image/array -> embedding (numpy)."""
    x = wb.net.preprocess(img)
    return wb.encode(x).cpu().numpy()[0]


def encode_centertwocrop_multiscale(wb, img):
    """Two-crop x 3-scale x flip ensemble template encoding: the mean of
    the 6 crop embeddings, L2-normalized (numpy)."""
    import PIL.Image

    from xfr_torch.data.transforms import (
        resnet101v4_preprocess_twocrop_ensemble)

    if not isinstance(img, PIL.Image.Image):
        img = PIL.Image.fromarray(np.asarray(img))
    x = resnet101v4_preprocess_twocrop_ensemble(device=wb.device)(img)
    e = wb.encode(x).cpu().numpy().mean(axis=0)
    return e / np.linalg.norm(e)

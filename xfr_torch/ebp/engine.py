"""Whitebox saliency API (port of the parts of xfr_tpu/ebp/engine.py that
the STRise path calls).

Ported: ``WhiteboxNetwork``; ``Whitebox.__init__`` without the mesh and
JIT-cache state, the pooled mean-EBP walk (``_ebp_pooled_fn``), ``ebp``,
``_mwp_to_saliency``, ``encode``, ``embeddings`` and
``convert_from_numpy``.  The contrastive, layerwise and weighted-subtree
methods wait for the whitebox slice (ROADMAP queue 1, item 4).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from xfr_torch.ebp import interpreter as I
from xfr_torch.graph import GraphDef
from xfr_torch.utils.device import precision_scope


class WhiteboxNetwork(torch.nn.Module):
    """A network prepared for whitebox EBP.

    Wraps a classify-headed ``GraphDef`` + params.  ``params`` is a plain
    ``{pname: {key: tensor}}`` dict: parameter names carry dots
    (``layer1.0.conv1``), which ``nn.ParameterDict`` refuses.
    ``encode_tensor`` identifies the SSA tensor whose forward value is the
    embedding.  ``forward`` is ``encode``.
    """

    def __init__(self, graph: GraphDef, params, *, encode_tensor: int,
                 classifier_pname: str, num_classes: int,
                 preprocess=None, embed_dim: Optional[int] = None,
                 name: str = "net"):
        super().__init__()
        self.graph = graph
        self.params = dict(params)
        self.encode_tensor = encode_tensor
        self.classifier_pname = classifier_pname
        self._num_classes = num_classes
        self._preprocess = preprocess
        self.embed_dim = embed_dim
        self.name = name
        self._orig_classifier = dict(params).get(classifier_pname)
        self._orig_num_classes = num_classes

    @property
    def device(self):
        for p in self.params.values():
            for v in p.values():
                return v.device
        return torch.device("cpu")

    def _apply(self, fn, recurse=True):
        # the params dict is not registered with nn.Module, so .to()/.cuda()
        # reach it here
        move = lambda p: {k: fn(v) for k, v in p.items()}
        self.params = {k: move(p) for k, p in self.params.items()}
        if self._orig_classifier is not None:
            self._orig_classifier = move(self._orig_classifier)
        return super()._apply(fn, recurse)

    def num_classes(self):
        return self._num_classes

    def reset_classifier(self):
        """Restore the original (full) classifier after triplet runs."""
        if self._orig_classifier is not None:
            self.params = dict(self.params)
            self.params[self.classifier_pname] = self._orig_classifier
        self._num_classes = self._orig_num_classes

    def set_triplet_classifier(self, x_mate, x_nonmate):
        """Replace the classifier with a 2-row [x_mate; x_nonmate] matrix."""
        dev = self.device
        w = torch.cat([torch.as_tensor(x_mate, device=dev).reshape(1, -1),
                       torch.as_tensor(x_nonmate, device=dev).reshape(1, -1)])
        self.params = dict(self.params)
        self.params[self.classifier_pname] = {"w": w}
        self._num_classes = 2
        return self

    def preprocess(self, im):
        """PIL image / numpy HWC image -> [1,C,H,W] network input."""
        if self._preprocess is None:
            raise NotImplementedError(
                f"no preprocess function registered for {self.name}")
        return self._preprocess(im)

    def encode(self, x):
        """Embedding forward."""
        return I.forward_clean(self.graph, self.params, x,
                               keep=(self.encode_tensor,))[self.encode_tensor]

    def forward(self, x):
        return self.encode(x)

    def classify(self, x):
        """Classifier forward."""
        out = self.graph.output_id
        return I.forward_clean(self.graph, self.params, x, keep=(out,))[out]

    def clear(self):
        """Hook-state clearing in the reference; the functional interpreter
        keeps no per-call layer state, so this is a no-op kept for API
        parity."""


class Whitebox:
    """Whitebox EBP saliency engine."""

    def __init__(self, net: WhiteboxNetwork, ebp_version=None, with_bias=None,
                 eps=1e-16, ebp_subtree_mode="affineonly_with_prior"):
        assert isinstance(net, WhiteboxNetwork)
        self.net = net
        self.eps = float(eps)
        self.ebp_ver = 6 if ebp_version is None else ebp_version
        if self.ebp_ver < 4:
            raise RuntimeError("ebp version, if set, must be at least 4")
        self.convert_saliency_uint8 = (self.ebp_ver != 6)
        if with_bias is not None:
            self._ebp_with_bias = bool(with_bias)
        else:
            self._ebp_with_bias = self.ebp_ver == 11
        self._ebp_subtree_mode = ebp_subtree_mode
        self.batch_size = 32  # embeddings batching

        # Exposed after each EBP call, mirroring reference attributes.
        self.P: Dict[int, torch.Tensor] = {}
        self.P_layername = list(net.graph.event_names())

        # Calibration constants, set by the factory.
        self.match_threshold = None
        self.platts_scaling = None

    @property
    def device(self):
        return self.net.device

    @property
    def _n_events(self):
        return self.net.graph.n_events

    def _ebp_pooled_fn(self):
        """(params, x, Pn) -> (channel-pooled MWP [B,H,W], MWP [B,C,H,W])
        at event n_events-2, in full float32 (TF32 off, the TPU's
        precision "high")."""
        graph = self.net.graph
        mode, wb, eps = self._ebp_subtree_mode, self._ebp_with_bias, self.eps
        kk = graph.n_events - 2

        def fn(params, x, Pn):
            with precision_scope("high"):
                out = I.ebp(graph, params, x, Pn.to(x.dtype),
                            subtree_mode=mode, eps=eps, with_bias=wb,
                            keep=(kk,))
            P = out[kk].float()
            return P.sum(dim=1), P

        return fn

    # ------------------------------------------------------------------
    # Saliency post-processing
    # ------------------------------------------------------------------

    def _float32_to_uint8(self, img):
        return np.uint8(255 * ((img - np.min(img)) /
                               (self.eps + (np.max(img) - np.min(img)))))

    def _mwp_to_saliency(self, P, blur_radius=2):
        """Channel-pooled MWP -> saliency map: normalize + gaussian blur.

        v6: float path, skimage.filters.gaussian equivalent
        (scipy.ndimage.gaussian_filter, mode='nearest').
        v!=6: uint8 path via PIL GaussianBlur.
        """
        img = np.asarray(P, dtype=np.float32)
        if self.convert_saliency_uint8:
            import PIL.Image
            import PIL.ImageFilter
            img = self._float32_to_uint8(img)
            img = np.array(PIL.Image.fromarray(img).filter(
                PIL.ImageFilter.GaussianBlur(radius=blur_radius)))
            img = self._float32_to_uint8(img)
        else:
            from scipy.ndimage import gaussian_filter
            img = gaussian_filter(img, blur_radius, mode="nearest")
            img = np.maximum(0, img)
            img /= max(img.sum(), self.eps)
        return img

    # ------------------------------------------------------------------
    # Public EBP API
    # ------------------------------------------------------------------

    def ebp_subtree_mode(self):
        return self._ebp_subtree_mode

    def _as_input(self, x):
        x = torch.as_tensor(x, device=self.device)
        if x.dtype != torch.float64:  # f64 passed only by parity tests
            x = x.float()
        if x.ndim == 3:
            x = x[None]
        return x

    def ebp(self, x, Pn, mwp=False):
        """Excitation backprop: the channel-pooled MWP of the second-to-last
        backward event (the first conv's output plane), optionally
        converted to a saliency map."""
        x = self._as_input(x)
        Pn = torch.as_tensor(Pn, dtype=torch.float32, device=self.device)
        k = self._n_events - 2
        pooled, P_full = self._ebp_pooled_fn()(self.net.params, x, Pn)
        self.P = {k: P_full}
        P = np.squeeze(pooled.cpu().numpy()).astype(np.float32)
        return self._mwp_to_saliency(P) if not mwp else P

    # ------------------------------------------------------------------
    # Embeddings
    # ------------------------------------------------------------------

    def encode(self, x):
        """Embedding forward for a [N,C,H,W] input batch (TF32 allowed, the
        TPU's default precision)."""
        with precision_scope(None):
            return self.net.encode(self._as_input(x))

    def embeddings(self, images, norm=True):
        """Batched embeddings from preprocessed [N,C,H,W] tensors/arrays, a
        list of [C,H,W] ones, or raw HWC images.  Pads the trailing batch
        to ``batch_size`` so every launch has one shape."""
        if isinstance(images, (np.ndarray, torch.Tensor)) and \
                images.ndim == 4 and images.shape[1] in (1, 3):
            imagesT = torch.as_tensor(images, dtype=torch.float32,
                                      device=self.device)
        elif len(images) and isinstance(images[0], (np.ndarray, torch.Tensor)) \
                and images[0].ndim == 3 and images[0].shape[0] in (1, 3):
            # already in network format
            imagesT = torch.stack([
                torch.as_tensor(im, dtype=torch.float32, device=self.device)
                for im in images])
        else:
            # displayable HWC images -> preprocess
            imagesT = torch.cat([self.convert_from_numpy(im)
                                 for im in images]).to(self.device)

        n = imagesT.shape[0]
        bs = self.batch_size
        pad = (-n) % bs
        if pad:
            imagesT = torch.cat([imagesT, imagesT.new_zeros(
                (pad,) + tuple(imagesT.shape[1:]))])
        embeds = [self.encode(imagesT[i:i + bs])
                  for i in range(0, n + pad, bs)]
        embeds = torch.cat(embeds).cpu().numpy()[:n]

        if norm:
            flat = embeds.reshape(embeds.shape[0], -1)
            embeds = (flat / np.linalg.norm(flat, axis=1, keepdims=True)
                      ).reshape(embeds.shape)
        return embeds

    def convert_from_numpy(self, img):
        """Float/uint8 RGB HWC image -> [1,C,H,W] net input."""
        from xfr_torch.utils.image import resize as _resize
        img = np.asarray(img)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255
        if img.max() > 1 + 1e-6 and img.min() > 0 - 1e-6:
            img = img / 255
        img = _resize(img, (224, 224))
        img = (img * 255).astype(np.uint8)
        return self.net.preprocess(img)

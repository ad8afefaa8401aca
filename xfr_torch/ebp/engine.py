"""Whitebox saliency API (port of xfr_tpu/ebp/engine.py).

Ported: ``WhiteboxNetwork``; ``Whitebox`` with its compute-dtype knobs,
the pooled mean-EBP walk (``_ebp_pooled_fn``, ``ebp``, ``ebp_batch``), the
contrastive family (single probe, batched and the fused both-maps
launch), the interleaved batch triplet classifier, and the batched
weighted-subtree path (ranking pass, probe-chunked candidate sweep,
select+merge, ``launch_weighted_subtree_ebp_batch``); plus
``_mwp_to_saliency``, ``encode``, ``embeddings``, ``convert_from_numpy``
and ``preprocess_loader``.  That is the whitebox 4-map mix of the
inpainting game.  The inpainting game's evaluation stage adds the
blend+encode family: threshold-mask blends of a probe toward its twin,
built and encoded on the card (bit-packed masks, the monotone enter-count
plane, several maps of one pair, several pairs).  The layerwise methods,
``subtree_ebp``, the per-probe ``weighted_subtree_ebp`` and its
traced-injection sweep wait for ROADMAP queue 1, item 6.

The JAX package jits each program; here each ``_*_fn`` method returns a
plain function that enqueues its work on the current stream, and a
``lax.scan`` becomes a Python loop over its steps.  No launch path reads
a device value on the host before its ``finish()``.  Every float32 EBP
program runs with TF32 off (``precision_scope("high")``, the TPU's
bf16_3x); ``encode`` and the blend+encode programs allow TF32.  The
device mesh (``use_mesh``) is not ported: one card.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from xfr_torch.ebp import interpreter as I
from xfr_torch.graph import GraphDef
from xfr_torch.utils.device import precision_scope


def _percentile_mass_mask(mwp, percentile, batch_dims=0):
    """Binary mask keeping the top-(100-percentile)% of MWP *mass*.

    The reference sorts ascending, cumsums, and keeps elements whose
    cumulative mass reaches percentile% of the total.  Equivalent
    threshold form: the cutoff is the smallest element value t with
    sum(mwp[mwp <= t]) >= percentile% of the total; keep everything >= t
    (the same up to float summation order at the boundary).

    Found by a 32-step bisection on the value's BIT pattern (non-negative
    float32 values order like their int32 bits) instead of a sort, with
    no host read inside the loop.  The first ``batch_dims`` dims are
    independent planes (the JAX package vmaps this function over them).
    """
    lead = tuple(mwp.shape[:batch_dims])
    flat = mwp.reshape(lead + (-1,)).float()  # MWP mass is non-negative
    total = flat.sum(-1, keepdim=True)
    target = (percentile / 100.0) * total
    hi = flat.amax(-1, keepdim=True).view(torch.int32)
    lo = torch.full_like(hi, -1)
    for _ in range(32):
        # invariant: mass(value(lo)) < target <= mass(value(hi))
        mid = lo + (hi - lo) // 2  # (lo+hi)//2 overflows int32 bit space
        v = torch.clamp(mid, min=0).view(torch.float32)
        mass = torch.where(flat <= v, flat, 0.0).sum(-1, keepdim=True)
        ok = (mass >= target) & (mid >= 0)
        lo = torch.where(ok, lo, mid)
        hi = torch.where(ok, mid, hi)
    thresh = hi.view(torch.float32)
    return (flat >= thresh).to(mwp.dtype).reshape(mwp.shape)


def _wsebp_select_merge(P_out, maxes, scores, topk, do_max, eps):
    """Valid-subtree selection + weighted merge of a candidate sweep.

    Reproduces the reference: candidates in ascending-score order (stable
    ties), keep the last ``topk`` with map-max > 0 excluding event 1,
    min-max-normalize the selected scores (all-ones fallback, chosen on
    the device), normalize each map by its max, merge by weighted sum or
    max.  Returns (merged [H,W], sel [n_cand] bool)."""
    n_cand = scores.shape[0]
    order = torch.argsort(scores, stable=True)
    valid = (maxes > 0) & (torch.arange(n_cand, device=scores.device) != 1)
    v_ord = valid[order]
    # of the valid candidates, keep the last topk in score order
    rank_from_end = v_ord.flip(0).cumsum(0).flip(0)
    sel_ord = v_ord & (rank_from_end <= topk)
    sel = torch.zeros_like(sel_ord).scatter(0, order, sel_ord)

    vmin = torch.where(sel, scores, torch.inf).min()
    vmax = torch.where(sel, scores, -torch.inf).max()
    norm = (scores - vmin) / (eps + (vmax - vmin))
    norm = torch.where(sel, norm, 0.0).float()
    norm = torch.where(norm.sum() == 0, sel.float(), norm)
    mapn = P_out * (1.0 / (P_out.amax(dim=(1, 2, 3), keepdim=True) + 1e-12))
    weighted = norm[:, None, None, None] * mapn * sel[:, None, None, None]
    merged = weighted.amax(dim=0) if do_max else weighted.sum(dim=0)
    return merged[0], sel


def _threshold_blend(counts, t0, T, orig, inp, rows):
    """Rows t0..t0+bs-1 of a monotone threshold-mask family, blended: from
    the family's enter-count plane ``counts`` [1, H*W] int32, mask row t
    holds pixel p iff t < T and counts[p] >= T - t, and its blend is
    (1 - m)·orig + m·inp.  ``rows``: [bs, 1] int32 0..bs-1.  Returns
    [bs, C, H, W]."""
    t = rows + t0
    mk = ((t < T) & (counts >= T - t)).to(orig.dtype)
    mk = mk.reshape(rows.shape[0], 1, orig.shape[-2], orig.shape[-1])
    return (1.0 - mk) * orig[None] + mk * inp[None]


def _interleave_rows(diag):
    """[B, B] -> ([B, 2B] with diag[i, j] at column 2j, the same at column
    2j+1): rows that select each probe's mate (even) or nonmate (odd)
    classifier row, built without an indexed write (which would wait for
    the card)."""
    zero = torch.zeros_like(diag)
    B = diag.shape[0]
    return (torch.stack([diag, zero], 2).reshape(B, 2 * B),
            torch.stack([zero, diag], 2).reshape(B, 2 * B))


def _contrastive_combine(P, eps, percentile, kinds):
    """Per-probe contrastive maps from mate/nonmate MWPs P [2,B,C,H,W]:
    each normalized to unit mass, then relu(mate - nonmate) ("contrastive")
    and/or the same gated by the mate's percentile-mass mask
    ("truncated"), pooled over channels -> [B,H,W] each."""
    mate, nonmate = (q / torch.clamp(q.sum(dim=(1, 2, 3), keepdim=True),
                                     min=eps) for q in (P[0], P[1]))
    out = []
    for kind in kinds:
        if kind == "contrastive":
            diff = torch.clamp(mate - nonmate, min=0)
        else:
            mask = _percentile_mass_mask(mate, percentile, batch_dims=1)
            diff = torch.clamp(mask * mate - mask * nonmate, min=0)
        out.append(diff.sum(dim=1))
    return out


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
                 eps=1e-16, ebp_subtree_mode="affineonly_with_prior",
                 compute_dtype=None, wsebp_dtype=None,
                 contrastive_dtype=None):
        """compute_dtype: optional torch dtype (e.g. torch.bfloat16) for the
        EBP compute; MWP outputs are cast back to float32.  The default
        float32 matches the reference numerics.  Contrastive variants
        subtract nearly-equal distributions, which amplifies bfloat16
        rounding.

        wsebp_dtype: compute dtype of the weighted-subtree candidate sweep
        only (defaults to compute_dtype).  bfloat16 here is the generation
        CLI's production setting; its maps feed a blur+normalize+merge.
        float16 is refused: eps (1e-16) underflows to zero in it.

        contrastive_dtype: compute dtype of the contrastive/truncated
        backward passes only (defaults to compute_dtype).

        The ranking pass of the weighted-subtree path always runs float32.
        The JAX package's ``wsebp_scan_unroll`` (the unroll of its
        ``lax.scan`` over probe chunks) has no counterpart: the port walks
        the chunks in a Python loop."""
        assert isinstance(net, WhiteboxNetwork)
        self.net = net
        self.compute_dtype = compute_dtype or torch.float32
        self.wsebp_dtype = wsebp_dtype
        self.contrastive_dtype = contrastive_dtype
        # probes per step of the batched sweep: each step's walk ops carry
        # a [rows, chunk, ...] batch (see _wsebp_scan_local)
        self.wsebp_probe_chunk = 1
        # cascaded sweep walk: merge the candidate buckets' walks below
        # their shared frontiers into one growing-row walk (identical math,
        # fewer walk ops; see I.ebp_backward_allevents)
        self.wsebp_cascade = True
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
        # max rows per step of the mono blend+encode programs
        self.blend_batch = 32

        # Exposed after each EBP call, mirroring reference attributes.
        self.P: Dict[int, torch.Tensor] = {}
        self.P_layername = list(net.graph.event_names())

        # Calibration constants, set by the factory.
        self.match_threshold = None
        self.platts_scaling = None

        # content-hash -> device tensor memo for repeated image uploads
        # (the analysis loop re-evaluates the same probe/twin pair for
        # every method)
        self._upload_memo = {}

    @property
    def device(self):
        return self.net.device

    @property
    def _n_events(self):
        return self.net.graph.n_events

    def _prep(self, params, x, dtype=None):
        """Cast params/input to the compute dtype."""
        dtype = dtype or self.compute_dtype
        if dtype == torch.float32:
            return params, x
        return ({k: {kk: vv.to(dtype) for kk, vv in v.items()}
                 for k, v in params.items()}, x.to(dtype))

    @property
    def _wsebp_dtype(self):
        dtype = self.wsebp_dtype or self.compute_dtype
        if torch.finfo(dtype).tiny > self.eps:
            raise ValueError(
                f"sweep dtype {dtype}: eps={self.eps} underflows to zero in "
                "it (float16 cannot carry eps=1e-16); use torch.bfloat16 or "
                "torch.float32")
        return dtype

    @property
    def _contrastive_dtype(self):
        return self.contrastive_dtype or self.compute_dtype

    def _capture(self, params, x, dtype=None):
        """Both forward passes in the compute dtype: (params, values,
        posvals) for the backward walks."""
        params, x = self._prep(params, x, dtype)
        values = I.forward_clean(self.net.graph, params, x)
        posvals = I.forward_positive(self.net.graph, params, values,
                                     with_bias=self._ebp_with_bias)
        return params, values, posvals

    def _ebp_pooled_fn(self):
        """(params, x, Pn) -> (channel-pooled MWP [B,H,W], MWP [B,C,H,W])
        at event n_events-2, float32 out, with TF32 off (the TPU's
        precision "high")."""
        graph = self.net.graph
        mode, wb, eps = self._ebp_subtree_mode, self._ebp_with_bias, self.eps
        kk = graph.n_events - 2

        def fn(params, x, Pn):
            with precision_scope("high"):
                params, values, posvals = self._capture(params, x)
                out = I.ebp_backward(
                    graph, params, values, posvals,
                    Pn.to(values[graph.input_id].dtype)[None],
                    subtree_mode=mode, eps=eps, with_bias=wb, keep=(kk,))
            P = out[kk][0].float()
            return P.sum(dim=1), P

        return fn

    def _contrastive_pair_fn(self, kinds):
        """(params, x, Pns [2,B,K], percentile) -> list of [B,H,W] maps,
        one per entry of ``kinds`` ("contrastive", "truncated"): the mate
        and nonmate walks share one forward-capture pair and run as the
        two rows of one batched walk (the JAX package's vmap)."""
        graph = self.net.graph
        mode, wb, eps = self._ebp_subtree_mode, self._ebp_with_bias, self.eps
        kk = graph.n_events - 2
        cdt = self._contrastive_dtype

        def fn(params, x, Pns, percentile):
            with precision_scope("high"):
                params, values, posvals = self._capture(params, x, cdt)
                P = I.ebp_backward(
                    graph, params, values, posvals,
                    Pns.to(values[graph.input_id].dtype),
                    subtree_mode=mode, eps=eps, with_bias=wb,
                    keep=(kk,))[kk].float()  # [2, B, C, H, W]
                return _contrastive_combine(P, eps, percentile, kinds)

        return fn

    def _contrastive_fn(self, truncate=False):
        """Single-probe contrastive / truncated-contrastive combine:
        (params, x, Pns [2,1,K], percentile) -> [H,W]."""
        pair = self._contrastive_pair_fn(
            ("truncated",) if truncate else ("contrastive",))
        return lambda params, x, Pns, percentile: pair(
            params, x, Pns, percentile)[0][0]

    # ------------------------------------------------------------------
    # Saliency post-processing
    # ------------------------------------------------------------------

    def _float32_to_uint8(self, img):
        return np.uint8(255 * ((img - np.min(img)) /
                               (self.eps + (np.max(img) - np.min(img)))))

    def _scale_normalized(self, img):
        img = np.float32(img)
        return (img - np.min(img)) / (self.eps + (np.max(img) - np.min(img)))

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

    def _onehot(self, k):
        P = torch.zeros((1, self.net.num_classes()), dtype=torch.float32,
                        device=self.device)
        P[0, k] = 1.0
        return P

    def contrastive_ebp(self, img_probe, k_poschannel, k_negchannel):
        """Contrastive EBP: relu(mwp_mate - mwp_nonmate) at event -2, each
        normalized to unit mass."""
        x = self._as_input(img_probe)
        Pns = torch.stack([self._onehot(k_poschannel),
                           self._onehot(k_negchannel)])
        mwp = self._contrastive_fn(truncate=False)(self.net.params, x, Pns,
                                                    0.0)
        return self._mwp_to_saliency(mwp.cpu().numpy().astype(np.float32))

    def truncated_contrastive_ebp(self, img_probe, k_poschannel, k_negchannel,
                                  percentile=20):
        """Truncated contrastive EBP: a percentile-mass mask on the mate
        MWP gates the contrastive difference."""
        x = self._as_input(img_probe)
        Pns = torch.stack([self._onehot(k_poschannel),
                           self._onehot(k_negchannel)])
        mwp = self._contrastive_fn(truncate=True)(self.net.params, x, Pns,
                                                   float(percentile))
        return self._mwp_to_saliency(mwp.cpu().numpy().astype(np.float32))

    # ------------------------------------------------------------------
    # Probe-batched triplet EBP
    # ------------------------------------------------------------------
    #
    # B probes with B different (mate, nonmate) classifiers run as ONE
    # batch: the per-probe 2-row classifiers interleave into a single
    # [2B, D] matrix and each probe's cotangent selects only its own two
    # rows.  Because the classifier is linear, zero cotangent rows
    # contribute nothing to the backward: per-probe results are exactly
    # the 2-class runs.

    def set_triplet_classifier_batch(self, x_mates, x_nonmates):
        """Install an interleaved [2B, D] float32 classifier for B probes.
        Tensors already on the card are used as they are; numpy arrays are
        copied there (a copy that waits for the card's queue)."""
        dev = self.device
        m = torch.as_tensor(x_mates, dtype=torch.float32, device=dev)
        n = torch.as_tensor(x_nonmates, dtype=torch.float32, device=dev)
        B, D = m.shape
        w = torch.stack([m, n], dim=1).reshape(2 * B, D)
        self.net.params = dict(self.net.params)
        self.net.params[self.net.classifier_pname] = {"w": w}
        self.net._num_classes = 2 * B
        return B

    def _pad_probe_batch(self, x):
        """The probe batch as float32 on the card; B must equal the
        installed batch classifier's width (the JAX package pads only
        under a device mesh, which the port does not have)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        B = x.shape[0]
        if B != self.net.num_classes() // 2:
            raise ValueError(
                "call set_triplet_classifier_batch matching the probe batch "
                f"(B={B}, classifier for {self.net.num_classes() // 2})")
        return x, B

    def _batch_cotangents(self, B, kind):
        """[B, 2B] (or [2, B, 2B]) cotangent rows selecting each probe's
        own classifier rows, built on the card."""
        mate, nonmate = _interleave_rows(
            torch.eye(B, dtype=torch.float32, device=self.device))
        if kind == "mean":
            return mate + nonmate
        return torch.stack([mate, nonmate])

    def ebp_batch(self, x, mwp=False):
        """Batched meanEBP over the installed batch triplet classifiers:
        x [B,C,H,W] -> list of B saliency maps."""
        x, B = self._pad_probe_batch(x)
        Pn = self._batch_cotangents(B, "mean")
        pooled, P_full = self._ebp_pooled_fn()(self.net.params, x, Pn)
        self.P = {self._n_events - 2: P_full}
        pooled = pooled.cpu().numpy().astype(np.float32)
        if mwp:
            return [pooled[i] for i in range(B)]
        return [self._mwp_to_saliency(pooled[i]) for i in range(B)]

    def _contrastive_batch_fn(self, truncate=False):
        """Batched contrastive combine with per-sample normalization and
        truncation: (params, x, Pns [2,B,2B], percentile) -> [B,H,W]."""
        pair = self._contrastive_pair_fn(
            ("truncated",) if truncate else ("contrastive",))
        return lambda params, x, Pns, percentile: pair(
            params, x, Pns, percentile)[0]

    def contrastive_ebp_batch(self, x, truncate_percent=None):
        """Batched (truncated-)contrastive EBP over the installed batch
        classifiers: x [B,C,H,W] -> list of B saliency maps."""
        x, B = self._pad_probe_batch(x)
        Pns = self._batch_cotangents(B, "contrastive")
        mwp = self._contrastive_batch_fn(truncate_percent is not None)(
            self.net.params, x, Pns, float(truncate_percent or 0.0))
        mwp = mwp.cpu().numpy().astype(np.float32)
        return [self._mwp_to_saliency(mwp[i]) for i in range(B)]

    def _contrastive_both_fn(self):
        """Contrastive AND truncated-contrastive maps from ONE
        forward-capture pair and one two-row backward walk (the two
        variants differ only in the final combine): (params, x, Pns,
        percentile) -> ([B,H,W], [B,H,W])."""
        return self._contrastive_pair_fn(("contrastive", "truncated"))

    def launch_contrastive_ebp_batch_both(self, x, truncate_percent=20):
        """Enqueue the batched contrastive+truncated program and return a
        ``finish()`` closure producing (contrastive maps, truncated maps).
        Nothing waits for the card before ``finish()``."""
        x, B = self._pad_probe_batch(x)
        Pns = self._batch_cotangents(B, "contrastive")
        contr_dev, trunc_dev = self._contrastive_both_fn()(
            self.net.params, x, Pns, float(truncate_percent))

        def finish():
            contr = contr_dev.cpu().numpy().astype(np.float32)
            trunc = trunc_dev.cpu().numpy().astype(np.float32)
            return ([self._mwp_to_saliency(contr[i]) for i in range(B)],
                    [self._mwp_to_saliency(trunc[i]) for i in range(B)])

        return finish

    def contrastive_ebp_batch_both(self, x, truncate_percent=20):
        """Batched contrastive + truncated-contrastive in one launch:
        x [B,C,H,W] -> (list of B contrastive maps, list of B truncated
        maps)."""
        return self.launch_contrastive_ebp_batch_both(x, truncate_percent)()

    # ------------------------------------------------------------------
    # Weighted subtree EBP, probe-batched
    # ------------------------------------------------------------------

    def _wsebp_grad_batch_fn(self):
        """(params, x, gating) -> per-probe subtree scores, argmaxes and
        injection values [B, n_events-1] each, for a probe batch under the
        interleaved [2B, D] triplet classifier: the ranking pass.

        One natural backward walks the mate (or softmax cross-entropy) and
        nonmate cotangents as two rows; each event's dA pair is reduced to
        its gated max and first argmax as it fires.  One EBP walk under the
        mate cotangent then picks P_mate[k] at each event's argmax.  Always
        float32 with TF32 off, whatever compute_dtype is."""
        graph = self.net.graph
        mode, wb, eps = self._ebp_subtree_mode, self._ebp_with_bias, self.eps
        cand = tuple(range(graph.n_events - 1))

        def fn(params, x, gating):
            with precision_scope("high"):
                B = x.shape[0]
                params, values, posvals = self._capture(params, x,
                                                        torch.float32)
                y = values[graph.output_id]  # [B, 2B]
                eye = torch.eye(B, dtype=y.dtype, device=y.device)
                cot_m, cot_n = _interleave_rows(eye)
                if gating:
                    cots = torch.stack([cot_m, cot_n])
                else:
                    # per-probe softmax over each probe's own two logits
                    pair = torch.diagonal(y.reshape(B, B, 2), 0, 0, 1).T
                    sm = torch.softmax(pair, dim=-1)
                    ce_m, _ = _interleave_rows(eye * (sm[:, :1] - 1.0))
                    _, ce_n = _interleave_rows(eye * sm[:, 1:])
                    cots = torch.stack([ce_m + ce_n, cot_n])

                def gate(_, dA):
                    a, b = dA[0], dA[1]
                    gated = ((a >= 0) * (-b)) if gating else ((a < 0) * (-b))
                    flat = gated.reshape(B, -1)
                    # ties (the plane is full of exact zeros) go to the
                    # first index, as jnp.argmax does
                    return flat.amax(dim=1), flat.argmax(dim=1)

                ranked = I.natural_backward(graph, params, values, cots,
                                            keep=cand, reduce=gate)
                scores = torch.stack([ranked[k][0] for k in cand], 1)
                idxs = torch.stack([ranked[k][1] for k in cand], 1)

                def pick(k, P):
                    return P[0].reshape(B, -1).gather(
                        1, idxs[:, k:k + 1])[:, 0]

                picked = I.ebp_backward(
                    graph, params, values, posvals, cot_m[None],
                    subtree_mode=mode, eps=eps, with_bias=wb, keep=cand,
                    reduce=pick)
                vals = torch.stack([picked[k] for k in cand], 1)
            return scores, idxs, vals

        return fn

    def _wsebp_scan_local(self, topk, do_max, n_buckets, chunk):
        """The batched-sweep body: one forward-capture pair for the whole
        batch, then a loop over probe chunks (the JAX package's lax.scan)
        whose step is the bucketed candidate walk on chunk-slices of the
        captures plus the fused selection/merge.

        Returns local(params, values, posvals, elems, vals, scores) ->
        (merged [B,H,W], sel [B,n_cand]) for captures already in the sweep
        compute dtype."""
        graph = self.net.graph
        mode, wb, eps = self._ebp_subtree_mode, self._ebp_with_bias, self.eps
        casc = bool(self.wsebp_cascade)

        def local(params, values, posvals, elems, vals, scores):
            B = values[graph.input_id].shape[0]
            dtype = values[graph.input_id].dtype
            C = chunk if B % chunk == 0 else 1
            merged, sel = [], []
            for s in range(0, B, C):
                vs = [v[s:s + C] for v in values]
                ps = [v[s:s + C] for v in posvals]
                if C == 1:
                    el, va = elems[s], vals[s]
                else:
                    el, va = elems[s:s + C].T, vals[s:s + C].T
                P_out, maxes = I.ebp_backward_allevents(
                    graph, params, vs, ps, el, va.to(dtype),
                    subtree_mode=mode, eps=eps, with_bias=wb,
                    n_buckets=n_buckets, cascade=casc)
                if C == 1:
                    maxes = maxes[:, None]
                for j in range(C):
                    m, sl = _wsebp_select_merge(P_out[:, j:j + 1],
                                                maxes[:, j],
                                                scores[s + j], topk, do_max,
                                                eps)
                    merged.append(m)
                    sel.append(sl)
            return torch.stack(merged), torch.stack(sel)

        return local

    def _wsebp_sweep_select_scan_fn(self, topk, do_max, n_buckets=12,
                                    probe_chunk=None):
        """Fused sweep+selection+merge for a whole probe BATCH: one
        batch-B forward-capture pair shared by a loop over probe CHUNKS
        whose body is the probe-batched bucketed candidate walk.

        ``probe_chunk`` > 1 multiplies every walk op's batch by the chunk;
        it applies when it divides B, else the chunk is 1.
        (params, x, elems, vals, scores) -> (merged [B,H,W],
        sel [B,n_cand])."""
        chunk = int(probe_chunk or self.wsebp_probe_chunk)
        local = self._wsebp_scan_local(topk, do_max, n_buckets, chunk)
        sweep_dt = self._wsebp_dtype

        def fn(params, x, elems, vals, scores):
            with precision_scope("high"):
                params, values, posvals = self._capture(params, x, sweep_dt)
                return local(params, values, posvals, elems, vals, scores)

        return fn

    def _wsebp_sweep_select_batch_fn(self, topk, do_max, n_buckets=12):
        """The same fused sweep as ONE probe-batched walk: every op carries
        a [rows, B, ...] batch (the scan body with the chunk set to B)."""
        sweep_dt = self._wsebp_dtype

        def fn(params, x, elems, vals, scores):
            local = self._wsebp_scan_local(topk, do_max, n_buckets,
                                           x.shape[0])
            with precision_scope("high"):
                params, values, posvals = self._capture(params, x, sweep_dt)
                return local(params, values, posvals, elems, vals, scores)

        return fn

    def launch_weighted_subtree_ebp_batch(self, x, topk=1, verbose=False,
                                          do_max_subtree=False,
                                          do_mated_similarity_gating=True,
                                          subtree_mode="norelu",
                                          do_mwp_to_saliency=True):
        """Enqueue the whole weighted-subtree batch and return a
        ``finish()`` closure yielding the result list.  The batched
        ranking pass runs first; its outputs feed the candidate sweep as
        device tensors (no host round trip between the stages, and no host
        read before ``finish()``).  The sweeps run as one program sharing a
        batch-B forward-capture pair."""
        x_pad, B = self._pad_probe_batch(x)
        prev_mode = self._ebp_subtree_mode
        self._ebp_subtree_mode = subtree_mode
        try:
            scores_d, idxs_d, vals_d = self._wsebp_grad_batch_fn()(
                self.net.params, x_pad,
                gating=bool(do_mated_similarity_gating))
            merged_d, sel_d = self._wsebp_sweep_select_scan_fn(
                topk, bool(do_max_subtree))(
                self.net.params, x_pad, idxs_d.to(torch.int32), vals_d,
                scores_d)
        finally:
            self._ebp_subtree_mode = prev_mode

        def finish():
            prev = self._ebp_subtree_mode
            self._ebp_subtree_mode = subtree_mode
            try:
                scores = scores_d.cpu().numpy().astype(np.float32)
                merged = merged_d.cpu().numpy().astype(np.float32)
                sel = sel_d.cpu().numpy()
                return [self._wsebp_fused_finish(
                            merged[i], sel[i], scores[i], verbose,
                            do_mwp_to_saliency)
                        for i in range(B)]
            finally:
                self._ebp_subtree_mode = prev

        return finish

    def weighted_subtree_ebp_batch(self, x, topk=1, verbose=False,
                                   do_max_subtree=False,
                                   do_mated_similarity_gating=True,
                                   subtree_mode="norelu",
                                   do_mwp_to_saliency=True,
                                   return_subtree_maps=False):
        """Weighted-subtree EBP for a probe batch under the interleaved
        batch triplet classifier (set_triplet_classifier_batch).  Per-probe
        results match the 2-class runs of each probe.

        Returns a list of (smap, [], P_subtree_valid, k_subtree_valid)
        tuples.  ``return_subtree_maps=True`` (the per-probe host path
        ``_wsebp_post``) is not ported yet."""
        if return_subtree_maps:
            raise NotImplementedError(
                "return_subtree_maps=True goes through the per-probe "
                "weighted-subtree path, not ported yet: ROADMAP queue 1, "
                "item 6")
        return self.launch_weighted_subtree_ebp_batch(
            x, topk=topk, verbose=verbose, do_max_subtree=do_max_subtree,
            do_mated_similarity_gating=do_mated_similarity_gating,
            subtree_mode=subtree_mode,
            do_mwp_to_saliency=do_mwp_to_saliency)()

    def _wsebp_fused_finish(self, smap, sel, P_subtree, verbose,
                            do_mwp_to_saliency):
        """Host side of the fused weighted-subtree path: from the merged
        map and selection mask (numpy), rebuild the reference's
        valid-subtree bookkeeping and normalize."""
        k_order = np.argsort(P_subtree, kind="stable")
        if verbose:
            for k in k_order:
                print("[weighted_subtree_ebp][%d]: layername=%s, "
                      "grad=%f" % (k, self.P_layername[k], P_subtree[k]))
        k_subtree_valid = [int(k) for k in k_order if sel[k]]
        if len(k_subtree_valid) == 0:
            raise RuntimeError(
                "Failed to calculate valid subtrees. The ebp subtree "
                "mode (%s) may not be supported by this type of "
                "network. You may want to try the "
                '"affineonly_with_prior" ebp subtree mode.'
                % self._ebp_subtree_mode)
        P_subtree_valid = [float(P_subtree[k]) for k in k_subtree_valid]
        if self.convert_saliency_uint8:
            smap = self._float32_to_uint8(smap)
        else:
            smap = smap / max(smap.sum(), self.eps)
        return (
            self._mwp_to_saliency(smap) if do_mwp_to_saliency else smap,
            [], P_subtree_valid, k_subtree_valid)

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
        list of [C,H,W] ones, a DataFrame of image rows, or file paths /
        raw HWC images.  Pads the trailing batch to ``batch_size`` so every
        launch has one shape."""
        from xfr_torch.utils.image import (_is_dataframe,
                                           dataframe_image_loader,
                                           image_loader)

        if isinstance(images, (np.ndarray, torch.Tensor)) and \
                images.ndim == 4 and images.shape[1] in (1, 3):
            imagesT = torch.as_tensor(images, dtype=torch.float32,
                                      device=self.device)
        elif _is_dataframe(images):
            imagesT = torch.cat([
                self.convert_from_numpy(im)
                for im in dataframe_image_loader(images)]).to(self.device)
        elif len(images) and isinstance(images[0], (np.ndarray, torch.Tensor)) \
                and images[0].ndim == 3 and images[0].shape[0] in (1, 3):
            # already in network format
            imagesT = torch.stack([
                torch.as_tensor(im, dtype=torch.float32, device=self.device)
                for im in images])
        else:
            # file paths / displayable HWC images -> loader + preprocess
            imagesT = torch.cat([
                self.convert_from_numpy(im)
                for im in image_loader(list(images))]).to(self.device)

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

    # ------------------------------------------------------------------
    # Threshold-mask blend + encode (the inpainting game's evaluation)
    # ------------------------------------------------------------------
    #
    # Each program blends a probe toward its twin under binary masks and
    # encodes the blends, with the masks built on the card.  A mask is 0 or
    # 1, so (1 - m)·orig + m·inp is a per-pixel select: the blends equal
    # the host float64 blends cast to float32 bit for bit.  The JAX
    # package's lax.scan over (map, chunk-start) steps is a Python loop
    # here; each step encodes the same [bs, C, H, W] batch as there,
    # rows past T included, into one preallocated output.

    def _upload(self, arr):
        """A host array as a tensor on the net's device.  On the card it
        goes through pinned memory without waiting (the launch paths never
        wait for the card); on the CPU it is copied."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.clone()

    def _device_put_memo(self, arr):
        """Upload a host array once per content: a small content-hash memo
        returns the live device tensor for repeated uploads."""
        from xfr_torch.utils.cache import content_key, memo_put

        key = content_key(arr)
        dev = self._upload_memo.get(key)
        if dev is None:
            dev = memo_put(self._upload_memo, key, self._upload(arr))
        return dev

    def _blend_encode_fn(self):
        """(params, orig, inp, bits) -> [n, D]: unpack bit-packed threshold
        masks (np.packbits order, MSB first), blend probe->twin and encode
        them, TF32 allowed."""
        graph, enc = self.net.graph, self.net.encode_tensor

        def fn(params, orig, inp, bits):
            H, W = orig.shape[-2], orig.shape[-1]
            shifts = torch.arange(7, -1, -1, dtype=torch.uint8,
                                  device=bits.device)
            m = (bits[:, :, None] >> shifts) & 1
            m = m.reshape(bits.shape[0], -1)[:, :H * W]
            m = m.to(orig.dtype).reshape(bits.shape[0], 1, H, W)
            blends = (1.0 - m) * orig[None] + m * inp[None]
            with precision_scope(None):
                e = I.forward_clean(graph, params, blends, keep=(enc,))[enc]
            return e.reshape(e.shape[0], -1)

        return fn

    def _blend_encode_mono_multi_local(self, T, bs):
        """The step loop of every mono program (single map, several maps
        of one pair, several pairs): for each (map m, chunk start t0,
        pair p) step, build the [bs, 1, H, W] masks of rows t0..t0+bs-1
        from map m's enter-count plane (row t contains pixel p iff t < T
        and counts[p] >= T - t), blend pair p's probe toward its twin,
        encode, and write the rows into ``out[m, t0:t0+bs]``.

        local(params, origs [P,C,H,W], inps, counts [M, H*W] uint8,
        steps, n_maps) -> out [n_maps, rows, D], allocated once the
        first step has given D."""
        graph, enc = self.net.graph, self.net.encode_tensor

        def local(params, origs, inps, counts, steps, n_maps):
            c_all = counts.to(torch.int32)
            rows = torch.arange(bs, dtype=torch.int32,
                                device=counts.device)[:, None]
            n_rows = max(t0 for _, t0, _ in steps) + bs
            out = None
            for m, t0, p in steps:
                blends = _threshold_blend(c_all[m][None], t0, T, origs[p],
                                          inps[p], rows)
                with precision_scope(None):
                    e = I.forward_clean(graph, params, blends,
                                        keep=(enc,))[enc].reshape(bs, -1)
                if out is None:
                    out = e.new_empty((n_maps, n_rows, e.shape[1]))
                out[m, t0:t0 + bs] = e
            return out

        return local

    def launch_blend_embeddings_counts_multi_pair(
            self, orig_imTs, inpaint_imTs, counts_mat, pair_idx, T,
            norm=True):
        """Batch M monotone mask families spanning P probe/twin image
        pairs into one blend+encode program.  ``orig_imTs`` /
        ``inpaint_imTs``: length-P sequences of [C,H,W] images;
        ``counts_mat``: [M, H*W] uint8 enter-count planes (counts[p] =
        number of masks containing pixel p; by monotonicity pixel p is in
        masks T-counts[p]..T-1); ``pair_idx``: [M] indices into the pair
        stacks.  Map m runs ceil(T/bs) steps of bs rows, bs =
        min(blend_batch, ceil(T/batch_size)*batch_size); rows past T
        encode the pure original and are dropped.  ``finish()`` returns
        [M, T, D] embeddings."""
        counts_mat = np.ascontiguousarray(counts_mat, np.uint8)
        pair_idx = np.ascontiguousarray(pair_idx, np.int32)
        assert T <= 255 and counts_mat.ndim == 2
        M = counts_mat.shape[0]
        assert len(inpaint_imTs) == len(orig_imTs) and pair_idx.shape == (M,)
        bs = self.batch_size
        origs = torch.stack([self._device_put_memo(
            np.asarray(o, np.float32)) for o in orig_imTs])
        inps = torch.stack([self._device_put_memo(
            np.asarray(i, np.float32)) for i in inpaint_imTs])
        bs_m = min(self.blend_batch, -(-T // bs) * bs)
        steps = [(m, t0, int(pair_idx[m])) for m in range(M)
                 for t0 in range(0, -(-T // bs_m) * bs_m, bs_m)]
        out = self._blend_encode_mono_multi_local(T, bs_m)(
            self.net.params, origs, inps, self._upload(counts_mat), steps, M)
        return self._finish_embeds(out[:, :T], norm)

    @staticmethod
    def _finish_embeds(out, norm):
        """finish() of a blend+encode launch: the one host read, then the
        unit norm along the last axis in numpy (float32)."""

        def finish():
            embeds = out.cpu().numpy()
            if norm:
                embeds = embeds / np.linalg.norm(embeds, axis=-1,
                                                 keepdims=True)
            return embeds

        return finish

    def launch_blend_embeddings(self, orig_imT, inpaint_imT, masks,
                                norm=True):
        """Enqueue threshold-mask blend + encode on the card; returns a
        zero-argument ``finish()`` that syncs and returns the [T,D]
        embeddings, so callers overlap host work (IoU curves, the next
        unit's mask build) with the device encode.

        ``masks``: [T,H,W] boolean.  Monotone families (threshold masks
        by construction: lower threshold ⊇ higher) upload as a single
        [H*W] uint8 enter-count plane and run as one mono program;
        general families fall back to bit-packed per-chunk programs."""
        masks = np.asarray(masks)
        assert masks.dtype == bool and masks.ndim == 3, (
            "blend_embeddings needs [T,H,W] boolean masks")
        T = masks.shape[0]
        bs = self.batch_size

        mono = (T <= 255
                and bool(np.all(masks[1:] >= masks[:-1])))
        if mono:
            counts = masks.sum(axis=0, dtype=np.uint8).reshape(-1)
            return self.launch_blend_embeddings_counts(
                orig_imT, inpaint_imT, counts, T, norm=norm)
        orig = self._device_put_memo(np.asarray(orig_imT, np.float32))
        inp = self._device_put_memo(np.asarray(inpaint_imT, np.float32))
        bits = np.packbits(masks.reshape(T, -1), axis=1)
        pad = (-T) % bs
        if pad:  # padded rows: all-zero mask -> blend == orig, discarded
            bits = np.concatenate(
                [bits, np.zeros((pad, bits.shape[1]), np.uint8)])
        fn = self._blend_encode_fn()
        bits_d = self._upload(bits)
        out = torch.cat([fn(self.net.params, orig, inp, bits_d[i:i + bs])
                         for i in range(0, T + pad, bs)])[:T]
        return self._finish_embeds(out, norm)

    def launch_blend_embeddings_counts(self, orig_imT, inpaint_imT,
                                       counts, T, norm=True):
        """Monotone-family fast path of :meth:`launch_blend_embeddings`
        taking the [H*W] uint8 enter-count plane directly (counts[p] =
        number of masks containing pixel p; mask t contains p iff
        counts[p] >= T - t).  Callers that derive masks from a threshold
        plane (inpainting-game eval) compute counts with one searchsorted
        instead of materializing the [T,H,W] family."""
        finish = self.launch_blend_embeddings_counts_multi(
            orig_imT, inpaint_imT, np.reshape(counts, (1, -1)), T, norm=norm)
        return lambda: finish()[0]

    def launch_blend_embeddings_counts_multi(self, orig_imT, inpaint_imT,
                                             counts_mat, T, norm=True):
        """Batch M monotone mask families over one probe/twin pair into a
        single blend+encode program (``counts_mat``: [M, H*W] uint8
        enter-count planes).  ``finish()`` returns [M, T, D] embeddings.
        The inpainting-game analysis uses this to evaluate all of a
        probe's saliency methods in one program."""
        M = np.shape(counts_mat)[0]
        return self.launch_blend_embeddings_counts_multi_pair(
            [orig_imT], [inpaint_imT], counts_mat, np.zeros(M, np.int32), T,
            norm=norm)

    def blend_embeddings(self, orig_imT, inpaint_imT, masks, norm=True):
        """Threshold-mask blend + encode on the card (synchronous form of
        :meth:`launch_blend_embeddings`)."""
        return self.launch_blend_embeddings(orig_imT, inpaint_imT, masks,
                                            norm=norm)()

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

    def preprocess_loader(self, images, returnImageIndex=False, repeats=1):
        """Iterate (displayable image, [C,H,W] net input, filename)."""
        from xfr_torch.utils.image import image_loader
        for im, fn in image_loader(images, returnFileName=True,
                                   returnImageIndex=returnImageIndex,
                                   repeats=repeats):
            imT = self.convert_from_numpy(im)
            yield im, imT[0], fn

"""Whitebox saliency API (port of xfr_tpu/ebp/engine.py).

Ported: ``WhiteboxNetwork``; ``Whitebox`` with its compute-dtype knobs,
the pooled mean-EBP walk (``_ebp_pooled_fn``, ``ebp``, ``ebp_batch``), the
contrastive family (single probe, batched and the fused both-maps
launch), the interleaved batch triplet classifier, and the batched
weighted-subtree path (ranking pass, probe-chunked candidate sweep,
select+merge, ``launch_weighted_subtree_ebp_batch``) and the per-probe
``weighted_subtree_ebp`` (its fused, host and ``max_candidates`` paths,
the last over the traced-injection walk); plus ``_mwp_to_saliency``,
``encode``, ``embeddings``, ``convert_from_numpy`` and
``preprocess_loader``.  That is the whitebox 4-map mix of the inpainting
game, batched and serial.  The inpainting game's evaluation stage adds the
blend+encode family: threshold-mask blends of a probe toward its twin,
built and encoded on the card (bit-packed masks, the monotone enter-count
plane, several maps of one pair, several pairs).  The rest of the API
came last: ``layerwise_ebp``, the deprecated
``layerwise_contrastive_ebp`` with its 8 prior modes, ``_prior_ebp``
(the walk under static per-event priors), and the deprecated engine's
``subtree_ebp`` in both percentile modes.

The JAX package jits each program; here each ``_*_fn`` method returns a
plain function that enqueues its work on the current stream, and a
``lax.scan`` becomes a Python loop over its steps.  No launch path reads
a device value on the host before its ``finish()``.  Every float32 EBP
program runs with TF32 off (``precision_scope("high")``, the TPU's
bf16_3x); ``encode`` and the blend+encode programs allow TF32.  On a
card, the encode of a monotone blend+encode step is captured once as a
CUDA graph and replayed for every later step (``replay.run``), so a step
costs the host a few launches instead of one a graph node; so is the
mean-EBP walk STRise's prior takes (``uniform_pooled_ebp``).

The device mesh (``use_mesh``): the JAX package places one global batch
over a mesh from one process.  Here every rank of a ``torch.distributed``
group (one process per card) calls the same entry point with the same
full inputs, runs the single-card body on its own rows (probes, blend
steps, embedding rows, the candidate rows of a per-probe sweep), and
``finish()`` all-gathers the equal, zero-padded shards in global order
and drops the pad rows, so every rank returns the un-meshed result.  A
launch issues no collective; the gather is the finish's.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from xfr_torch import replay as R
from xfr_torch.ebp import interpreter as I
from xfr_torch.graph import GraphDef
from xfr_torch.parallel import mesh as MS
from xfr_torch.utils.device import precision_scope
from xfr_torch.utils.profiling import count, count_replays, span


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
        self.clear()
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
        """Drops the graphs captured of this net's forwards
        (``replay.clear``); the reference clears its hooks' state here, of
        which the functional interpreter keeps none."""
        R.clear(self.graph)


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

        # Optional DeviceMesh (use_mesh): the batched entry points split
        # their rows over its 'dp' axis.
        self.mesh = None
        # per-mesh row orders of the gathered sweeps, keyed by mesh_key
        self._mesh_cache = {}

    @property
    def device(self):
        return self.net.device

    # ------------------------------------------------------------------
    # Device mesh: one process per card, each rank on its rows
    # ------------------------------------------------------------------

    def use_mesh(self, mesh):
        """Attach a ``torch.distributed`` DeviceMesh with a 'dp' dim (None
        detaches).  The params are broadcast from the mesh's first rank
        and stay on this net's device (the mesh's device, "cpu" under
        gloo, only carries the collectives); ``batch_size`` rounds up to a
        'dp' multiple.  Every rank must then call the same entry points
        with the same inputs: each computes its rows and ``finish()``
        gathers them, so every rank returns the un-meshed result."""
        dp = 1 if mesh is None else MS.dp_size(mesh)
        self.mesh = mesh
        if mesh is not None:
            net = self.net
            cls = net.params.get(net.classifier_pname)
            net.params = self._replicated(net.params)
            if net._orig_classifier is cls:
                net._orig_classifier = net.params.get(net.classifier_pname)
            elif net._orig_classifier is not None:
                net._orig_classifier = self._replicated(net._orig_classifier)
            self.batch_size = -(-self.batch_size // dp) * dp
        return self

    @property
    def _dp(self):
        return 1 if self.mesh is None else MS.dp_size(self.mesh)

    def _replicated(self, tree):
        """``tree`` broadcast from the mesh's first rank, on this net's
        device (as it is without a mesh)."""
        if self.mesh is None:
            return tree
        return MS.replicate(self.mesh, tree, device=self.device)

    def _shard_rows(self, x):
        """This rank's rows of ``x`` over 'dp' (the caller makes its
        leading dim a 'dp' multiple); ``x`` itself without a mesh."""
        if self.mesh is None:
            return x
        lo, hi = MS.local_rows(self.mesh, x.shape[0])
        return x[lo:hi]

    def _local_batch(self, x):
        """(params, x) of this rank's probes of a padded probe batch under
        the interleaved batch classifier: rows [lo, hi) of ``x`` and the
        classifier's rows [2lo, 2hi) (each probe's mate and nonmate), so
        the local body is the single-card body with B = hi - lo.  The
        whole (params, x) without a mesh."""
        params = self.net.params
        if self.mesh is None:
            return params, x
        lo, hi = MS.local_rows(self.mesh, x.shape[0])
        pname = self.net.classifier_pname
        params = dict(params)
        params[pname] = {k: v[2 * lo:2 * hi]
                         for k, v in params[pname].items()}
        return params, x[lo:hi]

    def _gathered(self, out, n=None):
        """The finish half of a batched program under a mesh (the JAX
        package's ``_shmap_kernel``): ``out`` is the single-card body's
        output (a tensor or a tuple of them) on this rank's rows; returns
        ``gather()``, which all-gathers every rank's rows of each output
        in global order and keeps the first ``n``.  The collective belongs
        to the caller's ``finish()``.  Without a mesh, ``gather()``
        returns ``out`` cut to ``n`` rows."""
        outs = out if isinstance(out, tuple) else (out,)

        def gather():
            if self.mesh is not None:
                got = tuple(MS.gather_rows(self.mesh, o, n) for o in outs)
            else:
                got = tuple(o if n is None else o[:n] for o in outs)
            return got if isinstance(out, tuple) else got[0]

        return gather

    def _sweep_rows_order(self, n_buckets):
        """Positions of candidate rows 0..n_cand-1 in the gathered outputs
        of a row-sharded sweep (``I.row_shard_order``), cached per mesh."""
        key = ("sweep_rows", MS.mesh_key(self.mesh), n_buckets)
        order = self._mesh_cache.get(key)
        if order is None:
            order = self._mesh_cache[key] = torch.as_tensor(
                I.row_shard_order(self._n_events - 1, n_buckets, self._dp),
                device=self.device)
        return order

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

    def uniform_pooled_ebp(self, params, x):
        """``_ebp_pooled_fn``'s channel-pooled MWP [1, H, W] of the
        [1, C, H, W] float32 input ``x`` from a uniform prior over the
        classes; on a card one replay of its graph (``replay.run``), keyed
        by the walk's subtree mode, bias and eps and the addresses of
        every parameter tensor."""
        walk, n = self._ebp_pooled_fn(), self.net.num_classes()

        def pooled(x):
            Pn = torch.full((1, n), 1.0 / n, dtype=torch.float32,
                            device=x.device)
            return walk(params, x, Pn)[0]

        tag = ("pooled_ebp", self._ebp_subtree_mode, self._ebp_with_bias,
               self.eps)
        ids = (v.data_ptr() for p in params.values() for v in p.values())
        return R.run(pooled, x, self.net.graph, tag, ids)

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

    def _ebp_raw_fn(self, keep):
        """(params, x, Pn) -> {event: P float32} for the ``keep`` events of
        one walk: one row of ``_ebp_multi_cotangent_fn``."""
        multi = self._ebp_multi_cotangent_fn(keep)
        return lambda params, x, Pn: {
            k: v[0] for k, v in multi(params, x, Pn[None]).items()}

    def _ebp_multi_cotangent_fn(self, keep, reduce=None):
        """(params, x, Pns [k,1,K]) -> {event: P [k, ...] float32}: k walks
        sharing one forward capture, as the k rows of one walk (the JAX
        package's vmap over cotangents), in the compute dtype with TF32
        off.  With ``reduce``, each kept event's P (compute dtype) is
        handed to ``reduce(event, P)`` as it fires and its result kept."""
        graph = self.net.graph
        mode, wb, eps = self._ebp_subtree_mode, self._ebp_with_bias, self.eps
        keep = tuple(sorted(k % graph.n_events for k in keep))

        def fn(params, x, Pns):
            with precision_scope("high"):
                params, values, posvals = self._capture(params, x)
                out = I.ebp_backward(
                    graph, params, values, posvals,
                    Pns.to(values[graph.input_id].dtype),
                    subtree_mode=mode, eps=eps, with_bias=wb, keep=keep,
                    reduce=reduce)
            if reduce is not None:
                return out
            return {k: v.float() for k, v in out.items()}

        return fn

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

    def layerwise_ebp(self, img_probe, k_layer, mode="argmax", k_element=None,
                      k_poschannel=0, mwp=True):
        """Layerwise EBP: run EBP under class ``k_poschannel`` to get
        P_mate, build a prior at event ``k_layer`` (its maxima, "argmax",
        or its single flat element ``k_element``, "elementwise"), then
        re-run with that prior and a zero output cotangent."""
        if mode not in ("argmax", "elementwise"):
            raise ValueError('invalid layerwise EBP mode "%s"' % mode)
        x = self._as_input(img_probe)
        kl = k_layer % self._n_events
        base = self._ebp_raw_fn((kl,))(self.net.params, x,
                                       self._onehot(k_poschannel))
        Pk = base[kl].cpu().numpy().astype(np.float32)
        if mode == "argmax":
            prior = Pk * (Pk == Pk.max()).astype(np.float32)
        else:
            assert k_element is not None
            prior = np.zeros(Pk.size, np.float32)
            prior[k_element] = Pk.flat[k_element]
            prior = prior.reshape(Pk.shape)
        return self._prior_ebp(x, {kl: prior}, mwp=mwp)

    def _prior_ebp(self, x, priors, mwp=False):
        """EBP with a zero output cotangent and static per-event priors
        ({event: array or tensor of the event's [1, ...] shape}), in the
        params' dtype with TF32 off.  Returns the channel-pooled MWP of
        event n_events-2 on the host, or its saliency map."""
        graph = self.net.graph
        mode, wb, eps = self._ebp_subtree_mode, self._ebp_with_bias, self.eps
        kk = self._n_events - 2
        with precision_scope("high"):
            # float32 is no cast: the walk keeps the params' dtype
            params, values, posvals = self._capture(self.net.params, x,
                                                    torch.float32)
            y = values[graph.output_id]
            pri = {k: torch.as_tensor(v, device=y.device)
                   for k, v in priors.items()}
            out = I.ebp_backward(
                graph, params, values, posvals, y.new_zeros((1,) + y.shape),
                subtree_mode=mode, eps=eps, with_bias=wb, keep=(kk,),
                priors=pri)
        P = out[kk][0].float().sum(dim=1)
        P = np.squeeze(P.cpu().numpy()).astype(np.float32)
        return self._mwp_to_saliency(P) if not mwp else P

    def layerwise_contrastive_ebp(self, img_probe, k_poschannel, k_negchannel,
                                  k_layer, mode="copy", percentile=80,
                                  k_element=None, gradlayer=None, mwp=False):
        """Deprecated layerwise contrastive EBP.  The mate and nonmate MWPs
        of event ``k_layer`` (one walk, two cotangent rows) give the
        contrast C = relu(P_mate - P_nonmate); the prior at that event is
        built on the host by ``mode``: copy (C), mean ((P_mate + C)/2),
        product (sqrt(P_mate*C) in float64), argmax (C at its maxima),
        percentile (C where P_mate's ascending stable cumulative mass
        reaches ``percentile``%), percentile_argmax (that, at its maxima),
        argmax_product (the product at its maxima), elementwise (C at
        ``k_element``).  Then EBP re-runs under the prior."""
        import warnings
        warnings.warn("layerwise_contrastive_ebp is deprecated, use "
                      "weighted_subtree_ebp instead")
        x = self._as_input(img_probe)
        Pns = torch.stack([self._onehot(k_poschannel),
                           self._onehot(k_negchannel)])
        kl = k_layer % self._n_events
        out = self._ebp_multi_cotangent_fn((kl,))(self.net.params, x, Pns)
        P = out[kl].cpu().numpy().astype(np.float32)
        Pm, Pn_ = P[0], P[1]
        C = np.maximum(Pm - Pn_, 0)

        if mode == "copy":
            prior = C
        elif mode == "mean":
            prior = 0.5 * (Pm + C)
        elif mode == "product":
            prior = np.sqrt(Pm.astype(np.float64) *
                            C.astype(np.float64)).astype(np.float32)
        elif mode == "argmax":
            prior = C * (C == C.max()).astype(np.float32)
        elif mode in ("percentile", "percentile_argmax"):
            assert 0 <= percentile <= 100
            flat = Pm.flatten()
            order = np.argsort(flat, kind="stable")
            csum = np.cumsum(flat[order])
            m = np.zeros_like(flat)
            m[order] = (csum >= (percentile / 100.0) * csum[-1]).astype(
                np.float32)
            prior = m.reshape(Pm.shape) * C
            if mode == "percentile_argmax":
                prior = prior * (prior == prior.max()).astype(np.float32)
        elif mode == "argmax_product":
            pr = np.sqrt(Pm.astype(np.float64) *
                         C.astype(np.float64)).astype(np.float32)
            prior = pr * (pr == pr.max()).astype(np.float32)
        elif mode == "elementwise":
            prior = np.zeros(C.size, np.float32)
            prior[k_element] = C.flat[k_element]
            prior = prior.reshape(C.shape)
        else:
            raise ValueError('unknown contrastive ebp mode "%s"' % mode)

        return self._prior_ebp(x, {kl: prior}, mwp=mwp)

    # ------------------------------------------------------------------
    # Subtree EBP (the deprecated engine's method)
    # ------------------------------------------------------------------

    @staticmethod
    def _subtree_prior(P, percentile):
        """One event's truncated-contrastive prior from its mate/nonmate
        MWPs P [2, 1, ...]: the contrast relu(P_mate - P_nonmate) where the
        mate's percentile-mass mask keeps it."""
        Pm = P[0]
        C = torch.clamp(Pm - P[1], min=0.0)
        return _percentile_mass_mask(Pm, percentile) * C

    def _subtree_rank_fn(self, argmax):
        """Per-event truncated-contrastive prior construction for
        ``subtree_ebp``, each event reduced as its MWPs fire (the JAX
        package keeps every event's two MWPs in one program): the
        percentile-mass masked contrast prior and the reference's
        peakiness score ``max(prior / (1e-12 + sum(prior))) * numel``.

        argmax=True: (params, x, Pns, percentile) -> (elems, vals, scores,
        ties) [n_events-1] each, the prior's first maximum, its value, the
        score of the prior that keeps all tied maxima (v / (ties*v) *
        numel) and the tie count, for the static event-order sweep.
        argmax=False: -> (per-event priors, scores) for the serial
        full-prior path."""
        cand = tuple(range(self._n_events - 1))

        def fn(params, x, Pns, percentile):
            def reduce(_, P):
                pr = self._subtree_prior(P, percentile)
                flat = pr.reshape(-1)
                if not argmax:
                    return pr, (flat.amax() / (1e-12 + flat.sum())) * \
                        flat.numel()
                el = flat.argmax()  # ties go to the first index
                v = flat[el]
                nt = (flat == v).sum()
                return (el, v, (v / (1e-12 + v * nt.to(v.dtype)))
                        * flat.numel(), nt)

            out = self._ebp_multi_cotangent_fn(cand, reduce)(params, x, Pns)
            if not argmax:
                return (tuple(out[k][0] for k in cand),
                        torch.stack([out[k][1] for k in cand]))
            return tuple(torch.stack([out[k][i] for k in cand])
                         for i in range(4))

        return fn

    def _subtree_tied_prior_fn(self, k):
        """(params, x, Pns, percentile) -> event ``k``'s prior with every
        tied maximum kept (value v at each): the exact-ties fallback of the
        subtree_ebp sweep."""

        def fn(params, x, Pns, percentile):
            def reduce(_, P):
                pr = self._subtree_prior(P, percentile)
                m = pr.amax()
                return torch.where(pr == m, m, 0.0)

            return self._ebp_multi_cotangent_fn((k,), reduce)(
                params, x, Pns)[k]

        return fn

    def subtree_ebp(self, img_probe, k_poschannel, k_negchannel,
                    percentile=20, mode="percentile_argmax", topk=1):
        """Subtree EBP, the deprecated engine's method.

        Truncated contrastive EBP injected at every candidate event
        (0..n_events-2); each candidate scored by the peakiness of its
        injected prior (``max(prior/sum(prior)) * numel``), the score of a
        candidate whose saliency plane is all zero set to 0; the last
        ``topk`` by stable ascending argsort are kept and their
        blurred+normalized planes summed, then sum-normalized (float ebp
        versions) or uint8-normalized.

        mode='percentile_argmax' (the default) runs the batched
        static-event-order sweep over the priors' first maxima, and
        recomputes an event whose prior has several tied maxima exactly
        with all of them.  mode='percentile' injects each event's full
        prior in its own walk (one walk per candidate).

        A quirk of the reference, not reproduced: under x64 the JAX
        package's mode='percentile' raises ``ValueError: assignment
        destination is read-only`` whenever a candidate's map is all zero
        (``xfr_tpu/ebp/engine.py:858-863`` writes into the read-only view
        ``np.asarray`` returns of a float64 device array; float32 converts
        and copies, so float32 runs never hit it).  The port copies the
        scores and sets that candidate's score to 0.

        Returns ``(smap, scores of the kept candidates, k_subtree)`` with
        k_subtree in ascending-score order."""
        if "percentile" not in mode:
            raise AssertionError("subtree_ebp requires a percentile mode")
        x = self._as_input(img_probe)
        Pns = torch.stack([self._onehot(k_poschannel),
                           self._onehot(k_negchannel)])
        params, pct = self.net.params, float(percentile)

        if mode == "percentile_argmax":
            elems, vals, scores, ties = self._subtree_rank_fn(True)(
                params, x, Pns, pct)
            P_img_dev, maxes = self._wsebp_sweep_fn()(params, x, elems, vals)
            scores = scores.cpu().numpy().astype(np.float64)
            maxes = maxes.cpu().numpy().copy()  # tied events update it
            # the reference's argmax keeps ALL tied maxima; the sweep
            # injects one element, so an event with ties is recomputed
            # exactly with its full tied prior
            tied = np.where((ties.cpu().numpy() > 1)
                            & (vals.cpu().numpy().astype(np.float64) > 0))[0]
            tied_maps = {}
            for k in tied:
                prior = self._subtree_tied_prior_fn(int(k))(params, x, Pns,
                                                            pct)
                P = self._prior_ebp(x, {int(k): prior}, mwp=True)
                maxes[k] = P.max()
                tied_maps[int(k)] = self._mwp_to_saliency(P)
            # MWP planes are non-negative: plane max > 0 iff the blurred
            # saliency map is non-zero
            scores = scores * (maxes > 0)
            k_subtree = [int(k) for k in
                         np.argsort(scores, kind="stable")[-topk:]]
            sel = P_img_dev[torch.as_tensor(k_subtree, device=self.device)]
            sel = sel.cpu().numpy().astype(np.float32)
            maps = [tied_maps.get(k, self._mwp_to_saliency(m[0]))
                    for k, m in zip(k_subtree, sel)]
        else:
            priors, scores = self._subtree_rank_fn(False)(params, x, Pns,
                                                          pct)
            scores = scores.cpu().numpy().astype(np.float64)
            maps_all = []
            for k in range(self._n_events - 1):
                P = self._prior_ebp(x, {k: priors[k]}, mwp=True)
                if P.max() <= 0:
                    scores[k] = 0.0
                maps_all.append(self._mwp_to_saliency(P))
            k_subtree = [int(k) for k in
                         np.argsort(scores, kind="stable")[-topk:]]
            maps = [maps_all[k] for k in k_subtree]

        smap = np.sum(np.stack(maps, axis=0), axis=0)
        if self.convert_saliency_uint8:
            smap = self._float32_to_uint8(smap)
        else:
            smap = smap / max(smap.sum(), self.eps)
        return smap, [float(scores[k]) for k in k_subtree], k_subtree

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
        copied there (a copy that waits for the card's queue).

        Under a mesh, B is padded up to a multiple of the 'dp' size with
        zero rows (padded probes give discarded zero maps) so the batch
        splits evenly; returns the padded B."""
        dev = self.device
        m = torch.as_tensor(x_mates, dtype=torch.float32, device=dev)
        n = torch.as_tensor(x_nonmates, dtype=torch.float32, device=dev)
        B, D = m.shape
        pad = (-B) % self._dp
        if pad:
            m = torch.cat([m, m.new_zeros((pad, D))])
            n = torch.cat([n, n.new_zeros((pad, D))])
        w = torch.stack([m, n], dim=1).reshape(2 * (B + pad), D)
        self.net.params = dict(self.net.params)
        self.net.params[self.net.classifier_pname] = {"w": w}
        self.net._num_classes = 2 * (B + pad)
        return B + pad

    def _pad_probe_batch(self, x):
        """The probe batch as float32 on the card, padded with zero probes
        to the installed batch classifier's width (only under a mesh,
        where that width is B rounded up to a 'dp' multiple; otherwise B
        must equal it).  Returns (padded batch, B)."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        B = x.shape[0]
        Bc = self.net.num_classes() // 2
        if not (B == Bc or (self.mesh is not None and B < Bc)):
            raise ValueError(
                "call set_triplet_classifier_batch matching the probe batch "
                f"(B={B}, classifier for {Bc})")
        if B < Bc:
            x = torch.cat([x, x.new_zeros((Bc - B,) + tuple(x.shape[1:]))])
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
        params, xl = self._local_batch(x)
        pooled, P_full = self._gathered(self._ebp_pooled_fn()(
            params, xl, self._batch_cotangents(xl.shape[0], "mean")), n=B)()
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
        params, xl = self._local_batch(x)
        mwp = self._gathered(self._contrastive_batch_fn(
            truncate_percent is not None)(
            params, xl, self._batch_cotangents(xl.shape[0], "contrastive"),
            float(truncate_percent or 0.0)), n=B)()
        mwp = mwp.cpu().numpy().astype(np.float32)
        return [self._mwp_to_saliency(mwp[i]) for i in range(B)]

    def _contrastive_both_fn(self):
        """Contrastive AND truncated-contrastive maps from ONE
        forward-capture pair and one two-row backward walk (the two
        variants differ only in the final combine): (params, x, Pns,
        percentile) -> ([B,H,W], [B,H,W])."""
        both = self._contrastive_pair_fn(("contrastive", "truncated"))
        return lambda *a: tuple(both(*a))

    def launch_contrastive_ebp_batch_both(self, x, truncate_percent=20):
        """Enqueue the batched contrastive+truncated program and return a
        ``finish()`` closure producing (contrastive maps, truncated maps).
        Nothing waits for the card before ``finish()``, which gathers the
        ranks' rows under a mesh."""
        x, B = self._pad_probe_batch(x)
        params, xl = self._local_batch(x)
        gather = self._gathered(self._contrastive_both_fn()(
            params, xl, self._batch_cotangents(xl.shape[0], "contrastive"),
            float(truncate_percent)), n=B)

        def finish():
            contr_dev, trunc_dev = gather()
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

    def _wsebp_rank(self, params, x, gating, cotangents):
        """The ranking pass's body, for a probe batch of B >= 1: per-probe
        subtree scores, argmaxes and injection values [B, n_events-1] each.

        ``cotangents(y)`` gives, from the forward output y [B, K], the
        natural backward's two cotangent rows [2, B, K] (mate, or softmax
        cross-entropy without gating, then nonmate) and the mate cotangent
        [B, K] of the EBP walk.  One natural backward walks the two rows;
        each event's dA pair is reduced to its gated max and first argmax
        as it fires.  One EBP walk under the mate cotangent then picks
        P_mate[k] at each event's argmax.  Always float32 with TF32 off,
        whatever compute_dtype is."""
        graph = self.net.graph
        mode, wb, eps = self._ebp_subtree_mode, self._ebp_with_bias, self.eps
        cand = tuple(range(graph.n_events - 1))
        with precision_scope("high"):
            B = x.shape[0]
            params, values, posvals = self._capture(params, x, torch.float32)
            cots, cot_pos = cotangents(values[graph.output_id])

            def gate(_, dA):
                a, b = dA[0], dA[1]
                gated = ((a >= 0) * (-b)) if gating else ((a < 0) * (-b))
                flat = gated.reshape(B, -1)
                # ties (the plane is full of exact zeros) go to the first
                # index, as jnp.argmax does
                return flat.amax(dim=1), flat.argmax(dim=1)

            ranked = I.natural_backward(graph, params, values, cots,
                                        keep=cand, reduce=gate)
            scores = torch.stack([ranked[k][0] for k in cand], 1)
            idxs = torch.stack([ranked[k][1] for k in cand], 1)

            def pick(k, P):
                return P[0].reshape(B, -1).gather(1, idxs[:, k:k + 1])[:, 0]

            picked = I.ebp_backward(
                graph, params, values, posvals, cot_pos[None],
                subtree_mode=mode, eps=eps, with_bias=wb, keep=cand,
                reduce=pick)
            vals = torch.stack([picked[k] for k in cand], 1)
        return scores, idxs, vals

    def _wsebp_grad_fn(self):
        """(params, x [1,...], Pn_pos [1,K], gating) -> one probe's subtree
        scores, argmaxes and injection values [n_events-1] each: the
        per-probe ranking pass.  The natural backward's cotangents select
        classifier rows 0 (mate) and 1 (nonmate), or without gating the
        softmax cross-entropy over every class against row 0; ``Pn_pos``
        seeds the EBP walk.  The one-hot rows are built by a comparison on
        the card (no indexed write of a host scalar, which would wait for
        it)."""

        def fn(params, x, Pn_pos, gating):
            def cotangents(y):
                K = y.shape[1]
                hot = (torch.arange(K, device=y.device)[None] ==
                       torch.arange(2, device=y.device)[:, None]).to(y.dtype)
                cot_m, cot_n = hot[:1], hot[1:]
                if not gating:
                    cot_m = torch.softmax(y, dim=-1) - cot_m
                return torch.stack([cot_m, cot_n]), Pn_pos.to(y.dtype)

            scores, idxs, vals = self._wsebp_rank(params, x, gating,
                                                  cotangents)
            return scores[0], idxs[0], vals[0]

        return fn

    def _wsebp_grad_batch_fn(self):
        """(params, x, gating) -> per-probe subtree scores, argmaxes and
        injection values [B, n_events-1] each, for a probe batch under the
        interleaved [2B, D] triplet classifier: the batched ranking pass.
        Each probe's cotangents select its own two classifier rows; without
        gating, the softmax runs over each probe's own two logits."""

        def fn(params, x, gating):
            def cotangents(y):
                B = y.shape[0]
                eye = torch.eye(B, dtype=y.dtype, device=y.device)
                cot_m, cot_n = _interleave_rows(eye)
                if gating:
                    return torch.stack([cot_m, cot_n]), cot_m
                # per-probe softmax over each probe's own two logits
                pair = torch.diagonal(y.reshape(B, B, 2), 0, 0, 1).T
                sm = torch.softmax(pair, dim=-1)
                ce_m, _ = _interleave_rows(eye * (sm[:, :1] - 1.0))
                _, ce_n = _interleave_rows(eye * sm[:, 1:])
                return torch.stack([ce_m + ce_n, cot_n]), cot_m

            return self._wsebp_rank(params, x, gating, cotangents)

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
        batch-B forward-capture pair.  Under a mesh each rank runs both
        stages on its probes, the sweep at probe chunk 1 with the cascade
        on (the JAX package's ``_wsebp_sweep_select_shmap_fn``), and
        ``finish()`` gathers them."""
        x_pad, B = self._pad_probe_batch(x)
        params, xl = self._local_batch(x_pad)
        chunk = None if self.mesh is None else 1
        prev_mode = self._ebp_subtree_mode
        self._ebp_subtree_mode = subtree_mode
        try:
            scores_d, idxs_d, vals_d = self._wsebp_grad_batch_fn()(
                params, xl, gating=bool(do_mated_similarity_gating))
            merged_d, sel_d = self._wsebp_sweep_select_scan_fn(
                topk, bool(do_max_subtree), probe_chunk=chunk)(
                params, xl, idxs_d.to(torch.int32), vals_d, scores_d)
            gather = self._gathered((scores_d, merged_d, sel_d), n=B)
        finally:
            self._ebp_subtree_mode = prev_mode

        def finish():
            scores_d, merged_d, sel_d = gather()
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

        Returns a list of (smap, P_img_valid, P_subtree_valid,
        k_subtree_valid) tuples.  ``return_subtree_maps=True`` reads the
        ranking pass on the host and runs each probe through the per-probe
        host path (``_wsebp_post``), which also returns the selected
        subtrees' maps; otherwise P_img_valid is []."""
        if not return_subtree_maps:
            return self.launch_weighted_subtree_ebp_batch(
                x, topk=topk, verbose=verbose, do_max_subtree=do_max_subtree,
                do_mated_similarity_gating=do_mated_similarity_gating,
                subtree_mode=subtree_mode,
                do_mwp_to_saliency=do_mwp_to_saliency)()
        x, B = self._pad_probe_batch(x)
        params, xl = self._local_batch(x)
        prev_mode = self._ebp_subtree_mode
        self._ebp_subtree_mode = subtree_mode
        try:
            scores_d, idxs_d, vals_d = self._gathered(
                self._wsebp_grad_batch_fn()(
                    params, xl, bool(do_mated_similarity_gating)), n=B)()
            scores = scores_d.cpu().numpy().astype(np.float32)
            idxs = idxs_d.cpu().numpy()
            vals = vals_d.cpu().numpy().astype(np.float32)
            return [self._wsebp_post(
                        x[i:i + 1], scores[i], idxs[i], vals[i], topk,
                        verbose, do_max_subtree, do_mwp_to_saliency, None,
                        return_subtree_maps)
                    for i in range(B)]
        finally:
            self._ebp_subtree_mode = prev_mode

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
    # Weighted subtree EBP, one probe
    # ------------------------------------------------------------------

    def weighted_subtree_ebp(self, img_probe, k_poschannel, k_negchannel,
                             topk=1, verbose=False, do_max_subtree=False,
                             do_mated_similarity_gating=True,
                             subtree_mode="norelu", do_mwp_to_saliency=True,
                             max_candidates=None, return_subtree_maps=True):
        """Weighted subtree EBP for one probe under the installed 2-class
        triplet classifier.

        The ranking pass gates every backward event to score its subtree;
        then every candidate's prior-injected EBP walk runs as one row of
        a batched walk, and the last ``topk`` valid candidates in score
        order are merged.  ``max_candidates`` walks only that many of the
        top-ranked candidates (None: all n_events-1).  Three paths:

        * fused (``max_candidates`` None, ``return_subtree_maps`` False):
          sweep, selection and merge on the device, one read of the
          result;
        * host (``return_subtree_maps`` True): the full sweep, the
          selection on the host from the per-candidate maxima, the merge
          on the device; also returns the selected subtrees' maps;
        * ``max_candidates``: the traced-injection walk over the chosen
          candidates, then the host path's selection and merge.

        Returns (smap, P_img_valid, P_subtree_valid, k_subtree_valid);
        P_img_valid is [] unless ``return_subtree_maps``."""
        prev_mode = self._ebp_subtree_mode
        self._ebp_subtree_mode = subtree_mode
        try:
            return self._weighted_subtree_ebp(
                img_probe, k_poschannel, k_negchannel, topk, verbose,
                do_max_subtree, do_mated_similarity_gating,
                do_mwp_to_saliency, max_candidates, return_subtree_maps)
        finally:
            self._ebp_subtree_mode = prev_mode

    def _weighted_subtree_ebp(self, img_probe, k_poschannel, k_negchannel,
                              topk, verbose, do_max_subtree,
                              do_mated_similarity_gating, do_mwp_to_saliency,
                              max_candidates, return_subtree_maps=True):
        x = self._as_input(img_probe)
        Pn_pos = self._onehot(k_poschannel)
        scores, idxs, vals = self._wsebp_grad_fn()(
            self.net.params, x, Pn_pos, bool(do_mated_similarity_gating))
        return self._wsebp_post(
            x, scores.cpu().numpy().astype(np.float32), idxs.cpu().numpy(),
            vals.cpu().numpy().astype(np.float32), topk, verbose,
            do_max_subtree, do_mwp_to_saliency, max_candidates,
            return_subtree_maps)

    def _wsebp_inject_fn(self, start_node=None):
        """(params, x, ev_ids, elems, vals) -> (P_img [R,1,H,W] float32,
        maxes [R]): the prior-injected EBP walks of R candidates, each
        injecting its value at its flat element of its event, as the R
        rows of one walk with a zero output cotangent (the JAX package's
        ``jax.vmap`` over candidates).

        ``start_node`` truncates the walk: with a zero output cotangent the
        gradient above the injection point is identically zero, so
        candidates that all fire at nodes <= start_node skip the deeper
        vjps."""
        graph = self.net.graph
        mode, wb, eps = self._ebp_subtree_mode, self._ebp_with_bias, self.eps
        kk = graph.n_events - 2
        sweep_dt = self._wsebp_dtype

        def fn(params, x, ev_ids, elems, vals):
            with precision_scope("high"):
                params, values, posvals = self._capture(params, x, sweep_dt)
                dtype = values[graph.input_id].dtype
                y = values[graph.output_id]
                zero_cot = y.new_zeros((ev_ids.shape[0],) + tuple(y.shape))
                out = I.ebp_backward(
                    graph, params, values, posvals, zero_cot,
                    subtree_mode=mode, eps=eps, with_bias=wb, keep=(kk,),
                    inject_spec=(ev_ids, elems, vals.to(dtype)),
                    start_node=start_node)
            P_img = out[kk].sum(dim=2, dtype=torch.float32)  # [R, 1, H, W]
            # only the per-candidate maxima are read on the host; the maps
            # stay on the device
            return P_img, P_img.amax(dim=(1, 2, 3))

        return fn

    def _wsebp_sweep_fn(self, n_buckets=12):
        """(params, x, elems, vals) -> (P_img [n_cand,1,H,W], maxes
        [n_cand]): the full-candidate sweep in static event order (row k
        is event k), the batched walk ``I.ebp_backward_allevents`` without
        the selection.  Under a mesh each rank walks its share of every
        bucket's rows (cascade off, as in the JAX package's rows-over-'dp'
        sweep) and the rows are gathered back into event order."""
        graph = self.net.graph
        mode, wb, eps = self._ebp_subtree_mode, self._ebp_with_bias, self.eps
        sweep_dt = self._wsebp_dtype
        mesh = self.mesh
        casc = bool(self.wsebp_cascade) and mesh is None
        shard = None if mesh is None else (
            mesh.get_local_rank("dp"), self._dp)

        def fn(params, x, elems, vals):
            with precision_scope("high"):
                params, values, posvals = self._capture(params, x, sweep_dt)
                P_out, maxes = I.ebp_backward_allevents(
                    graph, params, values, posvals, elems,
                    vals.to(values[graph.input_id].dtype), subtree_mode=mode,
                    eps=eps, with_bias=wb, n_buckets=n_buckets,
                    cascade=casc, row_shard=shard)
            if mesh is None:
                return P_out, maxes
            order = self._sweep_rows_order(n_buckets)
            return (MS.gather_rows(mesh, P_out)[order],
                    MS.gather_rows(mesh, maxes)[order])

        return fn

    def _wsebp_sweep_select_fn(self, topk, do_max, n_buckets=12):
        """(params, x, elems, vals, scores) -> (merged [H,W], sel
        [n_cand]): one probe's full sweep, valid-subtree selection and
        weighted merge in one program, the batched sweep's body with one
        probe.  Under a mesh, the row-sharded sweep, gathered, then the
        selection and merge."""
        if self.mesh is not None:
            sweep = self._wsebp_sweep_fn(n_buckets)
            eps = self.eps

            def fn(params, x, elems, vals, scores):
                P_out, maxes = sweep(params, x, elems, vals)
                return _wsebp_select_merge(P_out, maxes, scores, topk,
                                           do_max, eps)

            return fn
        batched = self._wsebp_sweep_select_scan_fn(topk, do_max, n_buckets,
                                                   probe_chunk=1)

        def fn(params, x, elems, vals, scores):
            merged, sel = batched(params, x, elems[None], vals[None],
                                  scores[None])
            return merged[0], sel[0]

        return fn

    def _wsebp_fused_launch(self, x, elems, vals, scores, topk,
                            do_max_subtree):
        """Enqueue one probe's fused sweep+select+merge program; returns
        device tensors without waiting for the card."""
        return self._wsebp_sweep_select_fn(topk, bool(do_max_subtree))(
            self.net.params, x, elems, vals, scores)

    def _wsebp_buckets(self, n_buckets=6):
        """Static partition of candidate events 0..n_events-2 into buckets
        by fire node, each with its truncation start_node (the largest
        node in the bucket): ((start_node, events), ...)."""
        graph = self.net.graph
        ev_node = graph.event_node
        cand = sorted(range(graph.n_events - 1), key=lambda e: ev_node[e])
        n_buckets = min(n_buckets, len(cand))
        size = -(-len(cand) // n_buckets)
        return tuple((max(ev_node[e] for e in cand[o:o + size]),
                      tuple(cand[o:o + size]))
                     for o in range(0, len(cand), size))

    def _wsebp_merge_fn(self, do_max):
        """(P_img, sel, weights) -> (merged [H,W], maps): gather the
        selected subtree maps, weight each max-normalized map by its
        normalized subtree score, merge by sum or max, on the device."""

        def fn(P_img, sel, weights):
            maps = P_img[sel]  # [m, 1, H, W]
            norm = maps * (1.0 / (maps.amax(dim=(1, 2, 3), keepdim=True)
                                  + 1e-12))
            weighted = weights[:, None, None, None] * norm
            merged = weighted.amax(dim=0) if do_max else weighted.sum(dim=0)
            return merged[0], maps

        return fn

    def _wsebp_post(self, x, P_subtree, P_subtree_idx, inj_vals, topk,
                    verbose, do_max_subtree, do_mwp_to_saliency,
                    max_candidates, return_subtree_maps):
        """From one probe's host ranking (scores, argmaxes, injection
        values, numpy), the sweep, selection and merge of the three paths
        of ``weighted_subtree_ebp``."""
        dev = self.device
        n_ev = self._n_events

        def up(a, dtype):
            return torch.as_tensor(np.asarray(a, dtype), device=dev)

        if max_candidates is None and not return_subtree_maps:
            smap_dev, sel_dev = self._wsebp_fused_launch(
                x, up(P_subtree_idx, np.int32), up(inj_vals, np.float32),
                up(P_subtree, np.float32), topk, do_max_subtree)
            return self._wsebp_fused_finish(
                smap_dev.cpu().numpy().astype(np.float32),
                sel_dev.cpu().numpy(), P_subtree, verbose,
                do_mwp_to_saliency)

        # candidates in ascending score order, as the reference's argsort;
        # it then keeps the last topk valid entries
        k_order = np.argsort(P_subtree, kind="stable")
        if max_candidates is not None:
            k_order = k_order[-int(max_candidates):]
            # the walk starts at the deepest candidate's node: above it the
            # zero cotangent carries nothing
            start = max(self.net.graph.event_node[int(k)] for k in k_order)
            P_img_dev, maxes = self._wsebp_inject_fn(start)(
                self.net.params, x, up(k_order, np.int32),
                up(P_subtree_idx[k_order], np.int32),
                up(inj_vals[k_order], np.float32))
            row = {int(e): i for i, e in enumerate(k_order)}
        else:
            P_img_dev, maxes = self._wsebp_sweep_fn()(
                self.net.params, x, up(P_subtree_idx, np.int32),
                up(inj_vals, np.float32))
            row = None
        maxes = maxes.cpu().numpy()  # the maps stay on the device

        if verbose:
            for k in k_order:
                print("[weighted_subtree_ebp][%d]: layername=%s, grad=%f"
                      % (k, self.P_layername[k], P_subtree[k]))

        # valid subtrees: map max > 0, and never event 1 (the Multiply
        # layer's event on STR-Janus)
        if row is None:
            max_of_event = maxes
        else:
            max_of_event = np.zeros(n_ev - 1, maxes.dtype)
            max_of_event[k_order] = maxes
        k_subtree_valid = [int(k) for k in k_order
                           if max_of_event[k] > 0 and k != 1][-topk:]
        if len(k_subtree_valid) == 0:
            raise RuntimeError(
                "Failed to calculate valid subtrees. The ebp subtree mode "
                "(%s) may not be supported by this type of network. You may "
                'want to try the "affineonly_with_prior" ebp subtree mode.'
                % self._ebp_subtree_mode)
        P_subtree_valid = [float(P_subtree[k]) for k in k_subtree_valid]
        norm = self._scale_normalized(P_subtree_valid)
        if np.sum(norm) == 0:
            norm = np.ones_like(P_subtree_valid)

        rows = [k if row is None else row[k] for k in k_subtree_valid]
        sel_maps = P_img_dev[up(rows, np.int64)]
        smap_dev, maps_dev = self._wsebp_merge_fn(bool(do_max_subtree))(
            sel_maps, torch.arange(len(rows), device=dev),
            up(norm, np.float32))
        smap = smap_dev.cpu().numpy().astype(np.float32)
        P_img_valid = ([np.squeeze(p).astype(np.float32)
                        for p in maps_dev.cpu().numpy()]
                       if return_subtree_maps else [])

        if self.convert_saliency_uint8:
            smap = self._float32_to_uint8(smap)
        else:
            smap = smap / max(smap.sum(), self.eps)
        return (
            self._mwp_to_saliency(smap) if do_mwp_to_saliency else smap,
            [self._mwp_to_saliency(P) if do_mwp_to_saliency else P
             for P in P_img_valid],
            P_subtree_valid,
            k_subtree_valid)

    # ------------------------------------------------------------------
    # Embeddings
    # ------------------------------------------------------------------

    def encode(self, x):
        """Embedding forward for a [N,C,H,W] input batch (TF32 allowed, the
        TPU's default precision).  Under a mesh, a batch of a 'dp'
        multiple splits its rows over 'dp' and the embeddings are
        gathered (a collective every rank must join)."""
        x = self._as_input(x)
        if x.shape[0] % self._dp:  # whole on every rank
            return self._encode_rows(x, x.shape[0])
        return self._gathered(self._encode_rows(self._shard_rows(x),
                                                x.shape[0]))()

    def _encode_rows(self, x, bs):
        """Embeddings of ``x`` in batches of ``bs``, TF32 allowed."""
        with precision_scope(None):
            return torch.cat([self.net.encode(x[i:i + bs])
                              for i in range(0, x.shape[0], bs)])

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
        # under a mesh, this rank's contiguous rows in batches of bs / dp
        embeds = self._gathered(self._encode_rows(
            self._shard_rows(imagesT), bs // self._dp), n=n)()
        embeds = embeds.cpu().numpy()

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
    # rows past T included, into one preallocated output.  On a card the
    # monotone steps replay one captured encode (``replay.run``).

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
        encode, and write the rows into the step's block of the output.

        On a card the blend is copied into the static input of the
        captured encode of a [bs, C, H, W] batch, the graph is replayed and
        its static output copied into the step's block, all on the current
        stream (``replay.run``): the next step, or the next launch while
        this one's ``finish()`` has not read ``out``, overwrites the static
        buffers only after that copy.  Each replay counts a step in
        ``xfr.eval.graph_replays``.  Elsewhere each step's blend is encoded
        eagerly.

        local(params, origs [P,C,H,W], inps, counts [M, H*W] uint8,
        steps) -> out [len(steps) * bs, D] in step order, allocated once
        the first step has given D."""
        graph, enc = self.net.graph, self.net.encode_tensor

        def local(params, origs, inps, counts, steps):
            c_all = counts.to(torch.int32)
            rows = torch.arange(bs, dtype=torch.int32,
                                device=counts.device)[:, None]
            ids = tuple(I.param_ids(graph, params, enc))

            def encode(x):
                count_replays("xfr.eval.graph_replays")
                e = I.forward_clean(graph, params, x, keep=(enc,))[enc]
                return e.reshape(x.shape[0], -1)

            out = None
            with precision_scope(None):
                for i, (m, t0, p) in enumerate(steps):
                    with span("xfr.eval.blend"):
                        blends = _threshold_blend(c_all[m][None], t0, T,
                                                  origs[p], inps[p], rows)
                    e = R.run(encode, blends, graph, "eval_step", ids)
                    if out is None:
                        out = e.new_empty((len(steps) * bs, e.shape[1]))
                    out[i * bs:(i + 1) * bs] = e
            return out

        return local

    def _launch_counts_steps(self, origs, inps, counts_mat, pair_idx, T,
                             norm):
        """Every mono program's launch: map m runs ceil(T/bs) steps of bs
        rows, bs = min(blend_batch, ceil(T/batch_size)*batch_size), in
        map-major order; rows past T encode the pure original and are
        dropped.  Under a mesh the flat step list is padded to a 'dp'
        multiple with steps at t0 >= T (pure originals, discarded) and
        each rank runs its contiguous run of steps.  ``finish()`` returns
        [M, T, D] embeddings."""
        M = counts_mat.shape[0]
        bs = min(self.blend_batch, -(-T // self.batch_size) * self.batch_size)
        nchunk = -(-T // bs)
        steps = [(m, t0, int(pair_idx[m])) for m in range(M)
                 for t0 in range(0, nchunk * bs, bs)]
        n = len(steps)
        steps += [(0, nchunk * bs, 0)] * ((-n) % self._dp)
        count("xfr.eval.steps", len(steps))
        count("xfr.eval.rows_encoded", len(steps) * bs)
        count("xfr.eval.rows_needed", M * T)
        if self.mesh is not None:
            lo, hi = MS.local_rows(self.mesh, len(steps))
            steps = steps[lo:hi]
        with span("xfr.eval.encode"):
            gather = self._gathered(
                self._blend_encode_mono_multi_local(T, bs)(
                    self.net.params, origs, inps, self._upload(counts_mat),
                    steps), n=n * bs)

        def finish():
            out = gather().reshape(M, nchunk * bs, -1)[:, :T]
            return self._finish_embeds(out, norm)()

        return finish

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
        [M, T, D] embeddings.  A meshed net refuses it, as the JAX
        package does."""
        if self.mesh is not None:
            raise ValueError("launch_blend_embeddings_counts_multi_pair "
                             "has no mesh form: detach the mesh")
        counts_mat = np.ascontiguousarray(counts_mat, np.uint8)
        pair_idx = np.ascontiguousarray(pair_idx, np.int32)
        assert T <= 255 and counts_mat.ndim == 2
        M = counts_mat.shape[0]
        assert len(inpaint_imTs) == len(orig_imTs) and pair_idx.shape == (M,)
        origs = torch.stack([self._device_put_memo(
            np.asarray(o, np.float32)) for o in orig_imTs])
        inps = torch.stack([self._device_put_memo(
            np.asarray(i, np.float32)) for i in inpaint_imTs])
        return self._launch_counts_steps(origs, inps, counts_mat, pair_idx,
                                         T, norm)

    @staticmethod
    def _finish_embeds(out, norm):
        """finish() of a blend+encode launch: the one host read, then the
        unit norm along the last axis in numpy (float32)."""

        def finish():
            with span("xfr.eval.finish"):
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
        general families fall back to bit-packed per-chunk programs (under
        a mesh each rank encodes its contiguous rows of the padded family
        in chunks of batch_size / dp)."""
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
        bits_d, step = self._shard_rows(self._upload(bits)), bs // self._dp
        gather = self._gathered(torch.cat([
            fn(self.net.params, orig, inp, bits_d[i:i + step])
            for i in range(0, bits_d.shape[0], step)]), n=T)
        return lambda: self._finish_embeds(gather(), norm)()

    def launch_blend_embeddings_counts(self, orig_imT, inpaint_imT,
                                       counts, T, norm=True):
        """Monotone-family fast path of :meth:`launch_blend_embeddings`
        taking the [H*W] uint8 enter-count plane directly (counts[p] =
        number of masks containing pixel p; mask t contains p iff
        counts[p] >= T - t).  Callers that derive masks from a threshold
        plane (inpainting-game eval) compute counts with one searchsorted
        instead of materializing the [T,H,W] family.  Under a mesh the
        row chunks, padded to a 'dp' multiple, split over 'dp'."""
        finish = self.launch_blend_embeddings_counts_multi(
            orig_imT, inpaint_imT, np.reshape(counts, (1, -1)), T, norm=norm)
        return lambda: finish()[0]

    def launch_blend_embeddings_counts_multi(self, orig_imT, inpaint_imT,
                                             counts_mat, T, norm=True):
        """Batch M monotone mask families over one probe/twin pair into a
        single blend+encode program (``counts_mat``: [M, H*W] uint8
        enter-count planes).  ``finish()`` returns [M, T, D] embeddings.
        The inpainting-game analysis uses this to evaluate all of a
        probe's saliency methods in one program.  Under a mesh the flat
        (map, chunk) step list, padded to a 'dp' multiple, splits over
        'dp'."""
        counts_mat = np.ascontiguousarray(counts_mat, np.uint8)
        assert T <= 255 and counts_mat.ndim == 2
        M = counts_mat.shape[0]
        origs = self._device_put_memo(np.asarray(orig_imT, np.float32))[None]
        inps = self._device_put_memo(np.asarray(inpaint_imT,
                                                np.float32))[None]
        return self._launch_counts_steps(origs, inps, counts_mat,
                                         np.zeros(M, np.int32), T, norm)

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

"""STRise: prior-guided sparse-mask blackbox saliency (port of
xfr_tpu/blackbox/strise.py).

Mask sampling, upsampling/shifting, filling, blending, embedding and
triplet scoring all run on the STRise device; only user-supplied
``black_box_fn`` callables (score-only external matchers) pull masked
probes back to the host.  Masked probes are embedded once and scored
against both the refs and the gallery in the same chunk.

Under a ``torch.distributed`` DeviceMesh (``mesh=``) every rank draws the
same masks from its seeded generator (checked with an all-gathered
checksum at the drain), scores its share of them, and the drain gathers
the scores: the chunk axis over 'dp' on the materialized-mask path (zero
pad chunks), each chunk's rows over 'dp' on the fused-blend path (each
rank launches the kernel on its batch_size / dp rows).

With ``use_pallas_blend=True`` the scorer feeds each chunk of masks to the
fused mask-blend kernel (``fused_blend.fused_mask_blend_preprocess``),
which on the card is the hand-written Hopper kernel: the [N,H,W] masks are
not built for scoring.  Otherwise the masks are materialized and blended
in plain PyTorch.  The JAX package's ``lax.scan`` over chunks is a Python
loop here; every chunk is enqueued on the device stream without a host
sync until the drain.  On a card each chunk's encode, and the mean-EBP
prior's walk, replay a CUDA graph captured at first use (``replay.run``,
through ``_encode_and_score`` and ``Whitebox.uniform_pooled_ebp``): the
card's launch queue holds about one eager chunk, so eager host work at a
map's start (the prior's walk) leaves the card idle.  The built-in
scorer's drain reads its map's results after that map's launch alone
(``_reading_after``), so a pipeline that launches the next map before
draining this one keeps the card busy through the drain.

The gallery montage (``plot_gallery``, ``save_gallery``) needs
matplotlib, imported inside the methods; it draws on the host.
"""

from __future__ import annotations

import functools
import sys

import numpy as np
import torch

from xfr_torch.blackbox import masks as M
from xfr_torch.utils.device import _launch_end, _reading_after, \
    precision_scope, resolve_device, to_device
from xfr_torch.utils.image import center_crop
from xfr_torch.utils.profiling import count, span

# the built-in matchers, scored on the STRise device, by the family whose
# batch preprocessing and channel mean their input takes
BUILTIN_BLACK_BOXES = {"resnetv4_pytorch": "resnet101",
                       "resnetv6_pytorch": "resnet101",
                       "vggface2_resnet50": "vggface2",
                       "senet50_256": "vggface2"}


def _matcher_input(black_box):
    """(batch preprocess, mean) of a built-in matcher: ``preprocess``
    takes [N,H,W,3] float RGB on a device to the [N,3,H,W] input less the
    channel mean, and ``mean(dtype, device)`` is that [3] mean, uploaded
    once a device."""
    if BUILTIN_BLACK_BOXES[black_box] == "vggface2":
        from xfr_torch.models.vggface2 import mean_vggface2, \
            preprocess_vggface2_batch
        return preprocess_vggface2_batch, mean_vggface2
    from xfr_torch.models.resnet101 import mean_rgb, \
        preprocess_resnet101_batch
    return preprocess_resnet101_batch, mean_rgb


def print_flush(s, file=sys.stdout, flush=True):
    file.write(s + "\n")
    if flush:
        file.flush()


class STRise:
    """Blackbox saliency via sparse prior-guided mask perturbation.

    ``device``: where masks, fills and scoring run (default "cuda"; None
    means "cuda" when ``use_gpu`` else "cpu").  Without a card, a CUDA
    device raises.  ``seed`` seeds the ``torch.Generator`` that draws the
    mask grids and then the shifts.  ``batch_size`` is the scoring chunk;
    ``net_dict`` shares Whitebox instances across calls.
    ``use_pallas_blend`` keeps the JAX package's name: in the port it
    selects the Hopper fused-blend kernel for scoring.
    ``score_precision``: None allows TF32 in the scoring encode; "high"
    and "highest" run it in full float32.  ``mesh``: a DeviceMesh with a
    'dp' dim over which the scoring splits (every rank constructs the
    same STRise and runs the same calls); ``batch_size`` rounds up to a
    'dp' multiple, and the matcher net gets ``use_mesh``.
    """

    def __init__(self,
                 probe=None,
                 refs=None,
                 ref_sids=None,
                 potential_gallery=None,
                 gallery=None,
                 gallery_size=50,
                 black_box=None,
                 black_box_fn=None,
                 prior_type="mean_ebp",
                 mask_type="sparse",
                 num_mask_elements=1,
                 num_masks=6500,
                 mask_scale=12,
                 mask_fill_type="blur",
                 blur_fill_sigma_percent=4,
                 triplet_score_type="cts",
                 use_gpu=True,
                 device="cuda",
                 seed=0,
                 batch_size=64,
                 net_dict=None,
                 use_pallas_blend=False,
                 mesh=None,
                 score_precision=None):
        if mesh is not None:
            from xfr_torch.parallel.mesh import dp_size

            dp = dp_size(mesh)
            batch_size = -(-batch_size // dp) * dp
        self.mesh = mesh
        if device is None:
            device = "cuda" if use_gpu else "cpu"
        self.device = resolve_device(device)
        self.blur_fill_sigma_percent = blur_fill_sigma_percent
        self._net_dict = net_dict if net_dict is not None else {}
        self.mean_ebp_net = None
        self.matcher_net = None
        # a CPU generator whatever the device: the masks are drawn on the
        # host, so one seed gives one mask set on the card and the CPU
        self._gen = torch.Generator()
        self._gen.manual_seed(seed)
        self.batch_size = batch_size
        self.use_pallas_blend = use_pallas_blend
        self.score_precision = score_precision

        if probe is not None and refs is not None:
            if isinstance(probe, (str, np.ndarray)):
                self.probe = center_crop(probe, convert_uint8=True)
            else:
                raise ValueError(
                    "Probe must be a filepath to an image or a NumPy array")
            if isinstance(refs, (list, np.ndarray)) or _is_dataframe(refs):
                self.refs = refs
            else:
                raise ValueError("Refs must be a list of filepaths, NumPy "
                                 "arrays, or a Pandas dataframe")
            self.ref_sids = ref_sids
        else:
            raise ValueError("Probe and reference must be specified")

        if prior_type is None or prior_type not in self.priors:
            raise ValueError(
                'Specified prior "{}" is not supported'.format(prior_type))
        self.prior_type = prior_type

        self.potential_gallery = potential_gallery
        if potential_gallery is not None:
            self.potential_gallery_size = _collection_size(potential_gallery)

        self.gallery = gallery
        self.gallery_size = (_collection_size(gallery)
                             if gallery is not None else gallery_size)

        if black_box:
            self.set_black_box(black_box)
        elif black_box_fn:
            self.black_box = None
            self._black_box_fn = black_box_fn
        else:
            raise ValueError("Black box name or function must be specified")

        if mask_type not in self.mask_types:
            raise ValueError(
                'Specified mask type "{}" is not supported'.format(mask_type))
        self.mask_type = mask_type

        if mask_fill_type not in self.mask_fill_types:
            raise ValueError('Specified mask fill type "{}" is not '
                             "supported".format(mask_fill_type))
        self.mask_fill_type = mask_fill_type

        self.num_mask_elements = num_mask_elements
        self.num_masks = num_masks
        self.mask_scale = mask_scale

        if triplet_score_type not in self.triplet_scoring_fns:
            raise ValueError('Specified triplet score type "{}" is not '
                             "supported.".format(triplet_score_type))
        self.triplet_score_type = triplet_score_type

    # -- the option tables --------------------------------------------------
    # Built at each use, so that a STRise holds no bound method of its own:
    # a finished map (its masks on the device among it) is freed when its
    # last reference goes, not at Python's next cycle collection.

    @property
    def priors(self):
        return {"mean_ebp": self.mean_ebp_prior,
                "uniform": self.uniform_prior}

    @property
    def black_boxes(self):
        return dict.fromkeys(BUILTIN_BLACK_BOXES, self.builtin_bb_fn)

    @property
    def mask_types(self):
        return {"sparse": self.generate_sparse_masks}

    @property
    def mask_fill_types(self):
        return {"gray": self.mask_fill_gray, "blur": self.mask_fill_blur}

    @property
    def triplet_scoring_fns(self):
        return {"cts": self.contrastive_triplet_similarity}

    @property
    def generate_masks(self):
        return self.mask_types[self.mask_type]

    @property
    def apply_masks(self):
        return self.mask_fill_types[self.mask_fill_type]

    @property
    def triplet_scoring_fn(self):
        return self.triplet_scoring_fns[self.triplet_score_type]

    @property
    def black_box_fn(self):
        """The named black box's scorer, or the ``black_box_fn`` given."""
        if self._black_box_fn is None:
            return self.black_boxes[self.black_box]
        return self._black_box_fn

    # -- configuration ----------------------------------------------------

    def set_probe(self, probe):
        if isinstance(probe, (str, np.ndarray)):
            self.probe = center_crop(probe, convert_uint8=False)
        else:
            raise ValueError(
                "Probe must be a filepath to an image or a NumPy array")
        self.original_probe_gallery_scores = None

    def set_black_box(self, black_box):
        if black_box not in self.black_boxes:
            raise ValueError('Specified black box "{}" is not supported'
                             .format(black_box))
        self.black_box = black_box
        self._black_box_fn = None
        self._preprocess, self._mean = _matcher_input(black_box)

    def _get_net(self, name, ebp_version=None):
        key = (name, ebp_version)
        if key not in self._net_dict:
            from xfr_torch.models import create_wbnet
            self._net_dict[key] = create_wbnet(
                name, ebp_version=ebp_version, device=self.device)
        wb = self._net_dict[key]
        if wb.device != self.device:
            raise ValueError(f"net {key} lives on {wb.device}, but this "
                             f"STRise runs on {self.device}")
        return wb

    def _tensor(self, a):
        """``a`` as float32 on the STRise device.  A host array goes up
        through ``utils.device.to_device`` (pinned, without waiting for the
        card) in its own dtype and is cast there: the same float32
        values."""
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        return to_device(a, self.device).to(torch.float32)

    # -- step 1: prior --------------------------------------------------------

    def mean_ebp_prior(self):
        if not self.mean_ebp_net:
            self.mean_ebp_net = self._get_net("resnetv4_pytorch")
        wb = self.mean_ebp_net
        from xfr_torch.models.resnet101 import preprocess_resnet101_batch
        probe = preprocess_resnet101_batch(self._tensor(self.probe)[None])
        if wb.convert_saliency_uint8:
            # the uint8-quantized saliency (ebp_version != 6) keeps the
            # host PIL conversion of wb.ebp, then resizes on the device
            n = wb.net.num_classes()
            P = wb.ebp(probe, torch.full((1, n), 1.0 / n, dtype=torch.float32,
                                         device=self.device))
            self.prior = M.resize_bilinear(self._tensor(P.astype(np.float32)),
                                           (224, 224))
            return
        # pooled MWP -> gaussian blur -> normalize -> resize, on device; on
        # a card one replay: the walk's host work would leave the card
        # idle between the previous map's chunks and this map's
        pooled = wb.uniform_pooled_ebp(wb.net.params, probe)
        P = M.gaussian_blur(pooled.squeeze().float(), 2.0)
        P = torch.clamp(P, min=0.0)
        P = P / torch.clamp(P.sum(), min=wb.eps)
        self.prior = M.resize_bilinear(P, (224, 224))

    def uniform_prior(self):
        # The reference leaves self.prior untouched; the usable semantic is
        # an everywhere-uniform sampling grid.  It lies on the host: its
        # grid's percentile clip keeps the cells that rounding left at
        # the top, and the host's rounding is the same for every device.
        if not hasattr(self, "prior"):
            self.prior = torch.ones((224, 224), dtype=torch.float32)

    # -- step 2: masks -------------------------------------------------------

    def generate_sparse_masks(self, random_shift=True, order=1):
        # the sampling grid is computed where a tensor prior lies (a host
        # prior gives one grid on every device), the masks on the device
        prior = (self.prior if isinstance(self.prior, torch.Tensor)
                 else self._tensor(self.prior)).float()
        if self.use_pallas_blend and random_shift:
            M.check_grid_capacity(
                prior.shape, self.mask_scale, self.num_mask_elements,
                pct=0.0 if self.prior_type == "uniform" else 50.0)
            grid_probs = to_device(M.prior_to_grid(
                prior, self.mask_scale, self.prior_type), self.device)
            self._grids_dev = M.sample_sparse_grids(
                self._gen, grid_probs, self.num_masks,
                self.num_mask_elements)
            self._shifts_dev = M.random_shifts(
                self._gen, self.num_masks, self.mask_scale, self.device)
            self._masks_dev_cache = None
            self._masks_np = None
            return
        self._grids_dev = None
        self._masks_dev_cache = M.make_masks(
            self._gen, prior, self.num_masks, self.mask_scale,
            self.num_mask_elements, prior_type=self.prior_type,
            random_shift=random_shift, device=self.device)
        self._masks_np = None

    @property
    def _masks_dev(self):
        if self._masks_dev_cache is None and self._grids_dev is not None:
            # lazy materialization for API parity (self.masks), the
            # combine and the non-fused scorer
            self._masks_dev_cache = M.upsample_shift_masks_static(
                self._grids_dev, self._shifts_dev,
                tuple(self.prior.shape[:2]), self.mask_scale)
        return self._masks_dev_cache

    @property
    def masks(self):
        if getattr(self, "_masks_np", None) is None:
            self._masks_np = self._masks_dev.cpu().numpy()
        return self._masks_np

    # -- step 3: fill --------------------------------------------------------

    def mask_fill_gray(self):
        # A quirk of the reference kept as it is: the fill is 0.5 on the
        # 0..255 uint8 probe scale, i.e. near-black.
        self._fill_dev = torch.full(self.probe.shape, 0.5,
                                    dtype=torch.float32, device=self.device)

    def mask_fill_blur(self):
        sigma = self.blur_fill_sigma_percent / 100.0 * max(self.probe.shape)
        self._fill_dev = M.gaussian_blur(self._tensor(self.probe), sigma)

    def masked_probes_np(self, indices=None):
        """Materialize masked probes [k,H,W,C] on host (for external
        black_box_fn or visualization)."""
        m = self._masks_dev if indices is None else self._masks_dev[indices]
        probe = self._tensor(self.probe)
        m = m[..., None]
        blends = m * probe + (1.0 - m) * self._fill_dev
        return blends.cpu().numpy()

    def apply_masks_using_image(self, image):
        """Blend probe<->``image`` under every mask in one device op; the
        result is also kept as the fill for subsequent scoring."""
        self._fill_dev = self._tensor(image)
        return self.masked_probes_np()

    @property
    def masked_probes(self):
        return self.masked_probes_np()

    # -- step 4: scoring -----------------------------------------------------

    def builtin_bb_fn(self, probes, gallery):
        """Built-in matcher's scorer for host-side inputs.  The hot
        masked-probe path uses the chunk scorer instead."""
        if not self.matcher_net:
            self.matcher_net = self._get_net(self.black_box, ebp_version=6)
        wb = self.matcher_net
        gal_vecs = self._embed_collection(wb, gallery)
        probe_vecs = self._embed_collection(wb, probes)
        return _l2_similarity(probe_vecs, gal_vecs)

    def _embed_collection(self, wb, images):
        if isinstance(images, np.ndarray) and images.ndim == 4 and \
                images.shape[-1] == 3:
            images = self._preprocess(self._tensor(images))
        elif isinstance(images, (list, tuple)) and len(images) and \
                isinstance(images[0], np.ndarray) and images[0].ndim == 3 \
                and images[0].shape[2] == 3:
            images = self._preprocess(self._tensor(np.stack(images)))
        return wb.embeddings(images)

    @staticmethod
    def _embed_memo_lookup(wb, arr):
        """The shared-net embedding memo's (memo, key, hit) triple for a
        stacked [N,H,W,3] image array.  One key recipe for both the
        collection path and the probe launch path.

        Params are replaced wholesale (never mutated) on reload, so
        object identity is a sound freshness check for a hit."""
        from xfr_torch.utils.cache import content_key

        memo = getattr(wb, "_bb_embed_memo", None)
        if memo is None:
            memo = wb._bb_embed_memo = {}
        key = content_key(arr)
        hit = memo.get(key)
        if hit is not None and hit[0] is not wb.net.params:
            hit = None
        return memo, key, hit

    def _embed_collection_memo(self, wb, images):
        """_embed_collection with a content-hash memo on the shared net:
        refs and gallery are constant across the probes of a job.  Only
        plain ndarray collections are memoized."""
        from xfr_torch.utils.cache import memo_put

        if isinstance(images, (list, tuple)) and len(images) and \
                isinstance(images[0], np.ndarray):
            arr = np.stack(images)
        elif isinstance(images, np.ndarray):
            arr = images
        else:
            return self._embed_collection(wb, images)
        memo, key, hit = self._embed_memo_lookup(wb, arr)
        if hit is not None:
            return hit[1]
        e = self._embed_collection(wb, images)
        memo_put(memo, key, (wb.net.params, e))
        return e

    def _launch_probe_embed(self, wb):
        """Enqueue the probe embedding without a host sync.

        Returns ``(pe_kernel, fetch)``: ``pe_kernel`` is a [1,D] device
        tensor (un-normalized when freshly enqueued, normalized when it
        came from the memo — the consumer re-normalizes), and ``fetch()``
        produces the normalized host embedding and inserts it into the
        memo (bitwise what ``_embed_collection(wb, [probe])`` returns)."""
        from xfr_torch.utils.cache import memo_put

        arr = np.stack([np.asarray(self.probe)])
        memo, key, hit = self._embed_memo_lookup(wb, arr)
        if hit is not None:
            e = hit[1].reshape(1, -1)
            return self._tensor(e), (lambda: hit[1])
        x = self._preprocess(self._tensor(arr))
        bs = wb.batch_size
        if bs > 1:
            x = torch.cat([x, x.new_zeros((bs - 1,) + tuple(x.shape[1:]))])
        e_dev = wb.encode(x)
        pe_kernel = e_dev[:1].reshape(1, -1)

        def fetch():
            e = e_dev.cpu().numpy()[:1]
            flat = e.reshape(1, -1)
            e = (flat / np.linalg.norm(flat, axis=1, keepdims=True)
                 ).reshape(e.shape)
            memo_put(memo, key, (wb.net.params, e))
            return e

        return pe_kernel, fetch

    @staticmethod
    def _select_combine_fn(n):
        """Positive-mask selection + weighted combine + normalization for
        the default contrastive-triplet scoring at percentile 0, on
        device: consumes the chunk scores and the un-fetched probe
        embedding, so launch_evaluate's finish() is a single fetch.

        Mirrors compute_saliency_map: at percentile 0 the selection
        ``scores >= min(positive scores)`` is ``scores > 0``, and the cts
        arithmetic keeps the host op order."""

        def fn(masks, rs, gs, pe, ref_e, gal_e):
            pe = pe / torch.linalg.norm(pe, dim=1, keepdim=True)
            orig_r = 1.0 - 0.5 * torch.linalg.norm(
                pe[:, None] - ref_e[None], dim=2)
            orig_g = 1.0 - 0.5 * torch.linalg.norm(
                pe[:, None] - gal_e[None], dim=2)
            ref_sc = orig_r - rs[:n]
            gal_sc = orig_g - gs[:n]
            cts = (ref_sc - gal_sc).mean(dim=1)
            sel = (cts > 0).float()
            npos = sel.sum()
            w = cts * sel
            smap = 1.0 - torch.einsum("n,nhw->hw", w, masks[:n]) \
                / torch.clamp(npos, min=1.0)
            smap = smap - smap.min()
            smap = smap / smap.max()
            return cts, npos, smap

        return fn

    def score_masks(self):
        self._score_masks_launch()()

    def _score_chunks(self, wb, probe, fill, ref_e, gal_e):
        """Enqueue this rank's scoring chunks.  Returns (ref scores,
        gallery scores, gather): device tensors of this rank's rows, and
        ``gather(t)``, which all-gathers such rows of every rank into mask
        order over the padded mask count (the drain's collective).
        Without a mesh: every chunk, and the identity."""
        from xfr_torch.blackbox.fused_blend import fused_mask_blend_preprocess
        from xfr_torch.parallel import mesh as MS

        n, bs, mesh = self.num_masks, self.batch_size, self.mesh
        nchunk = -(-n // bs)
        graph, enc = wb.net.graph, wb.net.encode_tensor
        params = wb.net.params
        kernel = self.use_pallas_blend and self._grids_dev is not None
        if mesh is None:
            spans = [(c * bs, (c + 1) * bs) for c in range(nchunk)]
        elif kernel:
            # each chunk's rows over 'dp': bs / dp rows a launch
            dp, r = MS.dp_size(mesh), mesh.get_local_rank("dp")
            per = bs // dp
            spans = [(c * bs + r * per, c * bs + (r + 1) * per)
                     for c in range(nchunk)]
        else:
            # the chunk axis over 'dp', padded with zero-mask chunks
            lo, hi = MS.local_rows(mesh, nchunk)
            spans = [(c * bs, (c + 1) * bs) for c in range(lo, hi)]

        if kernel:
            mean = self._mean(torch.float32, self.device)
            grids = self._grids_dev.float().contiguous()
            shifts = self._shifts_dev.to(torch.int32).contiguous()
            probe, fill = probe.contiguous(), fill.contiguous()

            def chunk(i0, i1):
                g, s = grids[i0:i1], shifts[i0:i1]
                if g.shape[0] < i1 - i0:  # pad: all-ones grids, zero shifts
                    k = i1 - i0 - g.shape[0]
                    g = torch.cat([g, g.new_ones(
                        (k,) + tuple(grids.shape[1:]))])
                    s = torch.cat([s, s.new_zeros((k, 2))])
                return fused_mask_blend_preprocess(
                    g, s, probe, fill, mean, mask_scale=self.mask_scale)
        else:
            masks = self._masks_dev

            def chunk(i0, i1):
                m = masks[i0:i1]
                if m.shape[0] < i1 - i0:  # pad: all-zero masks
                    m = torch.cat([m, m.new_zeros(
                        (i1 - i0 - m.shape[0],) + tuple(masks.shape[1:]))])
                m = m[..., None]
                return self._preprocess(m * probe + (1.0 - m) * fill)

        # masked-probe rows encoded, padding included
        count("xfr.bb.rows_scored", sum(i1 - i0 for i0, i1 in spans))
        rs, gs = [], []
        with precision_scope(self.score_precision):
            for i0, i1 in spans:
                r, g = _encode_and_score(graph, enc, params, chunk(i0, i1),
                                         ref_e, gal_e)
                rs.append(r)
                gs.append(g)

        def gather(t):
            if mesh is None:
                return t
            t = MS.gather_rows(mesh, t)
            if kernel:  # [dp, chunk, row] -> [chunk, dp, row]
                t = t.reshape(dp, nchunk, per, -1).transpose(0, 1)
            return t.reshape(-1, t.shape[-1])

        return torch.cat(rs), torch.cat(gs), gather

    def _draws_checksum(self):
        """An int64 device scalar over this STRise's masks (the grids and
        shifts of the fused-blend path, else the materialized masks):
        each mask's float32 bit patterns summed as integers, weighted by
        its index, with two's-complement wrap.  Exact, so ranks that drew
        the same masks give the same value in any summation order."""
        parts = ((self._grids_dev, self._shifts_dev)
                 if self._grids_dev is not None else (self._masks_dev,))
        total = 0
        for t in parts:
            t = t.contiguous()
            bits = t.view(torch.int32) if t.dtype == torch.float32 else t
            rows = bits.reshape(t.shape[0], -1).sum(1, dtype=torch.int64)
            total = total + (rows * torch.arange(
                1, t.shape[0] + 1, device=t.device)).sum()
        return total

    def _check_same_draws(self, draws):
        """Every rank of the mesh drew the same masks (an all-gather of
        ``_draws_checksum``); raises otherwise."""
        from xfr_torch.parallel.mesh import all_equal

        same, vals = all_equal(self.mesh, draws)
        if not same:
            raise RuntimeError("the mesh's ranks drew different masks "
                               f"(checksums {vals}): every rank must build "
                               "STRise with the same seed and prior")

    def _score_masks_launch(self, want_fused_finish=False):
        """Enqueue the mask-scoring device work without syncing.

        Returns a drain closure that fetches the chunk scores and sets
        ``mask_scores``.  With ``want_fused_finish`` (launch_evaluate's
        pipeline) the materialized-mask path also enqueues the
        selection+combine and stores a one-fetch finisher on
        ``self._fused_finish`` that sets every score attribute AND the
        saliency map; the returned drain then delegates to it."""
        builtin = self.black_box in self.black_boxes if self.black_box \
            else False
        self._fused_finish = None

        if builtin:
            if not self.matcher_net:
                self.matcher_net = self._get_net(self.black_box,
                                                ebp_version=6)
            wb = self.matcher_net
            if self.mesh is not None and wb.mesh is not self.mesh:
                wb.use_mesh(self.mesh)
            n = self.num_masks
            use_fused_blend = (self.use_pallas_blend and
                               getattr(self, "_grids_dev", None) is not None)
            fused = (want_fused_finish and not use_fused_blend and
                     self.triplet_scoring_fn ==
                     self.contrastive_triplet_similarity)

            # refs and gallery repeat across a job's probes: a memo miss
            # fetches their embeddings to the host, a hit waits for nothing
            ref_e = self._embed_collection_memo(wb, self.refs)
            gal_e = self._embed_collection_memo(wb, self.gallery)
            # the probe's embedding is enqueued and fetched by the drain
            pe_kernel, probe_fetch = self._launch_probe_embed(wb)

            def original_scores():
                pe = probe_fetch()
                self.original_probe_ref_scores = _l2_similarity(pe, ref_e)
                self.original_probe_gallery_scores = _l2_similarity(pe,
                                                                    gal_e)

            probe = self._tensor(self.probe)
            ref_e_d = self._tensor(ref_e)
            gal_e_d = self._tensor(gal_e)
            draws = None if self.mesh is None else self._draws_checksum()
            rs, gs, gather = self._score_chunks(wb, probe, self._fill_dev,
                                                ref_e_d, gal_e_d)

            def gathered():
                # every rank's scores in mask order (the drain's
                # collectives), after the ranks' masks are held equal
                if draws is not None:
                    self._check_same_draws(draws)
                return gather(rs), gather(gs)

            if fused:
                flat_ref = ref_e_d.reshape(len(self.refs), -1)
                flat_gal = gal_e_d.reshape(_collection_size(self.gallery),
                                           -1)
                select = functools.partial(
                    self._select_combine_fn(n), self._masks_dev,
                    pe=pe_kernel, ref_e=flat_ref, gal_e=flat_gal)
                done = None
                if self.mesh is None:
                    # enqueued now; under a mesh it follows the gather
                    combined = select(rs, gs)
                    done = _launch_end(self.device)

                def fused_finish():
                    if self.mesh is None:
                        rs_all, gs_all = rs, gs
                        cts_d, npos_d, smap_d = combined
                    else:
                        rs_all, gs_all = gathered()
                        cts_d, npos_d, smap_d = select(rs_all, gs_all)
                    with _reading_after(done, self.device):
                        self.masked_probe_ref_scores = \
                            rs_all.cpu().numpy()[:n]
                        self.masked_probe_gallery_scores = \
                            gs_all.cpu().numpy()[:n]
                        original_scores()
                        self.mask_scores = cts_d.cpu().numpy()
                        if float(npos_d) == 0:
                            raise ValueError(
                                "no positively-scored masks: the probe "
                                "scores identically against refs and "
                                "gallery (are they the same images?) — "
                                "cannot form a saliency map")
                        self.saliency_map = smap_d.cpu().numpy()

                self._fused_finish = fused_finish

                def drain():
                    # the generic path would read score attributes the
                    # fused program never set: run the finisher instead
                    fused_finish()
                return drain

            def drain():
                rs_all, gs_all = gathered()
                self.masked_probe_ref_scores = rs_all.cpu().numpy()[:n]
                self.masked_probe_gallery_scores = gs_all.cpu().numpy()[:n]
                original_scores()
                self.mask_scores = self.triplet_scoring_fn()

            return drain

        def drain():
            # external score-only matcher: host round-trip
            self.original_probe_ref_scores = self.black_box_fn(
                [self.probe], self.refs)
            if getattr(self, "original_probe_gallery_scores",
                       None) is None:
                self.original_probe_gallery_scores = self.black_box_fn(
                    [self.probe], self.gallery)
            mp = self.masked_probes_np()
            self.masked_probe_ref_scores = self.black_box_fn(mp, self.refs)
            self.masked_probe_gallery_scores = self.black_box_fn(
                mp, self.gallery)
            self.mask_scores = self.triplet_scoring_fn()

        return drain

    def contrastive_triplet_similarity(self):
        """cts = mean((origRef - maskRef) - (origGal - maskGal))."""
        ref_scores = (self.original_probe_ref_scores -
                      self.masked_probe_ref_scores)
        gallery_scores = (self.original_probe_gallery_scores -
                          self.masked_probe_gallery_scores)
        return (ref_scores - gallery_scores).mean(axis=1)

    # -- step 5: combine -----------------------------------------------------

    @staticmethod
    def _combine(masks, weights, selected):
        """mean over selected of weight*mask, fixed shapes (no gather)."""
        w = weights * selected
        return torch.einsum("n,nhw->hw", w, masks) / torch.sum(selected)

    def combine_masks(self, indices):
        indices = np.asarray(indices)
        if indices.dtype != bool:
            sel = np.zeros(self.num_masks, bool)
            sel[indices] = True
            indices = sel
        return self._combine(
            self._masks_dev, self._tensor(self.mask_scores),
            self._tensor(indices.astype(np.float32))).cpu().numpy()

    def compute_saliency_map(self, positive_scores=True, percentile=0):
        sorted_idx = self.mask_scores.argsort()[::-1]
        pos_sorted_idx = sorted_idx[self.mask_scores[sorted_idx] > 0]
        neg_sorted_idx = sorted_idx[self.mask_scores[sorted_idx] < 0][::-1]

        if positive_scores:
            if pos_sorted_idx.size == 0:
                raise ValueError(
                    "no positively-scored masks: the probe scores "
                    "identically against refs and gallery (are they the "
                    "same images?) — cannot form a saliency map")
            threshold = np.percentile(self.mask_scores[pos_sorted_idx],
                                      percentile)
            selected = self.mask_scores >= threshold
            saliency_map = 1.0 - self.combine_masks(selected)
        else:
            threshold = np.percentile(-self.mask_scores[neg_sorted_idx],
                                      percentile)
            selected = -self.mask_scores >= threshold
            saliency_map = self.combine_masks(selected) - 1.0

        saliency_map -= saliency_map.min()
        saliency_map /= saliency_map.max()
        self.saliency_map = saliency_map

    # -- gallery visualization -------------------------------------------------

    def _gallery_montage(self):
        """Gallery montage figure shared by plot_gallery / save_gallery:
        10 columns, one tile per gallery image."""
        import math

        import matplotlib.pyplot as plt

        ncols = 10
        # an empty gallery would give nrows=0, on which plt.subplots raises
        nrows = max(1, int(math.ceil(1.0 * self.gallery_size / ncols)))
        fig, axes = plt.subplots(ncols=ncols, nrows=nrows, squeeze=False,
                                 figsize=(ncols, nrows))
        if _is_dataframe(self.gallery):
            ims = (center_crop(self.gallery.at[i, "Filename"],
                               convert_uint8=False)
                   for i in self.gallery.index)
        else:
            ims = iter(self.gallery)
        i = -1
        for i, im in enumerate(ims):
            ax = axes.flat[i]
            ax.set_xticks([])
            ax.set_yticks([])
            ax.xaxis.label.set_visible(False)
            ax.yaxis.label.set_visible(False)
            ax.imshow(im)
        for ii in range(i + 1, nrows * ncols):
            fig.delaxes(axes.flat[ii])
        fig.tight_layout(pad=0, w_pad=0, h_pad=0)
        fig.subplots_adjust(hspace=0, wspace=0)
        return fig

    def plot_gallery(self):
        import matplotlib.pyplot as plt

        self._gallery_montage()
        plt.show()

    def save_gallery(self, filename):
        import matplotlib.pyplot as plt

        fig = self._gallery_montage()
        fig.savefig(filename, bbox_inches="tight")
        plt.close(fig)

    # -- driver ----------------------------------------------------------------

    def evaluate(self):
        steps = 5
        print_flush("1/{} Computing prior...".format(steps))
        with span("xfr.bb.prior"):
            self.priors[self.prior_type]()
        print_flush("2/{} Generating masks...".format(steps))
        self.generate_masks()
        print_flush("3/{} Applying masks...".format(steps))
        self.apply_masks()
        print_flush("4/{} Scoring masks...".format(steps))
        self.score_masks()
        print_flush("5/{} Computing saliency map...".format(steps))
        self.compute_saliency_map()
        print_flush("Finished!")

    def launch_evaluate(self, verbose=False):
        """evaluate() split for cross-probe pipelining: prior, masks, fill
        and all scoring work ENQUEUE here; the returned finish() closure
        drains the scores, computes the saliency map and returns it.
        Results are identical to evaluate().  With the built-in matcher,
        once the refs' and gallery's embeddings are in the shared net's
        memo, the launch waits for the card nowhere: every host upload
        goes pinned and non-blocking through ``utils.device.to_device``."""
        with span("xfr.bb.launch"):
            if verbose:
                print_flush("launch: prior/masks/fill/scoring enqueue...")
            with span("xfr.bb.prior"):
                self.priors[self.prior_type]()
            # the host draw, the grid and their upload
            with span("xfr.bb.masks"):
                self.generate_masks()
            self.apply_masks()
            # memo lookups, the probe's encode, the chunks, the combine
            with span("xfr.bb.score"):
                drain = self._score_masks_launch(want_fused_finish=True)
            fused = self._fused_finish
            self._fused_finish = None
        if fused is not None:
            def finish():
                with span("xfr.bb.finish"):
                    fused()
                    return self.saliency_map

            return finish

        def finish():
            with span("xfr.bb.finish"):
                drain()
                self.compute_saliency_map()
                return self.saliency_map

        return finish


def _is_dataframe(x):
    try:
        import pandas as pd
    except ImportError:
        return False
    return isinstance(x, pd.DataFrame)


def _collection_size(x):
    if isinstance(x, list):
        return len(x)
    if isinstance(x, np.ndarray):
        return x.shape[0]
    if _is_dataframe(x):
        return len(x.index)
    raise TypeError("collection must be a list of filepaths, NumPy arrays, "
                    "or a Pandas dataframe")


def _l2_similarity(x, y):
    """1 - 0.5*||x_hat - y_hat|| pairwise."""
    xn = x / np.linalg.norm(x, axis=1)[:, None]
    yn = y / np.linalg.norm(y, axis=1)[:, None]
    return 1.0 - 0.5 * np.linalg.norm(xn[:, None] - yn[None], axis=2)


def _encode_and_score(graph, enc, params, x, ref_e, gal_e):
    """Shared scorer tail: encode preprocessed blends in the caller's
    precision scope, L2-normalize (the embedding carries the
    Multiply(50)), score against both galleries.  On a card the encode is
    one replay of its captured graph (``replay.run``): the launch leaves
    the chunks queued on the card and the host free for the next map's
    prior and draw."""
    from xfr_torch import replay as R
    from xfr_torch.ebp import interpreter as I

    def encode(x):
        e = I.forward_clean(graph, params, x, keep=(enc,))[enc]
        return e.reshape(x.shape[0], -1)

    e = R.run(encode, x, graph, "encode", I.param_ids(graph, params, enc))
    return _score(e, ref_e, gal_e)


def _score(e, ref_e, gal_e):
    """Embeddings [N, D] (carrying the Multiply(50)), L2-normalized and
    scored against both galleries."""
    e = e / torch.linalg.norm(e, dim=1, keepdim=True)
    ref_s = 1.0 - 0.5 * torch.linalg.norm(e[:, None, :] - ref_e[None], dim=2)
    gal_s = 1.0 - 0.5 * torch.linalg.norm(e[:, None, :] - gal_e[None], dim=2)
    return ref_s, gal_s

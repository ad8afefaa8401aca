"""Whitebox saliency demos on the port (counterpart of
demo/test_whitebox.py, the same eleven scenarios under the same names).

    python -m xfr_torch.demo.whitebox [--quick] [--net NET] [--topk K]
        [--wsebp-max-candidates N] [--data DIR] [--device cuda|cpu]
        [--outdir DIR]

Writes blended saliency overlays under the JAX demo's file names into
``--outdir`` (default: the repo's demo/ directory).  Each scenario
returns the maps it drew.

Data resolution order: --data flag, $XFR_DEMO_DATA, the reference
release's data/ directory under the repo root if present, else a
synthetic face (weights fall back to deterministic random init when the
torch checkpoints are absent, so the demos always run end to end;
saliency is then structurally valid but not face-meaningful).
"""

import argparse
import math
import os

import numpy as np
import PIL.Image

import xfr_torch
from xfr_torch import show
from xfr_torch.models import create_wbnet

OUTDIR = os.path.join(xfr_torch.xfr_root, "demo")


def _data_dir():
    for cand in (os.environ.get("XFR_DEMO_DATA"),
                 os.path.join(xfr_torch.xfr_root, "data")):
        if cand and os.path.exists(os.path.join(cand, "demo_face.jpg")):
            return cand
    return None


def _demo_face():
    d = _data_dir()
    if d:
        return PIL.Image.open(os.path.join(d, "demo_face.jpg"))
    rng = np.random.RandomState(0)
    img = (rng.rand(256, 256, 3) * 40 + 80).astype(np.uint8)
    img[60:200, 70:190] = 190            # face
    img[100:120, 95:115] = 60            # left eye
    img[100:120, 150:170] = 60           # right eye
    img[150:180, 120:140] = 120          # nose
    return PIL.Image.fromarray(img)


def _triplet_files(mask="nose"):
    d = _data_dir()
    mask_ids = {"mouth": 1, "nose": 2, "eyes": 4}
    if d:
        ipg = os.path.join(d, "inpainting-game/IJBC/aligned/8/img")
        pat = os.path.join(ipg, "{img}/inpainted/%05d_{kind}.png"
                           % mask_ids[mask])
        files = (pat.format(img=1017, kind="truth"),
                 pat.format(img=1017, kind="out_0"),
                 pat.format(img=1406, kind="truth"))
        if all(os.path.exists(f) for f in files):
            return [PIL.Image.open(f) for f in files]
        files = (os.path.join(d, "n00000001_00000117.JPEG"),
                 os.path.join(d, "n00000002_00000100.JPEG"),
                 os.path.join(d, "n00000001_00000384.JPEG"))
        if all(os.path.exists(f) for f in files):
            return [PIL.Image.open(f) for f in files]
    # synthetic triplet: probe/mate share an identity patch; nonmate differs
    rng = np.random.RandomState(1)
    base = (rng.rand(224, 224, 3) * 40 + 80).astype(np.uint8)
    probe = base.copy()
    probe[40:90, 80:150] = 210
    mate = np.clip(probe.astype(int) + rng.randint(-10, 10, probe.shape),
                   0, 255).astype(np.uint8)
    nonmate = base.copy()
    nonmate[40:90, 80:150] = 40
    return [PIL.Image.fromarray(x) for x in (probe, nonmate, mate)]


def _center_crop_face(im):
    """Detector stand-in: center square crop + 224 resize (the reference
    runs Faster R-CNN here; see xfr_torch.detection)."""
    im = im.convert("RGB")
    w, h = im.size
    m = min(w, h)
    im = im.crop(((w - m) // 2, (h - m) // 2,
                  (w - m) // 2 + m, (h - m) // 2 + m))
    return im.resize((224, 224))


def _blend(img, smap, scale_factor=1.0, gamma=0.3, blur_sigma=0.05):
    arr = np.array(img.convert("RGB")).astype(np.float32) / 255.0
    out = show.blend_saliency_map(arr, smap, blur_sigma=blur_sigma,
                                  gamma=gamma, scale_factor=scale_factor)
    return PIL.Image.fromarray(np.uint8(np.clip(out, 0, 1) * 255))


def _montage(images, tile=112, cols=None):
    n = len(images)
    cols = cols or int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    canvas = PIL.Image.new("RGB", (cols * (tile + 1), rows * (tile + 1)),
                           (255, 255, 255))
    for i, im in enumerate(images):
        canvas.paste(im.resize((tile, tile)),
                     ((i % cols) * (tile + 1), (i // cols) * (tile + 1)))
    return canvas


def _onehot(wb, k):
    P = np.zeros((1, wb.net.num_classes()), np.float32)
    P[0, k] = 1.0
    return P


def _encode_triplet(wb, mask="nose"):
    im_probe, im_nonmate, im_mate = [_center_crop_face(im)
                                     for im in _triplet_files(mask)]
    x_mate = wb.encode(wb.net.preprocess(im_mate)).cpu().numpy()
    x_nonmate = wb.encode(wb.net.preprocess(im_nonmate)).cpu().numpy()
    img_probe = wb.net.preprocess(im_probe)
    img_probe_display = im_probe.resize((112, 112))
    return x_mate, x_nonmate, img_probe, img_probe_display


def _save(name, img, outdir=None):
    out = os.path.join(outdir or OUTDIR, name)
    img.save(out)
    print('[test_whitebox.%s]: saved "%s"'
          % (name.replace("test_whitebox_", "").replace(".jpg", ""), out))


def ebp(wb, outdir=None):
    """Excitation backprop (reference: demo/test_whitebox.py:77-92)."""
    x_probe = wb.net.preprocess(_demo_face())
    img_saliency = wb.ebp(x_probe, _onehot(wb, 0))
    _save("test_whitebox_ebp.jpg",
          _blend(_demo_face().resize((112, 112)), img_saliency), outdir)
    return img_saliency


def contrastive_ebp(wb, outdir=None):
    x_probe = wb.net.preprocess(_demo_face())
    s = wb.contrastive_ebp(x_probe, k_poschannel=0, k_negchannel=100)
    _save("test_whitebox_contrastive_ebp.jpg",
          _blend(_demo_face().resize(s.shape), s), outdir)
    return s


def truncated_contrastive_ebp(wb, outdir=None):
    x_probe = wb.net.preprocess(_demo_face())
    s = wb.truncated_contrastive_ebp(x_probe, k_poschannel=0,
                                     k_negchannel=100, percentile=20)
    _save("test_whitebox_truncated_contrastive_ebp.jpg",
          _blend(_demo_face().resize(s.shape), s), outdir)
    return s


def triplet_ebp(wb, outdir=None):
    x_mate, x_nonmate, img_probe, disp = _encode_triplet(wb, "nose")
    wb.net.set_triplet_classifier(x_mate / 2500.0, x_nonmate / 2500.0)
    s = wb.ebp(img_probe, _onehot(wb, 0))
    _save("test_whitebox_triplet_ebp.jpg", _blend(disp, s), outdir)
    return s


def contrastive_triplet_ebp(wb, outdir=None):
    x_mate, x_nonmate, img_probe, disp = _encode_triplet(wb, "nose")
    wb.net.set_triplet_classifier(x_mate / 2500.0, x_nonmate / 2500.0)
    s = wb.contrastive_ebp(img_probe, k_poschannel=0, k_negchannel=1)
    _save("test_whitebox_contrastive_triplet_ebp.jpg", _blend(disp, s),
          outdir)
    return s


def truncated_contrastive_triplet_ebp(wb, outdir=None):
    x_mate, x_nonmate, img_probe, disp = _encode_triplet(wb, "nose")
    wb.net.set_triplet_classifier(x_mate / 2500.0, x_nonmate / 2500.0)
    s = wb.truncated_contrastive_ebp(img_probe, k_poschannel=0,
                                     k_negchannel=1, percentile=20)
    _save("test_whitebox_truncated_contrastive_triplet_ebp.jpg",
          _blend(disp, s), outdir)
    return s


def layerwise_ebp(wb, stride=37, outdir=None):
    """EBP montage starting from each interior layer's argmax node over a
    strided subset of the event schedule (the reference's scenario is
    deprecated and raises; this is the JAX demo's working version).  Tiles
    are ordered row-wise by layer, approaching the image layer at the
    bottom right.  Returns the tiles' maps."""
    x_probe = wb.net.preprocess(_demo_face())
    disp = _demo_face().resize((112, 112))
    n = wb._n_events
    tiles, maps = [], []
    for k in range(0, n - 1, stride):
        print("[test_layerwise_ebp][%d/%d]: layerwise EBP '%s'"
              % (k, n, wb.P_layername[k]))
        s = wb.layerwise_ebp(x_probe, k_layer=k, k_poschannel=0,
                             mode="argmax", mwp=False)
        maps.append(s)
        tiles.append(_blend(disp, np.float32(s) / max(np.max(s), 1e-12)))
    _save("test_whitebox_layerwise_ebp.jpg", _montage(tiles), outdir)
    return maps


def weighted_subtree_triplet_ebp(wb, topk=64, mask="nose",
                                 max_candidates=None, outdir=None):
    """Weighted subtree EBP + montage of selected subtrees
    (reference: demo/test_whitebox.py:175-201).  Returns the selected
    subtrees' maps followed by the merged map."""
    x_mate, x_nonmate, img_probe, disp = _encode_triplet(wb, mask)
    wb.net.set_triplet_classifier(x_mate / 2500.0, x_nonmate / 2500.0)
    img_subtree, P_img, P_subtree, k_subtree = wb.weighted_subtree_ebp(
        img_probe, k_poschannel=0, k_negchannel=1, topk=topk,
        do_max_subtree=False, subtree_mode="all",
        do_mated_similarity_gating=True, max_candidates=max_candidates)
    print("[weighted_subtree_triplet_ebp]: selected layers=%s"
          % str(k_subtree))
    maps = list(P_img) + [img_subtree]
    tiles = [_blend(disp, np.float32(p) / max(np.max(p), 1e-12))
             for p in maps]
    _save("test_whitebox_weighted_subtree_ebp_topk_%d_mask_%s.jpg"
          % (topk, mask), _montage(tiles), outdir)
    return maps


def ebp_lightcnn(device="cuda", outdir=None):
    wb = create_wbnet("lightcnn", device=device,
                      ebp_subtree_mode="affineonly")
    x_probe = wb.net.preprocess(_demo_face())
    s = wb.ebp(x_probe, _onehot(wb, 0), mwp=False)
    _save("test_whitebox_ebp_lightcnn.jpg",
          _blend(_demo_face().resize((128, 128)), s), outdir)
    return s


def ebp_resnet50_128(device="cuda", outdir=None):
    wb = create_wbnet("vggface2_resnet50", device=device)
    x_probe = wb.net.preprocess(_demo_face())
    s = wb.ebp(x_probe, _onehot(wb, 0), mwp=False)
    _save("test_whitebox_ebp_resnet50_128.jpg",
          _blend(_demo_face().resize((112, 112)), s), outdir)
    return s


def ebp_senet50_256(device="cuda"):
    """Raises: Sigmoid SE gates are unsupported by EBP
    (reference: demo/test_whitebox.py:224, whitebox.py:403)."""
    wb = create_wbnet("senet50_256", device=device)
    x_probe = wb.net.preprocess(_demo_face())
    return wb.ebp(x_probe, _onehot(wb, 0), mwp=False)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data", default=None,
                        help="reference data/ directory")
    parser.add_argument("--net", default="resnetv4_pytorch")
    parser.add_argument("--topk", type=int, default=64)
    parser.add_argument("--wsebp-max-candidates", type=int, default=None)
    parser.add_argument("--quick", action="store_true",
                        help="single-mask weighted subtree only")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--outdir", default=OUTDIR,
                        help="directory the overlays are written to")
    args = parser.parse_args(argv)
    if args.data:
        os.environ["XFR_DEMO_DATA"] = args.data
    dev, out = args.device, args.outdir

    wb = create_wbnet(args.net, device=dev)
    ebp(wb, out)
    contrastive_ebp(wb, out)
    truncated_contrastive_ebp(wb, out)
    triplet_ebp(wb, out)
    contrastive_triplet_ebp(wb, out)
    truncated_contrastive_triplet_ebp(wb, out)
    if not args.quick:
        layerwise_ebp(create_wbnet(args.net, device=dev, ebp_version=5,
                                   ebp_subtree_mode="all"), outdir=out)

    masks = ["nose"] if args.quick else ["nose", "eyes", "mouth"]
    for mask in masks:
        wb2 = create_wbnet(args.net, device=dev, ebp_version=5)
        weighted_subtree_triplet_ebp(
            wb2, topk=args.topk, mask=mask,
            max_candidates=args.wsebp_max_candidates, outdir=out)

    ebp_resnet50_128(dev, out)
    ebp_lightcnn(dev, out)


if __name__ == "__main__":
    main()

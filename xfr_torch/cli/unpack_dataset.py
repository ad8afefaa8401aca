"""Unpack the inpainting-game dataset's per-subject tarballs (port of
xfr_tpu/cli/unpack_dataset.py).

Equivalent of the reference's ``data/inpainting-game/unpack-aligned.sh``
(which loops ``tar xfz subj-*.tar.gz`` inside ``IJBC/``): extracts every
``subj-<ID>.tar.gz`` found under ``<dataset>/IJBC`` into place, so the
per-image ``aligned/<SUBJECT>/...`` trees the generation/eval drivers
expect appear next to the ``subj-*.csv`` metadata.

    python -m xfr_torch.cli.unpack_dataset [--dataset-dir DIR] [--force]

Idempotent: a subject whose ``aligned/<ID>`` directory already exists is
skipped unless ``--force`` is given (the same skip-if-exists convention
the saliency caches use).
"""

import argparse
import os
import re
import tarfile

import xfr_torch


def unpack_aligned(dataset_dir=None, force=False, verbose=True):
    """Extract subj-*.tar.gz under <dataset_dir>/IJBC; returns the list
    of subject ids actually unpacked."""
    dataset_dir = dataset_dir or xfr_torch.inpaintgame_dir
    ijbc = os.path.join(dataset_dir, "IJBC")
    if not os.path.isdir(ijbc):
        raise FileNotFoundError(
            "no IJBC/ directory under %r — point --dataset-dir at the "
            "inpainting-game release" % dataset_dir)

    # Compute the work list first: a fully-unpacked tree stays a no-op on
    # any interpreter (idempotent startup calls / resumes keep working).
    work = []
    for fname in sorted(os.listdir(ijbc)):
        m = re.match(r"subj-(\d+)\.tar\.gz$", fname)
        if not m:
            continue
        subj = m.group(1)
        dest = os.path.join(ijbc, "aligned", subj)
        if os.path.isdir(dest) and not force:
            if verbose:
                print("skip %s (aligned/%s exists)" % (fname, subj))
            continue
        work.append((fname, subj))

    if work and not hasattr(tarfile, "data_filter"):
        # PEP 706 filters (Python >= 3.12, or the 3.10.12+/3.11.4+
        # backports) are the symlink-escape defense; refuse before ANY
        # archive is opened — rather than die mid-run with partially
        # unpacked state on an old interpreter.
        raise RuntimeError(
            "unpack_dataset requires tarfile.data_filter "
            "(Python >= 3.12 or a PEP 706 backport); this Python is "
            "too old to extract untrusted archives safely")

    done = []
    for fname, subj in work:
        if verbose:
            print("unpacking %s -> IJBC/aligned/%s" % (fname, subj))
        with tarfile.open(os.path.join(ijbc, fname), "r:gz") as tf:
            # refuse entries that would escape the dataset dir (the
            # base dir itself is fine: 'tar -C dir .' archives carry a
            # benign '.' / './' member)
            base = os.path.realpath(ijbc)
            for member in tf.getmembers():
                target = os.path.realpath(os.path.join(ijbc, member.name))
                if target != base and not target.startswith(base + os.sep):
                    raise ValueError("unsafe path in %s: %s"
                                     % (fname, member.name))
            # data_filter additionally blocks symlink-escape tricks the
            # realpath check above cannot see (link member + write-through)
            tf.extractall(ijbc, filter="data")
        done.append(subj)
    return done


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument(
        "--dataset-dir", default=None,
        help="dataset root (default: xfr_torch.inpaintgame_dir)")
    parser.add_argument("--force", action="store_true",
                        help="re-extract even if aligned/<ID> exists")
    args = parser.parse_args(argv)
    done = unpack_aligned(args.dataset_dir, force=args.force)
    print("unpacked %d subject archive(s)" % len(done))


if __name__ == "__main__":
    main()

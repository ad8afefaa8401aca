"""Triplet dataset over the filtered-masks CSV (port of
xfr_tpu/data/triplet.py; reference: eval/datasets/triplet.py:8-113).

Yields (probe image, mated reference stack, inpainted non-mate stack) per
probe row: numpy arrays, or tensors when the transform returns tensors
(the port's net preprocessors return [1,C,H,W] tensors on their device).
"""

from __future__ import annotations

import os

import numpy as np
import PIL.Image
import torch


def default_loader(path):
    return PIL.Image.open(path).convert("RGB")


class TripletDataLoader:
    def __init__(self, data_file_p, loader=default_loader, transform=None,
                 data_root=None, return_file_info=False):
        import pandas as pd

        assert data_root is not None
        self.data_root = data_root
        self.data_file_p = data_file_p
        self.transform = transform
        assert not isinstance(self.transform, str)
        self.loader = loader

        ds = pd.read_csv(data_file_p)
        assert ds.shape[0] > 0, "%s was empty!" % data_file_p
        self.probe_ds = ds[ds["TRIPLET_SET"] == "PROBE"]
        self.ref_ds = ds[ds["TRIPLET_SET"] == "REF"].set_index(
            keys=["SUBJECT_ID", "MASK_ID"])
        self.return_file_info = return_file_info

    def shuffle(self):
        self.probe_ds = self.probe_ds.sample(frac=1)

    def _resolve(self, path):
        if os.path.isabs(path):
            return path
        roots = (self.data_root if isinstance(self.data_root, (list, tuple))
                 else [self.data_root])
        for root in roots:
            cand = os.path.join(root, path)
            if os.path.exists(cand):
                return cand
        raise FileNotFoundError(path)

    def load_image(self, column_path, data):
        img = self.loader(self._resolve(data[column_path]))
        if self.transform is not None:
            img = self.transform(img)
        arr = img if torch.is_tensor(img) else np.asarray(img)
        # net-preprocess transforms return a batch-carrying [1,C,H,W]
        # (unlike torchvision's [C,H,W]): add the batch axis only when it
        # is missing, so load_images always concatenates to [N,...]
        return arr if arr.ndim == 4 else arr[None, ...]

    def load_images(self, column_path, data):
        ims = [self.load_image(column_path, row) for _, row in data.iterrows()]
        if torch.is_tensor(ims[0]):
            return torch.cat(ims)
        return np.concatenate(ims)

    def __getitem__(self, idx):
        import pandas as pd

        probe_data = self.probe_ds.iloc[idx]
        probe_im = self.load_image("OriginalFile", probe_data)
        ref_data = self.ref_ds.loc[probe_data["SUBJECT_ID"],
                                   probe_data["MASK_ID"]]
        if isinstance(ref_data, pd.Series):
            # a single matching REF row collapses to a Series under
            # MultiIndex .loc; load_images needs rows to iterate
            ref_data = ref_data.to_frame().T
        ref_mate_ims = self.load_images("OriginalFile", ref_data)
        ref_nonmate_ims = self.load_images("InpaintingFile", ref_data)
        if self.return_file_info:
            return probe_im, ref_mate_ims, ref_nonmate_ims, probe_data
        return probe_im, ref_mate_ims, ref_nonmate_ims

    def __len__(self):
        return self.probe_ds.shape[0]

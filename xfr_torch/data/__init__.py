"""Data pipelines (port of xfr_tpu/data): ``transforms`` and the triplet
loader."""

from xfr_torch.data.triplet import TripletDataLoader  # noqa: F401

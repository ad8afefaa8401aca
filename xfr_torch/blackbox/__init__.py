from xfr_torch.blackbox.strise import STRise  # noqa: F401

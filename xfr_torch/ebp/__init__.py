from xfr_torch.ebp.engine import Whitebox, WhiteboxNetwork  # noqa: F401

from xfr_torch.models.factory import create_net, create_wbnet  # noqa: F401

from xfr_torch.utils.cache import content_key, memo_put  # noqa: F401

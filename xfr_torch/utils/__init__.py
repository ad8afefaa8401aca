from xfr_torch.utils.cache import (  # noqa: F401
    cache_npz, cache_npz_launch, content_key, memo_put)

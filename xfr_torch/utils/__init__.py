from xfr_torch.utils.cache import (  # noqa: F401
    cache_npz, cache_npz_launch, content_key, memo_put)
from xfr_torch.utils.params import (  # noqa: F401
    iterate_param_sets, prune_unneeded_exports)

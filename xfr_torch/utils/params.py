"""Parameter-set iteration for eval drivers (port of
xfr_tpu/utils/params.py).

The eval CLI convention: every value in the params dict is a list; the
cartesian product over the exported keys defines the job table that the
drivers shard over devices / hosts.
"""

from __future__ import annotations


def _resolve_key(k, params):
    """Keys may be (predicate, key) pairs: the key only applies when the
    predicate over the full params dict is true."""
    try:
        if k[0](params):
            return k[1]
        return None
    except TypeError:
        return k


def iterate_param_sets(params, params_export):
    """Yield param dicts covering the cartesian product of multi-valued
    exported keys."""
    for k in params_export:
        k = _resolve_key(k, params)
        if k is None or k not in params or params[k] is None:
            continue
        if len(params[k]) > 1:
            for val in params[k]:
                pams = params.copy()
                pams[k] = [val]
                for it in iterate_param_sets(pams, params_export):
                    yield it
            return
    yield params


def prune_unneeded_exports(params_export, params):
    pruned = []
    for k in params_export:
        k = _resolve_key(k, params)
        if k is None or k not in params:
            continue
        pruned.append(k)
    return pruned

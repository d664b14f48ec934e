"""``mx.contrib.ndarray`` (PyTorch counterpart of
``mxnet_tpu/contrib/ndarray.py``): the ``_contrib_*`` NDArray op
wrappers, under their short names and their own."""
from __future__ import annotations

import sys

from .. import ndarray as _nd
from ..ops.registry import OP_REGISTRY

_mod = sys.modules[__name__]
for _name in list(OP_REGISTRY):
    if _name.startswith("_contrib_"):
        _wrapper = getattr(_nd, _name, None)
        if _wrapper is not None:
            setattr(_mod, _name[len("_contrib_"):], _wrapper)
            setattr(_mod, _name, _wrapper)

"""``mx.contrib.symbol`` (PyTorch counterpart of
``mxnet_tpu/contrib/symbol.py``): ``sym.contrib``'s names."""
from __future__ import annotations

import sys

from .. import symbol as _sym

_mod = sys.modules[__name__]
for _name in dir(_sym.contrib):
    if not _name.startswith("__"):
        setattr(_mod, _name, getattr(_sym.contrib, _name))

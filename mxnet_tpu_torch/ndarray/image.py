"""``mx.nd.image``: the ``_image_*`` ops under their short names and
their own (PyTorch counterpart of ``mxnet_tpu/ndarray/image.py``).  Each
takes NDArrays (the imperative path) or tensors (a block's
``hybrid_forward``) and gives back the same kind, as the ``nd`` wrappers
do."""
from __future__ import annotations

import sys

from ..ops.registry import OP_REGISTRY

_mod = sys.modules[__name__]


def _install():
    nd = sys.modules[__name__.rsplit(".", 1)[0]]   # the generated wrappers
    for name in list(OP_REGISTRY):
        if name.startswith("_image_"):
            setattr(_mod, name[len("_image_"):], getattr(nd, name))
            setattr(_mod, name, getattr(nd, name))


_install()

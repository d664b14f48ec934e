"""gluon.utils: ``split_data``, ``split_and_load``, ``clip_global_norm``,
``check_sha1`` and ``download``.

PyTorch counterpart of ``mxnet_tpu/gluon/utils.py``.  ``download``
returns a file that is already in place (with a matching sha1 when one is
given) and raises otherwise: nothing here fetches over a network.
"""
from __future__ import annotations

import hashlib
import math
import os
import warnings

from .. import ndarray as nd
from ..ndarray.ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``num_slice`` slices of ``data`` along ``batch_axis`` (the last
    takes the remainder)."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data size {size} not divisible by {num_slice} slices")
    step = size // num_slice
    if batch_axis == 0:
        return [data[i * step:(i + 1) * step] if i < num_slice - 1
                else data[i * step:size] for i in range(num_slice)]
    return [data.slice_axis(batch_axis, i * step,
                            (i + 1) * step if i < num_slice - 1 else size)
            for i in range(num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split along ``batch_axis``, one slice on each context."""
    if not isinstance(data, NDArray):
        data = nd.array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` in place so that their joint L2 norm is at most
    ``max_norm``; returns the norm before scaling."""
    assert len(arrays) > 0
    total = 0.0
    for arr in arrays:
        total += float((arr * arr).sum().asscalar())
    total_norm = math.sqrt(total)
    if check_isfinite and not math.isfinite(total_norm):
        warnings.warn("nan or inf in gradient norm")
        return total_norm
    scale = max_norm / (total_norm + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr *= scale
    return total_norm


def check_sha1(filename, sha1_hash):
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None, retries=5,
             verify_ssl=True):
    """The file ``url`` names if it is already at ``path`` (and matches
    ``sha1_hash``); otherwise an error that says where to put it."""
    tail = url.split("/")[-1]
    if path is None:
        fname = tail
    else:
        path = os.path.expanduser(path)
        fname = os.path.join(path, tail) if os.path.isdir(path) else path
    if not os.path.basename(fname):
        raise ValueError(f"cannot derive a filename from url {url!r}")
    if os.path.isfile(fname) and not overwrite and \
            (sha1_hash is None or check_sha1(fname, sha1_hash)):
        return fname
    raise RuntimeError(
        f"download() does not fetch: place the file at {fname!r} "
        f"(sha1 {sha1_hash or 'unchecked'})")

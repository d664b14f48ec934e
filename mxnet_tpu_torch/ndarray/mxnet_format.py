"""Reference-MXNet binary NDArray checkpoint format (interop layer).

PyTorch port's own copy of ``mxnet_tpu/ndarray/mxnet_format.py`` (numpy
only; the port imports nothing of the JAX package).  Byte-level
reimplementation of the reference serialization, so real MXNet
checkpoints (``prefix-0000.params``, ``mx.nd.save`` files) load here and
files saved here load in stock MXNet and in the JAX package.  Reference:
``src/ndarray/ndarray.cc`` — ``NDArray::Save/Load`` per-array records
(``NDARRAY_V2_MAGIC`` 0xF993fac9 with storage type, ``NDARRAY_V1_MAGIC``
0xF993fac8 with int64 TShape, pre-V1 records whose leading uint32 is the
ndim), and the file-level list container ``kMXAPINDArrayListMagic`` 0x112
(ndarray.cc:1733-1762); TShape layout from nnvm ``Tuple::Save`` (uint32
ndim + int64 dims), Context layout from ``include/mxnet/base.h`` (two
int32: dev_type, dev_id).  Everything is little-endian.  The format has
type flags for float32/64, float16, uint8, int8, int32 and int64 only:
bfloat16 has none, here as in the reference.
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as _np

MXNET_LIST_MAGIC = 0x112
_V2_MAGIC = 0xF993FAC9
_V1_MAGIC = 0xF993FAC8

# mshadow type flags (reference: include/mxnet/tensor_blob.h / mshadow base.h)
_TYPE_FLAG_TO_DTYPE = {0: "float32", 1: "float64", 2: "float16", 3: "uint8",
                       4: "int32", 5: "int8", 6: "int64"}
_DTYPE_TO_TYPE_FLAG = {v: k for k, v in _TYPE_FLAG_TO_DTYPE.items()}

# storage types (reference: include/mxnet/ndarray.h:61-66)
_STYPE_DEFAULT, _STYPE_ROW_SPARSE, _STYPE_CSR = 0, 1, 2
_NUM_AUX = {_STYPE_DEFAULT: 0, _STYPE_ROW_SPARSE: 1, _STYPE_CSR: 2}

_CPU_DEV_TYPE = 1  # Context::kCPU


def is_mxnet_format(head: bytes) -> bool:
    """True if the first 8 bytes carry the reference list magic."""
    return len(head) >= 8 and \
        struct.unpack_from("<Q", head, 0)[0] == MXNET_LIST_MAGIC


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def _fixed(self, fmt: str, size: int) -> int:
        # bounds-checked so every truncation raises the module's documented
        # ValueError, never a position-dependent struct.error
        if self.off + size > len(self.data):
            raise ValueError("truncated MXNet NDArray file")
        (v,) = struct.unpack_from(fmt, self.data, self.off)
        self.off += size
        return v

    def u32(self) -> int:
        return self._fixed("<I", 4)

    def i32(self) -> int:
        return self._fixed("<i", 4)

    def u64(self) -> int:
        return self._fixed("<Q", 8)

    def raw(self, n: int) -> bytes:
        if n < 0 or self.off + n > len(self.data):
            # negative n (corrupt dims) would return b'' and move the
            # cursor BACKWARDS, desyncing every later record
            raise ValueError("truncated or corrupt MXNet NDArray file")
        b = self.data[self.off:self.off + n]
        self.off += n
        return b

    def tshape(self) -> Tuple[int, ...]:
        ndim = self.u32()
        shape = struct.unpack_from(f"<{ndim}q", self.raw(8 * ndim), 0)
        if any(d < 0 for d in shape):
            raise ValueError(f"corrupt MXNet NDArray file: negative dim "
                             f"in shape {shape}")
        return shape

    def tshape_pre_v1(self, ndim: int) -> Tuple[int, ...]:
        return struct.unpack_from(f"<{ndim}I", self.raw(4 * ndim), 0)

    def ndarray(self):
        """One NDArray record → numpy array (dense) or
        ('row_sparse'|'csr', data, aux_arrays, shape) tuple."""
        first = self.u32()
        if first == _V2_MAGIC:
            stype = self.i32()
            nad = _NUM_AUX.get(stype)
            if nad is None:
                raise ValueError(f"unknown storage type {stype}")
            sshape = self.tshape() if nad else None
            shape = self.tshape()
            if len(shape) == 0:
                return _np.zeros((0,), _np.float32)
            self.i32(), self.i32()  # Context dev_type, dev_id — ignored
            dtype = _np.dtype(_TYPE_FLAG_TO_DTYPE[self.i32()])
            aux_meta = [(_np.dtype(_TYPE_FLAG_TO_DTYPE[self.i32()]),
                         self.tshape()) for _ in range(nad)]
            dshape = sshape if nad else shape
            n = int(_np.prod(dshape)) if dshape else 1
            main = _np.frombuffer(self.raw(dtype.itemsize * n),
                                  dtype=dtype).reshape(dshape).copy()
            if not nad:
                return main
            aux = [_np.frombuffer(
                self.raw(adt.itemsize * int(_np.prod(ash))),
                dtype=adt).reshape(ash).copy() for adt, ash in aux_meta]
            kind = "row_sparse" if stype == _STYPE_ROW_SPARSE else "csr"
            return (kind, main, aux, tuple(shape))
        if first == _V1_MAGIC:
            shape = self.tshape()
        else:  # pre-V1: the magic itself is ndim (ndarray.cc LegacyTShapeLoad)
            shape = self.tshape_pre_v1(first)
        if len(shape) == 0:
            return _np.zeros((0,), _np.float32)
        self.i32(), self.i32()  # Context
        dtype = _np.dtype(_TYPE_FLAG_TO_DTYPE[self.i32()])
        n = int(_np.prod(shape))
        return _np.frombuffer(self.raw(dtype.itemsize * n),
                              dtype=dtype).reshape(shape).copy()


def load_bytes(data: bytes):
    """Parse a reference mx.nd.save file → (values, keys).  Values are numpy
    arrays or ('row_sparse'|'csr', data, aux, shape) tuples."""
    r = _Reader(data)
    if r.u64() != MXNET_LIST_MAGIC:
        raise ValueError("not a reference-MXNet NDArray file")
    r.u64()  # reserved
    n = r.u64()
    values = [r.ndarray() for _ in range(n)]
    nk = r.u64()
    keys = []
    for _ in range(nk):
        klen = r.u64()
        keys.append(r.raw(klen).decode())
    if keys and len(keys) != len(values):
        raise ValueError("invalid MXNet NDArray file: key/value count mismatch")
    return values, keys


def _write_tshape(out: List[bytes], shape) -> None:
    out.append(struct.pack("<I", len(shape)))
    out.append(struct.pack(f"<{len(shape)}q", *shape))


def _write_ndarray(out: List[bytes], value) -> None:
    """value: numpy array (dense) or ('row_sparse'|'csr', data, aux, shape)."""
    out.append(struct.pack("<I", _V2_MAGIC))
    if isinstance(value, tuple):
        kind, main, aux, shape = value
        stype = _STYPE_ROW_SPARSE if kind == "row_sparse" else _STYPE_CSR
        out.append(struct.pack("<i", stype))
        _write_tshape(out, main.shape)   # storage shape
        _write_tshape(out, shape)
        out.append(struct.pack("<ii", _CPU_DEV_TYPE, 0))
        out.append(struct.pack("<i", _DTYPE_TO_TYPE_FLAG[main.dtype.name]))
        for a in aux:
            out.append(struct.pack("<i", _DTYPE_TO_TYPE_FLAG[a.dtype.name]))
            _write_tshape(out, a.shape)
        out.append(_np.ascontiguousarray(main).tobytes())
        for a in aux:
            out.append(_np.ascontiguousarray(a).tobytes())
        return
    arr = _np.ascontiguousarray(value)
    out.append(struct.pack("<i", _STYPE_DEFAULT))
    _write_tshape(out, arr.shape)
    out.append(struct.pack("<ii", _CPU_DEV_TYPE, 0))
    out.append(struct.pack("<i", _DTYPE_TO_TYPE_FLAG[arr.dtype.name]))
    out.append(arr.tobytes())


def save_bytes(values, keys) -> bytes:
    """Serialize to the reference format (always V2 records)."""
    out: List[bytes] = [struct.pack("<QQ", MXNET_LIST_MAGIC, 0),
                        struct.pack("<Q", len(values))]
    for v in values:
        _write_ndarray(out, v)
    out.append(struct.pack("<Q", len(keys)))
    for k in keys:
        kb = k.encode()
        out.append(struct.pack("<Q", len(kb)))
        out.append(kb)
    return b"".join(out)

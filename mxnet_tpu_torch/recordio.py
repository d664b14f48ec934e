"""RecordIO files (PyTorch counterpart of ``mxnet_tpu/recordio.py``;
reference: python/mxnet/recordio.py and dmlc's recordio).

The file bytes are the reference's: records framed by the magic
0xced7230a and a length word (lower 29 bits the length, upper 3 a
continuation flag), padded to 4 bytes; a payload holding the magic at a
4-byte boundary is split into parts there.  ``IRHeader`` packs (flag,
label, id, id2) before an image record.  ``pack_img`` encodes through PIL
where PIL can be imported, else as the repo's raw ``RAW0`` blob
(``b"RAW0"``, ndim, int32 shape, uint8 pixels), as the reference does;
``unpack_img`` decodes either.
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as _np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xCED7230A
_LFLAG_BITS = 29

IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


class MXRecordIO:
    """Sequential RecordIO reader/writer (reference: recordio.py MXRecordIO)."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.pid = None
        self.is_open = False
        self.open()

    def open(self):
        mode = "wb" if self.flag == "w" else "rb"
        self.handle = open(self.uri, mode)
        self.pid = os.getpid()
        self.is_open = True

    def close(self):
        if self.is_open:
            self.handle.close()
            self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def _check_pid(self):
        # fork-safety (reference: recordio.py _check_pid): readers reopen in
        # the child; a forked WRITER must raise — reopening 'wb' would
        # truncate everything the parent already wrote
        if self.pid != os.getpid():
            if self.flag == "w":
                raise RuntimeError(
                    "MXRecordIO writer is not fork-safe: the parent holds the "
                    "file; create the writer inside the child process instead")
            self.open()

    def _write_part(self, buf: bytes, cflag: int):
        self.handle.write(struct.pack("<II", _MAGIC,
                                      len(buf) | (cflag << _LFLAG_BITS)))
        self.handle.write(buf)
        pad = (4 - (len(buf) % 4)) % 4
        if pad:
            self.handle.write(b"\x00" * pad)

    def write(self, buf: bytes):
        """Write one logical record, escaping embedded magic words via dmlc
        multipart framing (split at 4-byte-aligned magic occurrences; parts
        carry continuation flags 1/2/3 and readers rejoin with the magic
        re-inserted)."""
        assert self.flag == "w"
        self._check_pid()
        assert len(buf) < (1 << _LFLAG_BITS), "record too large"
        magic_bytes = struct.pack("<I", _MAGIC)
        aligned = len(buf) - (len(buf) % 4)
        words = _np.frombuffer(buf[:aligned], dtype="<u4") if aligned else \
            _np.empty(0, dtype="<u4")
        splits = (4 * _np.flatnonzero(words == _MAGIC)).tolist()
        if not splits:
            self._write_part(buf, 0)
            return
        pos = 0
        bounds = splits + [len(buf)]
        for i, end in enumerate(bounds):
            cflag = 1 if i == 0 else (3 if i == len(bounds) - 1 else 2)
            self._write_part(buf[pos:end], cflag)
            pos = end + len(magic_bytes)  # skip the magic word itself

    def _read_part(self):
        header = self.handle.read(8)
        if len(header) < 8:
            return None, 0
        magic, lrec = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise ValueError(f"{self.uri}: bad record magic {magic:#x}")
        length = lrec & ((1 << _LFLAG_BITS) - 1)
        buf = self.handle.read(length)
        pad = (4 - (length % 4)) % 4
        if pad:
            self.handle.read(pad)
        return buf, lrec >> _LFLAG_BITS

    def read(self):
        """Read one logical record, reassembling multipart payloads (the
        inverse of write's escaping; dmlc recordio semantics)."""
        assert self.flag == "r"
        self._check_pid()
        buf, cflag = self._read_part()
        if buf is None or cflag == 0:
            return buf
        if cflag != 1:
            raise ValueError(f"{self.uri}: stream starts mid-record")
        parts = [buf]
        magic_bytes = struct.pack("<I", _MAGIC)
        while True:
            buf, cflag = self._read_part()
            if buf is None:
                raise ValueError(f"{self.uri}: EOF inside multipart record")
            parts.append(magic_bytes)
            parts.append(buf)
            if cflag == 3:
                return b"".join(parts)
            if cflag != 2:
                raise ValueError(f"{self.uri}: bad continuation flag {cflag}")

    def tell(self):
        return self.handle.tell()

    def seek(self, pos):
        self.handle.seek(pos)

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def _count_records(uri) -> int:
    """The logical records of a file, by its framing alone (payloads
    skipped); a corrupt frame raises ``MXNetError``."""
    n = 0
    with open(uri, "rb") as f:
        while True:
            head = f.read(8)
            if not head:
                return n
            if len(head) < 8:
                raise MXNetError(f"{uri}: truncated record header")
            magic, lrec = struct.unpack("<II", head)
            if magic != _MAGIC:
                raise MXNetError(f"{uri}: bad record magic {magic:#x}")
            length = lrec & ((1 << _LFLAG_BITS) - 1)
            f.seek(length + (4 - length % 4) % 4, 1)
            n += (lrec >> _LFLAG_BITS) in (0, 3)


class MXIndexedRecordIO(MXRecordIO):
    """Indexed RecordIO with .idx sidecar (reference: MXIndexedRecordIO)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)
        if flag == "r" and os.path.exists(idx_path):
            with open(idx_path) as f:
                for line in f:
                    parts = line.strip().split("\t")
                    if len(parts) == 2:
                        key = key_type(parts[0])
                        self.idx[key] = int(parts[1])
                        self.keys.append(key)

    def close(self):
        if self.flag == "w" and self.is_open:
            with open(self.idx_path, "w") as f:
                for k in self.keys:
                    f.write(f"{k}\t{self.idx[k]}\n")
        super().close()

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        self.idx[key] = self.tell()
        self.keys.append(key)
        self.write(buf)


def pack(header: IRHeader, s: bytes) -> bytes:
    header = IRHeader(*header)
    if isinstance(header.label, (list, tuple, _np.ndarray)):
        label = _np.asarray(header.label, dtype=_np.float32)
        header = header._replace(flag=label.size, label=0.0)
        s = label.tobytes() + s
    return struct.pack(_IR_FORMAT, header.flag, header.label, header.id, header.id2) + s


def unpack(s: bytes):
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = _np.frombuffer(s[:header.flag * 4], dtype=_np.float32)
        header = header._replace(label=label)
        s = s[header.flag * 4:]
    return header, s


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image array: JPEG (``.jpg``) or PNG through PIL, or a RAW0
    blob without PIL (the reference encodes with cv2.imencode)."""
    encoded = _encode_image(img, img_fmt, quality)
    return pack(header, encoded)


def unpack_img(s, iscolor=-1):
    header, img_bytes = unpack(s)
    img = _decode_image(img_bytes)
    return header, img


def _encode_image(img: _np.ndarray, fmt: str, quality: int) -> bytes:
    import io as _io

    try:
        from PIL import Image  # optional

        im = Image.fromarray(img.astype(_np.uint8))
        buf = _io.BytesIO()
        im.save(buf, format="JPEG" if fmt in (".jpg", ".jpeg") else "PNG",
                quality=quality)
        return buf.getvalue()
    except ImportError:
        # raw fallback: shape-prefixed uint8 buffer
        shape = _np.asarray(img.shape, dtype=_np.int32)
        return b"RAW0" + struct.pack("<I", len(shape)) + shape.tobytes() + \
            img.astype(_np.uint8).tobytes()


def _decode_image(data: bytes) -> _np.ndarray:
    import io as _io

    if data[:4] == b"RAW0":
        (ndim,) = struct.unpack("<I", data[4:8])
        shape = _np.frombuffer(data[8:8 + 4 * ndim], dtype=_np.int32)
        return _np.frombuffer(data[8 + 4 * ndim:], dtype=_np.uint8).reshape(shape)
    try:
        from PIL import Image

        return _np.asarray(Image.open(_io.BytesIO(data)))
    except ImportError as e:
        raise MXNetError("cannot decode a compressed image without PIL") \
            from e

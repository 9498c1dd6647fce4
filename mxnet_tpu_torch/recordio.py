"""RecordIO — sequential record pack format.

The port's copy of ``mxnet_tpu/recordio.py`` (reference:
`python/mxnet/recordio.py` + dmlc-core recordio); records are byte for
byte the JAX package's.
Format compatible with the reference: each record is
``[kMagic:u32][cflag|len:u32][data][pad to 4B]``, with the same magic and
continuation-flag encoding, so .rec files pack with `tools/im2rec.py` here
read in reference MXNet and vice versa.  IRHeader packing is also
byte-compatible (label/id/id2 struct + optional float array).
"""
from __future__ import annotations

import ctypes
import os
import struct

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img", "build_index"]

_kMagic = 0xCED7230A


class MXRecordIO:
    """Sequential RecordIO reader/writer (reference: recordio.py:12).

    Backed by the native C++ codec (`src/recordio.cc`, dmlc-core recordio
    analog — handles split-record reassembly) when the toolchain built it;
    degrades to a pure-Python codec otherwise."""

    def __init__(self, uri, flag):
        from . import _native

        self.uri = uri
        self.flag = flag
        self.handle = None
        self.is_open = False
        self._lib = _native.recordio_lib()
        self.open()

    def open(self):
        if self.flag == "w":
            self.writable = True
        elif self.flag == "r":
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        if self._lib is not None:
            opener = (self._lib.rio_writer_open if self.writable
                      else self._lib.rio_reader_open)
            self.handle = opener(self.uri.encode())
            if not self.handle:
                from ._native import native_error

                raise MXNetError(native_error(self._lib))
        else:
            self.handle = open(self.uri, "wb" if self.writable else "rb")
        self.is_open = True

    def close(self):
        if self.is_open:
            if self._lib is not None:
                closer = (self._lib.rio_writer_close if self.writable
                          else self._lib.rio_reader_close)
                closer(self.handle)
                self.handle = None
            else:
                self.handle.close()
            self.is_open = False

    def __del__(self):
        self.close()

    def reset(self):
        self.close()
        self.open()

    def tell(self):
        if self._lib is not None:
            teller = (self._lib.rio_writer_tell if self.writable
                      else self._lib.rio_reader_tell)
            return teller(self.handle)
        return self.handle.tell()

    def write(self, buf):
        assert self.writable
        data = bytes(buf)
        if self._lib is not None:
            from ._native import native_error

            if self._lib.rio_writer_write(self.handle, data, len(data)) < 0:
                raise MXNetError(native_error(self._lib))
            return
        if len(data) > 0x1FFFFFFF:
            raise MXNetError("record too large (max 2^29-1 bytes per frame)")

        def part(cflag, payload):
            self.handle.write(struct.pack(
                "<II", _kMagic, (cflag << 29) | len(payload)))
            self.handle.write(payload)
            pad = (4 - len(payload) % 4) % 4
            if pad:
                self.handle.write(b"\x00" * pad)

        # dmlc framing: payloads embedding the magic at 4B-aligned offsets
        # split there, the magic bytes replaced by the next part's header
        # (so chunked magic-scanning readers always hit real boundaries)
        magic_bytes = struct.pack("<I", _kMagic)
        splits = []
        pos = data.find(magic_bytes)
        while pos != -1:
            if pos % 4 == 0:
                splits.append(pos)
                pos = data.find(magic_bytes, pos + 4)
            else:
                pos = data.find(magic_bytes, pos + 1)
        if not splits:
            part(0, data)
            return
        begin = 0
        for k, pos in enumerate(splits):
            part(1 if k == 0 else 2, data[begin:pos])
            begin = pos + 4
        part(3, data[begin:])

    def read(self):
        assert not self.writable
        if self._lib is not None:
            from ._native import native_error

            data_p = ctypes.c_void_p()
            length = ctypes.c_uint64()
            rc = self._lib.rio_reader_next(self.handle,
                                           ctypes.byref(data_p),
                                           ctypes.byref(length))
            if rc == 0:
                return None
            if rc < 0:
                raise MXNetError(native_error(self._lib))
            return ctypes.string_at(data_p, length.value)
        record = None
        while True:
            header = self.handle.read(8)
            if len(header) < 8:
                if record is not None:
                    raise MXNetError("unterminated split record in %s"
                                     % self.uri)
                return None
            magic, lrec = struct.unpack("<II", header)
            if magic != _kMagic:
                raise MXNetError("Invalid RecordIO magic in %s" % self.uri)
            cflag, length = lrec >> 29, lrec & 0x1FFFFFFF
            data = self.handle.read(length)
            pad = (4 - length % 4) % 4
            if pad:
                self.handle.read(pad)
            # dmlc writers split records whose payload embeds the magic:
            # cflag 0 whole, 1 first, 2 middle, 3 last — reassemble
            if record is None:
                if cflag == 0:
                    return data
                if cflag != 1:
                    raise MXNetError("unexpected continuation frame in %s"
                                     % self.uri)
                record = bytearray(data)
            else:
                if cflag not in (2, 3):
                    raise MXNetError("corrupt split-record chain in %s"
                                     % self.uri)
                # restore the magic the writer dropped at the split point
                record.extend(struct.pack("<I", _kMagic))
                record.extend(data)
                if cflag == 3:
                    return bytes(record)


class MXIndexedRecordIO(MXRecordIO):
    """Indexed RecordIO with a .idx sidecar (reference: recordio.py:87)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin.readlines():
                    key, pos = line.strip().split("\t")
                    key = self.key_type(key)
                    self.idx[key] = int(pos)
                    self.keys.append(key)

    def close(self):
        if self.is_open and self.writable:
            with open(self.idx_path, "w") as fout:
                for k in self.keys:
                    fout.write("%s\t%d\n" % (str(k), self.idx[k]))
        super().close()

    def seek(self, idx):
        assert not self.writable
        if self._lib is not None:
            from ._native import native_error

            if self._lib.rio_reader_seek(self.handle, self.idx[idx]) < 0:
                raise MXNetError(native_error(self._lib))
        else:
            self.handle.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        self.idx[key] = self.tell()
        self.keys.append(key)
        self.write(buf)


def build_index(rec_path, idx_path=None):
    """Scan a .rec file and produce its record-start offsets (the .idx
    sidecar `tools/im2rec` emits).  Uses the native scanner when built."""
    from . import _native

    lib = _native.recordio_lib()
    if lib is not None:
        out = ctypes.POINTER(ctypes.c_int64)()
        count = lib.rio_build_index(rec_path.encode(), ctypes.byref(out))
        if count < 0:
            raise MXNetError(_native.native_error(lib))
        offsets = [out[i] for i in range(count)]
        lib.rio_free(out)
    else:
        offsets = []
        reader = MXRecordIO(rec_path, "r")
        while True:
            pos = reader.tell()
            if reader.read() is None:
                break
            offsets.append(pos)
        reader.close()
    if idx_path is not None:
        with open(idx_path, "w") as fout:
            for i, pos in enumerate(offsets):
                fout.write("%d\t%d\n" % (i, pos))
    return offsets


class IRHeader:
    """Image record header (reference: recordio.py:145): flag, label, id, id2."""

    def __init__(self, flag, label, id, id2):
        self.flag = flag
        self.label = label
        self.id = id
        self.id2 = id2

    def __iter__(self):
        return iter((self.flag, self.label, self.id, self.id2))


_IR_FORMAT = "<IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack a (header, bytes) record (reference: recordio.py:157)."""
    flag, label, id_, id2 = tuple(header)
    if isinstance(label, (np.ndarray, list, tuple)):
        label = np.asarray(label, dtype=np.float32)
        flag = label.size
        payload = struct.pack(_IR_FORMAT, flag, 0.0, id_, id2) + label.tobytes() + bytes(s)
    else:
        payload = struct.pack(_IR_FORMAT, flag, float(label), id_, id2) + bytes(s)
    return payload


def unpack(s):
    """Unpack a record into (IRHeader, bytes) (reference: recordio.py:177)."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        arr = np.frombuffer(s[:flag * 4], dtype=np.float32)
        s = s[flag * 4:]
        return IRHeader(flag, arr, id_, id2), s
    return IRHeader(flag, label, id_, id2), s


def unpack_img(s, iscolor=-1):
    """Unpack record into (header, image array) — raw-array codec here;
    JPEG decode requires cv2 (gated the way opencv is in the reference)."""
    header, s = unpack(s)
    try:
        import cv2

        img = cv2.imdecode(np.frombuffer(s, dtype=np.uint8), iscolor)
        if img is not None:
            return header, img
    except ImportError:
        pass
    # raw numpy codec: [ndim:u8][dims:u32*ndim][uint8 data]
    ndim = s[0]
    dims = struct.unpack("<%dI" % ndim, s[1:1 + 4 * ndim])
    img = np.frombuffer(s[1 + 4 * ndim:], dtype=np.uint8).reshape(dims)
    return header, img


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    """Pack an image (cv2 if available, else raw-array codec)."""
    try:
        import cv2

        encode_params = None
        if img_fmt in (".jpg", ".jpeg"):
            encode_params = [cv2.IMWRITE_JPEG_QUALITY, quality]
        elif img_fmt == ".png":
            encode_params = [cv2.IMWRITE_PNG_COMPRESSION, quality]
        ret, buf = cv2.imencode(img_fmt, img, encode_params)
        assert ret
        return pack(header, buf.tobytes())
    except ImportError:
        img = np.ascontiguousarray(img, dtype=np.uint8)
        payload = struct.pack("<B", img.ndim) + \
            struct.pack("<%dI" % img.ndim, *img.shape) + img.tobytes()
        return pack(header, payload)

"""The subset of MessagePack that checkpoint envelopes use, carried in the
port so that it needs no ``msgpack`` package.

:func:`packb` gives, for the types below, the bytes of
``msgpack.packb(obj, use_bin_type=True)``, and :func:`unpackb` reads them
back as ``msgpack.unpackb(data, raw=False)`` does:

* ``None``, ``bool``, ``int`` (the smallest encoding: fixint, uint8–64,
  int8–64), ``float`` (float64; float32 is read too),
* ``str`` (fixstr, str8/16/32), ``bytes``-like (bin8/16/32),
* ``list``/``tuple`` (fixarray, array16/32; read back as lists) and
  ``dict`` (fixmap, map16/32, in insertion order).

Envelopes are large (a full-width Llama-3-8B train state is ~24 GB), so
both directions also stream: :func:`pack` writes through a ``write``
callable, and a :class:`Deferred` value writes its own bytes after its
``bin`` header (a tensor copied to the file chunk by chunk);
:func:`unpack_file` reads a file and leaves every ``bin`` of at least
``lazy_from`` bytes in place as a :class:`Blob` (its offset and length).
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Optional

BIN_MAX = 2**32 - 1     # the largest bin32 (and str32, array32, map32)


class Deferred:
    """A ``bin`` value of ``nbytes`` bytes that ``write_to(write)`` writes
    itself, after :func:`pack` has written its header."""

    def __init__(self, nbytes: int, write_to: Callable[[Callable], None]):
        self.nbytes = int(nbytes)
        self.write_to = write_to


class Blob:
    """A ``bin`` value left in its file: ``length`` bytes at ``offset``."""

    def __init__(self, path: str, offset: int, length: int):
        self.path, self.offset, self.length = path, offset, length

    def __len__(self) -> int:
        return self.length

    def chunks(self, size: int = 64 << 20):
        """The bytes, in pieces of at most ``size``."""
        with open(self.path, "rb") as f:
            f.seek(self.offset)
            left = self.length
            while left:
                piece = f.read(min(size, left))
                if not piece:
                    raise ValueError(f"{self.path}: truncated inside a bin")
                left -= len(piece)
                yield piece

    def pieces_into(self, buf):
        """Read the bytes into the writable buffer ``buf`` a piece at a
        time, yielding each piece's length (the piece is ``buf[:n]``)."""
        view = memoryview(buf).cast("B")
        with open(self.path, "rb", buffering=0) as f:
            f.seek(self.offset)
            left = self.length
            while left:
                n = f.readinto(view[:min(len(view), left)])
                if not n:
                    raise ValueError(f"{self.path}: truncated inside a bin")
                left -= n
                yield n

    def readinto(self, buf) -> None:
        """Fill the writable buffer ``buf`` (``length`` bytes)."""
        view = memoryview(buf).cast("B")
        if len(view) != self.length:
            raise ValueError(f"buffer of {len(view)} bytes for a bin of "
                             f"{self.length}")
        done = 0
        for n in self.pieces_into(view):
            done += n
            view = view[n:]

    def tobytes(self) -> bytes:
        return b"".join(self.chunks())


def _header(write, n: int, fix: Optional[int], fix_max: int, codes) -> None:
    if fix is not None and n <= fix_max:
        write(bytes((fix | n,)))
    elif codes[0] is not None and n < 2**8:
        write(struct.pack(">BB", codes[0], n))
    elif n < 2**16:
        write(struct.pack(">BH", codes[1], n))
    elif n <= BIN_MAX:
        write(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"{n} is too long for MessagePack (at most {BIN_MAX})")


def _pack_int(write, v: int) -> None:
    if -32 <= v < 128:
        write(struct.pack(">b" if v < 0 else ">B", v))
    elif 0 <= v < 2**8:
        write(struct.pack(">BB", 0xCC, v))
    elif -2**7 <= v < 0:
        write(struct.pack(">Bb", 0xD0, v))
    elif 0 <= v < 2**16:
        write(struct.pack(">BH", 0xCD, v))
    elif -2**15 <= v < 0:
        write(struct.pack(">Bh", 0xD1, v))
    elif 0 <= v < 2**32:
        write(struct.pack(">BI", 0xCE, v))
    elif -2**31 <= v < 0:
        write(struct.pack(">Bi", 0xD2, v))
    elif 0 <= v < 2**64:
        write(struct.pack(">BQ", 0xCF, v))
    elif -2**63 <= v < 0:
        write(struct.pack(">Bq", 0xD3, v))
    else:
        raise OverflowError(f"{v} does not fit MessagePack's 64-bit ints")


def pack(obj: Any, write: Callable) -> None:
    """Write ``obj`` through ``write(bytes)``."""
    if obj is None:
        write(b"\xc0")
    elif obj is True or obj is False:
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        _pack_int(write, obj)
    elif isinstance(obj, float):
        write(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _header(write, len(data), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        write(data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = memoryview(obj).cast("B")
        _header(write, len(data), None, -1, (0xC4, 0xC5, 0xC6))
        write(data)
    elif isinstance(obj, Deferred):
        _header(write, obj.nbytes, None, -1, (0xC4, 0xC5, 0xC6))
        obj.write_to(write)
    elif isinstance(obj, (list, tuple)):
        _header(write, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for x in obj:
            pack(x, write)
    elif isinstance(obj, dict):
        pack_map_header(len(obj), write)
        for k, v in obj.items():
            pack(k, write)
            pack(v, write)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} into an envelope")


def pack_map_header(n: int, write: Callable) -> None:
    """The header of a map of ``n`` pairs (the caller packs the pairs)."""
    _header(write, n, 0x80, 15, (None, 0xDE, 0xDF))


def packb(obj: Any) -> bytes:
    out = []
    pack(obj, out.append)
    return b"".join(bytes(x) for x in out)


class _Reader:
    """Decoder state over a bytes-like ``data`` or an open binary file."""

    def __init__(self, data=None, f=None, path=None, size=None,
                 lazy_from=None):
        self.view = None if data is None else memoryview(data).cast("B")
        self.f, self.path, self.lazy_from = f, path, lazy_from
        self.size = len(self.view) if self.view is not None else size
        self.pos = 0

    def take(self, n: int):
        if self.pos + n > self.size:
            raise ValueError(f"truncated: {n} bytes wanted at offset "
                             f"{self.pos} of {self.size}")
        if self.view is not None:
            out = self.view[self.pos:self.pos + n]
        else:
            out = self.f.read(n)
            if len(out) != n:
                raise ValueError(f"truncated at offset {self.pos}")
        self.pos += n
        return out

    def skip(self, n: int) -> None:
        if self.pos + n > self.size:
            raise ValueError(f"truncated: a bin of {n} bytes at offset "
                             f"{self.pos} runs past the end ({self.size})")
        self.pos += n
        if self.f is not None:
            self.f.seek(self.pos)

    def unpack(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.unpack() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self._str(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return self._bin(self._len(b - 0xC4))
        if b in _NUMBERS:
            fmt = _NUMBERS[b]
            return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]
        if b in (0xD9, 0xDA, 0xDB):
            return self._str(self._len(b - 0xD9))
        if b in (0xDC, 0xDD):
            return [self.unpack() for _ in range(self._len(b - 0xDC + 1))]
        if b in (0xDE, 0xDF):
            return self._map(self._len(b - 0xDE + 1))
        raise ValueError(f"unsupported MessagePack type byte {b:#04x} at "
                         f"offset {self.pos - 1}")

    def _len(self, width: int) -> int:
        fmt = (">B", ">H", ">I")[width]
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def _str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def _bin(self, n: int):
        if self.lazy_from is not None and n >= self.lazy_from:
            blob = Blob(self.path, self.pos, n)
            self.skip(n)
            return blob
        return bytes(self.take(n))

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.unpack()
            out[k] = self.unpack()
        return out


_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


def unpackb(data) -> Any:
    """Decode one object that fills ``data`` exactly."""
    r = _Reader(data=data)
    obj = r.unpack()
    if r.pos != r.size:
        raise ValueError(f"{r.size - r.pos} bytes of extra data after the "
                         f"object")
    return obj


def unpack_file(path: str, lazy_from: int = 1 << 16) -> Any:
    """Decode the one object in the file at ``path``; each ``bin`` of at
    least ``lazy_from`` bytes stays in the file as a :class:`Blob`."""
    import os

    with open(path, "rb") as f:
        r = _Reader(f=f, path=path, size=os.fstat(f.fileno()).st_size,
                    lazy_from=lazy_from)
        obj = r.unpack()
    if r.pos != r.size:
        raise ValueError(f"{r.size - r.pos} bytes of extra data after the "
                         f"object")
    return obj

"""Read and write the bytes of ``flax.serialization.to_bytes`` /
``msgpack_serialize`` without ``msgpack`` or ``flax``.

    tree = loads(open("params.msgpack", "rb").read())
    open("params.msgpack", "wb").write(dumps(tree))

Flax writes a nested dict as msgpack maps, each map's keys sorted (its
``tree_map`` copy of the tree sorts them; the reader keeps the order it
finds), and each leaf as an extension: an ndarray is ext type 1 whose payload is itself a
msgpack array ``[shape, dtype name, C-order bytes]`` and a numpy scalar is
ext type 3 with the same payload (0-d). Python ints, floats, bools, None and
strings are native msgpack (flax's ext type 2, a Python complex, is not
read or written). Arrays larger than ``MAX_CHUNK_SIZE`` bytes are written as flax's
chunked form, a map ``{"__msgpack_chunked_array__": True, "shape": {"0":
d0, ...}, "chunks": {"0": flat[0:c], ...}}``, and reassembled on read.

The writer takes msgpack's smallest encoding of every map, array, string,
bin, ext and int (``msgpack.packb(..., use_bin_type=True)``; floats are
float64), so a tree read from flax's bytes and written back gives the same
bytes. Leaves may be numpy arrays and scalars or CPU tensors. ``bfloat16``
leaves are read as ``torch.bfloat16`` tensors (numpy has no bf16 without
``ml_dtypes``); every other array is read as a numpy array viewing one copy
of the input.
"""
from __future__ import annotations

import struct
from typing import Any, List

import numpy as np
import torch

MAX_CHUNK_SIZE = 2**30   # flax.serialization.MAX_CHUNK_SIZE
CHUNK_KEY = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_NPSCALAR = 1, 3


# ------------------------------------------------------------------ writer
def _int(out: List[bytes], x: int) -> None:
    if 0 <= x < 128:
        out.append(struct.pack("B", x))
    elif -32 <= x < 0:
        out.append(struct.pack("b", x))
    elif x >= 0:
        for code, fmt, top in ((0xCC, ">B", 2**8), (0xCD, ">H", 2**16),
                               (0xCE, ">I", 2**32), (0xCF, ">Q", 2**64)):
            if x < top:
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise OverflowError(f"int {x} does not fit in 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -2**7), (0xD1, ">h", -2**15),
                               (0xD2, ">i", -2**31), (0xD3, ">q", -2**63)):
            if x >= low:
                out.append(bytes([code]) + struct.pack(fmt, x))
                return
        raise OverflowError(f"int {x} does not fit in 64 bits")


def _header(out: List[bytes], n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: ``fix | n`` below ``fix_max``, else the first of
    ``codes`` ((code, struct format, bound), ...) that holds n."""
    if fix is not None and n < fix_max:
        out.append(bytes([fix | n]))
        return
    for code, fmt, top in codes:
        if n < top:
            out.append(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack object of length {n} is too large")


_STR = ((0xD9, ">B", 2**8), (0xDA, ">H", 2**16), (0xDB, ">I", 2**32))
_BIN = ((0xC4, ">B", 2**8), (0xC5, ">H", 2**16), (0xC6, ">I", 2**32))
_ARR = ((0xDC, ">H", 2**16), (0xDD, ">I", 2**32))
_MAP = ((0xDE, ">H", 2**16), (0xDF, ">I", 2**32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 2**8), (0xC8, ">H", 2**16), (0xC9, ">I", 2**32))


def _str(out: List[bytes], s: str) -> None:
    b = s.encode("utf-8")
    _header(out, len(b), 0xA0, 32, _STR)
    out.append(b)


def _bin(out: List[bytes], b: bytes) -> None:
    _header(out, len(b), None, 0, _BIN)
    out.append(b)


def _ext(out: List[bytes], code: int, payload: bytes) -> None:
    n = len(payload)
    if n in _FIXEXT:
        out.append(bytes([_FIXEXT[n], code]))
    else:
        _header(out, n, None, 0, _EXT)
        out.append(struct.pack("b", code))
    out.append(payload)


def _array_payload(dtype_name: str, shape, data: bytes) -> bytes:
    out: List[bytes] = []
    _header(out, 3, 0x90, 16, _ARR)
    _header(out, len(shape), 0x90, 16, _ARR)
    for d in shape:
        _int(out, int(d))
    _str(out, dtype_name)
    _bin(out, data)
    return b"".join(out)


def _tensor_parts(t: torch.Tensor):
    """(dtype name, shape, C-order bytes) of a CPU tensor."""
    t = t.detach().contiguous()
    if t.device.type != "cpu":
        raise ValueError("flax_msgpack writes CPU tensors only")
    if t.dtype == torch.bfloat16:
        return "bfloat16", tuple(t.shape), t.view(torch.int16).numpy().tobytes()
    a = t.numpy()
    return a.dtype.name, a.shape, a.tobytes("C")


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunked(x) -> dict:
    """flax's ``_chunk``: the flat array cut into MAX_CHUNK_SIZE pieces."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.numel() if isinstance(flat, torch.Tensor) else flat.size
    return {CHUNK_KEY: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(k): flat[i:i + size]
                       for k, i in enumerate(range(0, n, size))}}


def _map(out: List[bytes], x: dict, sort: bool) -> None:
    """A map, its keys sorted as flax's ``tree_map`` copy sorts them; a
    chunked leaf's maps keep the order ``_chunked`` builds."""
    _header(out, len(x), 0x80, 16, _MAP)
    for k in (sorted(x) if sort else x):
        v = x[k]
        _pack(out, k)
        if isinstance(v, (np.ndarray, torch.Tensor)) and _nbytes(v) > MAX_CHUNK_SIZE:
            _pack_chunked(out, v)
        elif type(v) is dict and not sort:
            _map(out, v, sort=False)
        else:
            _pack(out, v)


def _pack_chunked(out: List[bytes], x) -> None:
    _map(out, _chunked(x), sort=False)


def _pack(out: List[bytes], x: Any) -> None:
    if x is None:
        out.append(b"\xc0")
    elif x is True:
        out.append(b"\xc3")
    elif x is False:
        out.append(b"\xc2")
    elif type(x) is int:
        _int(out, x)
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        _str(out, x)
    elif type(x) is dict:
        _map(out, x, sort=True)
    elif type(x) in (list, tuple):
        _header(out, len(x), 0x90, 16, _ARR)
        for v in x:
            _pack(out, v)
    elif isinstance(x, torch.Tensor):
        _ext(out, EXT_NDARRAY, _array_payload(*_tensor_parts(x)))
    elif isinstance(x, np.ndarray):
        if x.dtype.hasobject or x.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes cannot be written")
        _ext(out, EXT_NDARRAY, _array_payload(x.dtype.name, x.shape, x.tobytes("C")))
    elif isinstance(x, np.generic):
        a = np.asarray(x)
        _ext(out, EXT_NPSCALAR, _array_payload(a.dtype.name, a.shape, a.tobytes("C")))
    else:
        raise TypeError(f"flax_msgpack cannot write {type(x).__name__}")


def dumps(tree: Any) -> bytes:
    """The bytes ``flax.serialization.msgpack_serialize(tree)`` gives."""
    out: List[bytes] = []
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        _pack_chunked(out, tree)
    else:
        _pack(out, tree)
    return b"".join(out)


# ------------------------------------------------------------------ reader
class _Reader:
    def __init__(self, buf: memoryview):
        self.buf, self.pos = buf, 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        b = self.buf[self.pos:self.pos + n]
        self.pos += n
        return b

    def unpack(self, fmt: str) -> int:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, raw: bool = False) -> Any:
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F, raw)
        if 0x90 <= c <= 0x9F:
            return [self.obj(raw) for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.string(c & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if c in ints:
            return self.unpack(ints[c])
        if c == 0xCA:
            return self.unpack(">f")
        if c == 0xCB:
            return self.unpack(">d")
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xD9: ">B", 0xDA: ">H",
                   0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H", 0xDF: ">I",
                   0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if c in (0xC4, 0xC5, 0xC6):   # the ndarray payload (raw) keeps a view
            b = self.take(self.unpack(lengths[c]))
            return b if raw else bytes(b)
        if c in (0xD9, 0xDA, 0xDB):
            return self.string(self.unpack(lengths[c]), raw)
        if c in (0xDC, 0xDD):
            return [self.obj(raw) for _ in range(self.unpack(lengths[c]))]
        if c in (0xDE, 0xDF):
            return self.map(self.unpack(lengths[c]), raw)
        if c in (0xC7, 0xC8, 0xC9):
            n = self.unpack(lengths[c])
            return self.ext(self.unpack("b"), self.take(n))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixext:
            code = self.unpack("b")
            return self.ext(code, self.take(fixext[c]))
        raise ValueError(f"unknown msgpack byte 0x{c:02x}")

    def string(self, n: int, raw: bool):
        b = self.take(n)
        return bytes(b) if raw else str(b, "utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj(raw)
            out[k] = self.obj(raw)
        return out

    def ext(self, code: int, data: memoryview) -> Any:
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            shape, name, buf = _Reader(data).obj(raw=True)
            arr = _array(bytes(name).decode(), tuple(shape), buf)
            if code == EXT_NPSCALAR:
                return arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]
            return arr
        raise ValueError(f"unknown msgpack ext type {code}")


def _array(name: str, shape, buf: memoryview):
    if name == "bfloat16":
        return torch.frombuffer(buf, dtype=torch.int16).view(torch.bfloat16).reshape(shape) \
            if len(buf) else torch.zeros(shape, dtype=torch.bfloat16)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape, order="C")


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(x: Any) -> Any:
    if isinstance(x, dict):
        if CHUNK_KEY in x:
            return _unchunk(x)
        for k, v in x.items():
            x[k] = _unchunk_tree(v)
    return x


def loads(data: bytes) -> Any:
    """The tree ``flax.serialization.msgpack_restore(data)`` gives; arrays
    view one writable copy of ``data``."""
    r = _Reader(memoryview(bytearray(data)))
    tree = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes left after the msgpack object")
    return _unchunk_tree(tree)

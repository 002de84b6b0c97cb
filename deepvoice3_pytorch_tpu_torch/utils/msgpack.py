# coding: utf-8
"""The msgpack wire format of flax.serialization, in pure Python.

The JAX package writes its checkpoints with `flax.serialization.
msgpack_serialize` (deepvoice3_pytorch_tpu/training/checkpoint.py); the
card's machine has neither flax nor msgpack, so the port reads and writes
the same bytes here:

  * maps, arrays, str, bin, nil, bool, ints and floats of every width;
  * ext type 1, a numpy array: the msgpack triple (shape, dtype name,
    C-order bytes);
  * ext type 3, a numpy scalar in the same triple.

`packb` encodes as msgpack-python does with `use_bin_type=True`: the
smallest representation of each int, float64 for floats, dict entries in
insertion order; tuples and lists both become arrays, and arrays decode as
lists. `unpackb` refuses anything else (other ext types, flax's chunked
arrays of more than 2**30 bytes, trailing bytes) with a ValueError.
"""

import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3


class _Writer:
    def __init__(self):
        self.parts = []

    def put(self, b):
        self.parts.append(b)

    def obj(self, x):
        if x is None:
            self.put(b"\xc0")
        elif x is True:
            self.put(b"\xc3")
        elif x is False:
            self.put(b"\xc2")
        elif isinstance(x, np.ndarray):
            self.ext(EXT_NDARRAY, _array_triple(x))
        elif isinstance(x, np.generic):
            self.ext(EXT_NPSCALAR, _array_triple(np.asarray(x)))
        elif isinstance(x, int):
            self.int(x)
        elif isinstance(x, float):
            self.put(b"\xcb" + struct.pack(">d", x))
        elif isinstance(x, str):
            self.str(x)
        elif isinstance(x, bytes):
            self.bin(x)
        elif isinstance(x, (list, tuple)):
            self.header(len(x), 0x90, 16, b"\xdc", b"\xdd")
            for v in x:
                self.obj(v)
        elif isinstance(x, dict):
            self.header(len(x), 0x80, 16, b"\xde", b"\xdf")
            for k, v in x.items():
                self.obj(k)
                self.obj(v)
        else:
            raise TypeError("cannot pack %s" % type(x).__name__)

    def header(self, n, fix, fix_limit, tag16, tag32):
        if n < fix_limit:
            self.put(bytes([fix | n]))
        elif n <= 0xFFFF:
            self.put(tag16 + struct.pack(">H", n))
        else:
            self.put(tag32 + struct.pack(">I", n))

    def int(self, x):
        if 0 <= x < 0x80:
            self.put(bytes([x]))
        elif -32 <= x < 0:
            self.put(struct.pack(">b", x))
        elif x >= 0:
            for tag, fmt, top in ((b"\xcc", ">B", 0xFF),
                                  (b"\xcd", ">H", 0xFFFF),
                                  (b"\xce", ">I", 0xFFFFFFFF),
                                  (b"\xcf", ">Q", 0xFFFFFFFFFFFFFFFF)):
                if x <= top:
                    self.put(tag + struct.pack(fmt, x))
                    return
            raise OverflowError("int too large for msgpack: %d" % x)
        else:
            for tag, fmt, low in ((b"\xd0", ">b", -0x80),
                                  (b"\xd1", ">h", -0x8000),
                                  (b"\xd2", ">i", -0x80000000),
                                  (b"\xd3", ">q", -0x8000000000000000)):
                if x >= low:
                    self.put(tag + struct.pack(fmt, x))
                    return
            raise OverflowError("int too small for msgpack: %d" % x)

    def str(self, s):
        b = s.encode("utf-8")
        n = len(b)
        if n < 32:
            self.put(bytes([0xA0 | n]))
        elif n <= 0xFF:
            self.put(b"\xd9" + struct.pack(">B", n))
        elif n <= 0xFFFF:
            self.put(b"\xda" + struct.pack(">H", n))
        else:
            self.put(b"\xdb" + struct.pack(">I", n))
        self.put(b)

    def bin(self, b):
        n = len(b)
        if n <= 0xFF:
            self.put(b"\xc4" + struct.pack(">B", n))
        elif n <= 0xFFFF:
            self.put(b"\xc5" + struct.pack(">H", n))
        else:
            self.put(b"\xc6" + struct.pack(">I", n))
        self.put(b)

    def ext(self, code, data):
        n = len(data)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self.put(bytes([fixed[n], code]))
        elif n <= 0xFF:
            self.put(b"\xc7" + struct.pack(">Bb", n, code))
        elif n <= 0xFFFF:
            self.put(b"\xc8" + struct.pack(">Hb", n, code))
        else:
            self.put(b"\xc9" + struct.pack(">Ib", n, code))
        self.put(data)


def _array_triple(arr):
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be packed")
    return packb((arr.shape, arr.dtype.name, arr.tobytes("C")))


def packb(obj):
    """Encode `obj` (dicts, lists, tuples, str, bytes, None, bools, ints,
    floats, numpy arrays and scalars) as flax's msgpack_serialize does."""
    w = _Writer()
    w.obj(obj)
    return b"".join(w.parts)


class _Reader:
    def __init__(self, data, raw=False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.text(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: (">B", "bin"), 0xC5: (">H", "bin"),
                 0xC6: (">I", "bin"), 0xD9: (">B", "str"),
                 0xDA: (">H", "str"), 0xDB: (">I", "str"),
                 0xDC: (">H", "array"), 0xDD: (">I", "array"),
                 0xDE: (">H", "map"), 0xDF: (">I", "map"),
                 0xC7: (">B", "ext"), 0xC8: (">H", "ext"),
                 0xC9: (">I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return bytes(self.take(n))
            if kind == "str":
                return self.text(n)
            if kind == "array":
                return [self.obj() for _ in range(n)]
            if kind == "map":
                return self.map(n)
            return self.ext(self.unpack(">b"), n)
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(self.unpack(">b"), fixext[b])
        raise ValueError("unsupported msgpack type byte 0x%02x" % b)

    def text(self, n):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        if "__msgpack_chunked_array__" in out:
            raise ValueError("flax's chunked arrays (leaves over 2**30 "
                             "bytes) are not supported")
        return out

    def ext(self, code, n):
        data = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError("unsupported msgpack ext type %d" % code)
        inner = _Reader(data, raw=True)
        shape, dtype, buf = inner.obj()
        if inner.pos != len(data):
            raise ValueError("trailing bytes in a packed array")
        dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
        if dtype == "bfloat16":
            raise ValueError("bfloat16 arrays are not supported")
        arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
        return arr[()] if code == EXT_NPSCALAR else arr


def unpackb(data):
    """Decode bytes written by `packb` or flax's msgpack_serialize: maps
    become dicts, arrays lists, ext 1 numpy arrays (read-only views of the
    data) and ext 3 numpy scalars."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out

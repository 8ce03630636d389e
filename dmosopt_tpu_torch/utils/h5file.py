"""HDF5 files read and written with numpy and the standard library.

The port's results stores and service checkpoints are HDF5 files (their
layout is in `dmosopt_tpu_torch.storage`), and a file written by either
package loads in the other. This module reads and writes the part of
HDF5 those files use, in the form h5py writes by default (libver
"earliest"), so it needs no h5py:

- superblock version 0 at offset 0, 8-byte offsets and lengths;
- version-1 object headers, with continuation blocks;
- symbol-table groups: a version-1 B-tree of type 0, symbol-table nodes
  and a local heap;
- layout message version 3: contiguous, and chunked with a version-1
  B-tree of type 1 and no filters;
- little-endian IEEE float32 and float64, signed and unsigned
  integers of 8 to 64 bits; ``bool`` as h5py
  stores it, an enum over int8 with FALSE = 0 and TRUE = 1;
  variable-length UTF-8 and ASCII strings in global-heap collections;
  fixed-length strings;
- scalar and simple dataspaces, attributes in the object header.

Anything else raises `UnsupportedFormat`, naming what it met: filters
and compression, big-endian or other non-IEEE numbers, compound,
array, reference, opaque, bitfield and other enum types,
variable-length sequences, superblocks of another version or after a
user block, version-2 object headers, new-style groups (link
messages), dense attribute storage, compact, external, virtual or
shared storage.

The surface is what the port's callers use of h5py's: `File(path,
mode)` with modes "r", "r+", "a" and "w", as a context manager; groups
with relative paths in ``[]``, ``in`` and ``get``, ``keys()``, iteration,
`create_group`, `create_dataset`, ``grp[name] = array`` and ``del
grp[name]``; datasets with ``shape``, ``dtype``, ``maxshape``,
``chunks``, `resize` and reads and writes through ``[...]``; ``attrs``
on both. Values read back as h5py returns them: a string attribute as
`str`, a string dataset as `bytes`, numbers as numpy scalars and
arrays.

Opening reads the whole file and parses its tree; a dataset's values
are decoded from those bytes when it is first indexed. A writing open
("r+", "a", "w") holds an exclusive `fcntl.flock` on the file from open
to close, so a read, check and write within one open (the service
checkpoint's lease claim) excludes every other writer. At close, if
anything changed, the whole tree is written to a temporary file beside
the target, fsynced and `os.replace`d over it: a crash or a failed
write leaves the old file or the new one, never a torn one. An
exception raised inside the ``with`` block discards the open's changes.
"""

from __future__ import annotations

import fcntl
import os
import struct
import tempfile
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["File", "Group", "Dataset", "AttributeManager", "UnsupportedFormat"]

_UNDEF = 0xFFFFFFFFFFFFFFFF
_SIGNATURE = b"\x89HDF\r\n\x1a\n"

# B-tree and symbol-node capacities of a version-0 superblock: group
# leaf K 4 (8 entries a node), group internal K 16 (32 children), chunk
# K 32 (64 children). Nodes are written at full capacity, as the HDF5
# library allocates them, so it can insert into them in place.
_GROUP_LEAF_K = 4
_GROUP_NODE_K = 16
_CHUNK_K = 32

# h5py's chunk-shape rule (`h5py._hl.filters.guess_chunk`)
_CHUNK_BASE = 16 * 1024
_CHUNK_MIN = 8 * 1024
_CHUNK_MAX = 1024 * 1024

# IEEE layouts by size: (precision, exponent location, exponent size,
# mantissa location, mantissa size, exponent bias)
_IEEE = {
    4: (32, 23, 8, 0, 23, 127),
    8: (64, 52, 11, 0, 52, 1023),
}

_VLEN_RECORD = np.dtype([("len", "<u4"), ("addr", "<u8"), ("idx", "<u4")])

# header messages that carry nothing the stores read
_SKIPPED_MESSAGES = {
    0x0000,  # NIL
    0x0004,  # fill value (old)
    0x0005,  # fill value
    0x000D,  # object comment
    0x000E,  # modification time (old)
    0x0012,  # modification time
    0x0016,  # object reference count
}
_REFUSED_MESSAGES = {
    0x0002: "a link info message (a new-style group)",
    0x0006: "a link message (a new-style group)",
    0x000A: "a group info message (a new-style group)",
    0x0007: "external data files",
    0x000B: "a filter pipeline (compression or another filter)",
    0x000F: "a shared message table",
    0x0013: "a B-tree 'K' values message",
    0x0014: "a driver info message",
    0x0015: "an attribute info message (dense attribute storage)",
    0x0017: "a file space info message",
}
_CLASS_NAMES = {
    2: "time", 4: "bitfield", 5: "opaque", 6: "compound", 7: "reference",
    10: "array", 11: "complex",
}


class UnsupportedFormat(ValueError):
    """The file uses a part of HDF5 that this module does not read or
    write; the message names it."""


def _pad8(n: int) -> int:
    return (n + 7) // 8 * 8


def _prod(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _guess_chunk(shape, typesize: int) -> Tuple[int, ...]:
    """The chunk shape h5py picks for a resizable dataset: halve the
    axes in turn from the dataset's extent (1024 for an empty axis)
    until the chunk is near a size that grows with the dataset's."""
    chunks = np.array([s if s != 0 else 1024 for s in shape], dtype=np.float64)
    dset_size = float(np.prod(chunks)) * typesize
    target = _CHUNK_BASE * (2 ** np.log10(dset_size / (1024.0 * 1024)))
    target = min(max(target, _CHUNK_MIN), _CHUNK_MAX)
    idx = 0
    while True:
        chunk_bytes = float(np.prod(chunks)) * typesize
        if (
            chunk_bytes < target or abs(chunk_bytes - target) / target < 0.5
        ) and chunk_bytes < _CHUNK_MAX:
            break
        if np.prod(chunks) == 1:
            break
        chunks[idx % len(shape)] = np.ceil(chunks[idx % len(shape)] / 2.0)
        idx += 1
    return tuple(int(c) for c in chunks)


# --------------------------------------------------------------- types
#
# A stored type is a (kind, dtype) pair: kind "num" (numbers, in their
# numpy dtype), "bool" (an int8 enum, numpy bool in memory), "vstr" (a
# variable-length string; the dtype is object, holding bytes) or "fstr"
# (a fixed-length string, numpy "S<n>").


def _storage_dtype(kind: str, dtype: np.dtype) -> np.dtype:
    """The dtype of one element as it lies in the file."""
    if kind == "bool":
        return np.dtype(np.int8)
    if kind == "vstr":
        return _VLEN_RECORD
    return dtype


def _to_stored(value, dtype=None) -> Tuple[str, np.dtype, np.ndarray]:
    """A value given to an attribute or dataset -> (kind, dtype, array),
    as h5py converts it: `str` and `bytes` become variable-length
    strings, numpy unicode arrays and lists of strings arrays of them,
    bool an enum, and other numbers their own dtype. Raises TypeError
    for anything without such a type, as h5py does, so callers can fall
    back to a string."""
    if dtype is not None:
        arr = np.asarray(value, dtype=np.dtype(dtype))
    elif isinstance(value, (str, bytes)):
        arr = np.empty((), dtype=object)
        arr[()] = value
    else:
        arr = np.asarray(value)
    kind = arr.dtype.kind
    if kind in "UO":
        flat = arr.reshape(-1)
        if not all(isinstance(v, (str, bytes)) for v in flat):
            raise TypeError(
                f"object dtype {arr.dtype} has no HDF5 equivalent here "
                f"(only strings are stored from object arrays)"
            )
        out = np.empty(arr.shape, dtype=object)
        out.reshape(-1)[:] = [
            v.encode("utf-8") if isinstance(v, str) else bytes(v) for v in flat
        ]
        return "vstr", np.dtype(object), out
    if kind == "S":
        return "fstr", arr.dtype, arr
    if kind == "b":
        return "bool", np.dtype(bool), arr.astype(bool)
    if kind in "iu" and arr.dtype.itemsize in (1, 2, 4, 8):
        dt = arr.dtype.newbyteorder("<")
        return "num", dt, arr.astype(dt)
    if kind == "f" and arr.dtype.itemsize in _IEEE:
        dt = arr.dtype.newbyteorder("<")
        return "num", dt, arr.astype(dt)
    raise TypeError(f"numpy dtype {arr.dtype} has no HDF5 type in this module")


# -------------------------------------------------------------- reading


class _Reader:
    """Parses one file's bytes: its tree, attributes and data."""

    def __init__(self, buf: bytes, path: str):
        self.buf = buf
        self.path = path
        if buf[:8] != _SIGNATURE:
            raise UnsupportedFormat(f"{path}: no HDF5 signature at offset 0")
        self._collections: Dict[int, Dict[int, Tuple[int, int]]] = {}
        self._visited: set = set()

    def _u(self, off: int, n: int) -> int:
        return int.from_bytes(self.buf[off:off + n], "little")

    def _at(self, addr: int) -> int:
        if addr >= len(self.buf):
            raise UnsupportedFormat(
                f"{self.path}: address {addr:#x} lies outside the file"
            )
        return addr

    def root(self) -> "Group":
        version = self.buf[8]
        if version != 0:
            raise UnsupportedFormat(
                f"{self.path}: superblock version {version}; only version 0 "
                f"(libver 'earliest') is read"
            )
        if self.buf[13] != 8 or self.buf[14] != 8:
            raise UnsupportedFormat(
                f"{self.path}: {self.buf[13]}-byte offsets and {self.buf[14]}-byte "
                f"lengths; only 8-byte ones are read"
            )
        # the root group's symbol-table entry follows the 56-byte prefix
        return self._object(self._u(56 + 8, 8), "/")

    # ------------------------------------------------- object headers

    def _messages(self, addr: int, where: str):
        p = self._at(addr)
        if self.buf[p:p + 4] == b"OHDR":
            raise UnsupportedFormat(f"{self.path}: {where} has a version-2 object header")
        if self.buf[p] != 1:
            raise UnsupportedFormat(
                f"{self.path}: {where} has object header version {self.buf[p]}"
            )
        chunks = [(p + 16, self._u(p + 8, 4))]
        out = []
        i = 0
        while i < len(chunks):
            start, length = chunks[i]
            i += 1
            q, end = start, start + length
            while q + 8 <= end:
                mtype, msize, flags = (
                    self._u(q, 2), self._u(q + 2, 2), self.buf[q + 4]
                )
                body = q + 8
                if body + msize > end:
                    raise UnsupportedFormat(
                        f"{self.path}: {where}: a header message overruns its chunk"
                    )
                if mtype == 0x0010:
                    chunks.append((self._at(self._u(body, 8)), self._u(body + 8, 8)))
                else:
                    out.append((mtype, flags, body))
                q = body + msize
        return out

    def _object(self, addr: int, where: str):
        if addr in self._visited:
            raise UnsupportedFormat(
                f"{self.path}: {where} links an object a second time (a hard link)"
            )
        self._visited.add(addr)
        attrs: Dict[str, tuple] = {}
        stab = space = stype = layout = None
        for mtype, flags, body in self._messages(addr, where):
            if flags & 0x02:
                raise UnsupportedFormat(
                    f"{self.path}: {where} has a shared header message "
                    f"(type {mtype:#06x}, e.g. a committed datatype)"
                )
            if mtype == 0x0011:
                stab = (self._u(body, 8), self._u(body + 8, 8))
            elif mtype == 0x0001:
                space = self._dataspace(body, where)
            elif mtype == 0x0003:
                stype = self._datatype(body, where)[0]
            elif mtype == 0x0008:
                layout = body
            elif mtype == 0x000C:
                name, value = self._attribute(body, where)
                attrs[name] = value
            elif mtype in _REFUSED_MESSAGES:
                raise UnsupportedFormat(
                    f"{self.path}: {where} has {_REFUSED_MESSAGES[mtype]}"
                )
            elif mtype not in _SKIPPED_MESSAGES:
                raise UnsupportedFormat(
                    f"{self.path}: {where} has header message type {mtype:#06x}"
                )
        if stab is not None:
            group = Group(None, where)
            group.attrs._values = attrs
            for name, child in self._links(stab[0], stab[1], where):
                path = where.rstrip("/") + "/" + name
                node = self._object(child, path)
                node._parent = group
                group._children[name] = node
            return group
        if space is None or stype is None or layout is None:
            raise UnsupportedFormat(f"{self.path}: {where} is neither a group nor a dataset")
        shape, maxshape = space
        kind, dtype = stype
        storage, chunks = self._layout(layout, shape, kind, dtype, where)
        dset = Dataset(None, where, kind, dtype, shape, maxshape, chunks, loader=storage)
        dset.attrs._values = attrs
        return dset

    # ------------------------------------------------------- groups

    def _links(self, btree: int, heap: int, where: str):
        h = self._at(heap)
        if self.buf[h:h + 4] != b"HEAP":
            raise UnsupportedFormat(f"{self.path}: {where}: no local heap at {heap:#x}")
        names = self._at(self._u(h + 24, 8))
        out = []
        stack = [btree]
        while stack:
            node = self._at(stack.pop())
            if self.buf[node:node + 4] != b"TREE" or self.buf[node + 4] != 0:
                raise UnsupportedFormat(f"{self.path}: {where}: bad group B-tree node")
            level, n = self.buf[node + 5], self._u(node + 6, 2)
            children = [self._u(node + 24 + 8 + 16 * i, 8) for i in range(n)]
            if level > 0:
                stack.extend(reversed(children))
                continue
            for snod in children:
                s = self._at(snod)
                if self.buf[s:s + 4] != b"SNOD":
                    raise UnsupportedFormat(f"{self.path}: {where}: bad symbol-table node")
                for j in range(self._u(s + 6, 2)):
                    e = s + 8 + 40 * j
                    name_at = names + self._u(e, 8)
                    name = self.buf[name_at:self.buf.index(b"\0", name_at)]
                    out.append((name.decode("utf-8"), self._u(e + 8, 8)))
        return out

    # ------------------------------------------- types and dataspaces

    def _dataspace(self, off: int, where: str):
        version, rank, flags = self.buf[off], self.buf[off + 1], self.buf[off + 2]
        if version == 1:
            p = off + 8
        elif version == 2:
            if self.buf[off + 3] == 2:
                raise UnsupportedFormat(f"{self.path}: {where} has a null dataspace")
            p = off + 4
        else:
            raise UnsupportedFormat(f"{self.path}: {where}: dataspace version {version}")
        shape = tuple(self._u(p + 8 * i, 8) for i in range(rank))
        if flags & 0x01:
            p += 8 * rank
            maxshape = tuple(
                None if v == _UNDEF else v
                for v in (self._u(p + 8 * i, 8) for i in range(rank))
            )
        else:
            maxshape = shape
        return shape, maxshape

    def _datatype(self, off: int, where: str):
        """(kind, dtype) and the message's length in bytes."""
        b0 = self.buf[off]
        cls, version = b0 & 0x0F, b0 >> 4
        bits = self._u(off + 1, 3)
        size = self._u(off + 4, 4)
        if cls in (0, 1) and bits & 0x01:
            raise UnsupportedFormat(f"{self.path}: {where}: a big-endian number")
        if cls == 0:
            offset, precision = self._u(off + 8, 2), self._u(off + 10, 2)
            if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
                raise UnsupportedFormat(
                    f"{self.path}: {where}: a {size}-byte integer of bit offset "
                    f"{offset} and precision {precision}"
                )
            code = "i" if bits & 0x08 else "u"
            return ("num", np.dtype(f"<{code}{size}")), 12
        if cls == 1:
            layout = (
                self._u(off + 10, 2), self.buf[off + 12], self.buf[off + 13],
                self.buf[off + 14], self.buf[off + 15], self._u(off + 16, 4),
            )
            if bits & 0x40 or _IEEE.get(size) != layout or self._u(off + 8, 2):
                raise UnsupportedFormat(
                    f"{self.path}: {where}: a {size}-byte float that is not IEEE"
                )
            return ("num", np.dtype(f"<f{size}")), 20
        if cls == 3:
            return ("fstr", np.dtype(f"S{size}")), 8
        if cls == 8:
            (_, base), blen = self._datatype(off + 8, where)
            p = off + 8 + blen
            names = []
            for _ in range(bits & 0xFFFF):
                end = self.buf.index(b"\0", p)
                names.append(self.buf[p:end].decode())
                p = end + 1 if version >= 3 else p + _pad8(end - p + 1)
            values = np.frombuffer(self.buf, base, len(names), p).tolist()
            p += len(names) * base.itemsize
            members = dict(zip(names, values))
            if base == np.dtype("i1") and members == {"FALSE": 0, "TRUE": 1}:
                return ("bool", np.dtype(bool)), p - off
            raise UnsupportedFormat(f"{self.path}: {where}: an enum type {members}")
        if cls == 9:
            if bits & 0x0F != 1:
                raise UnsupportedFormat(
                    f"{self.path}: {where}: a variable-length sequence type"
                )
            _, blen = self._datatype(off + 8, where)
            return ("vstr", np.dtype(object)), 8 + blen
        name = _CLASS_NAMES.get(cls, f"class-{cls}")
        raise UnsupportedFormat(f"{self.path}: {where}: a {name} datatype")

    def _attribute(self, off: int, where: str):
        version = self.buf[off]
        if version not in (1, 2, 3):
            raise UnsupportedFormat(f"{self.path}: {where}: attribute version {version}")
        if version >= 2 and self.buf[off + 1]:
            raise UnsupportedFormat(
                f"{self.path}: {where}: an attribute with a shared datatype or dataspace"
            )
        nsize, tsize, ssize = self._u(off + 2, 2), self._u(off + 4, 2), self._u(off + 6, 2)
        pad = _pad8 if version == 1 else (lambda n: n)
        p = off + 8 + (1 if version == 3 else 0)
        name = self.buf[p:p + nsize].split(b"\0", 1)[0].decode("utf-8")
        p += pad(nsize)
        (kind, dtype), _ = self._datatype(p, f"{where} attribute {name!r}")
        p += pad(tsize)
        shape, _ = self._dataspace(p, f"{where} attribute {name!r}")
        p += pad(ssize)
        raw = np.frombuffer(
            self.buf, _storage_dtype(kind, dtype), _prod(shape), p
        ).reshape(shape)
        return name, (kind, dtype, self._finish(kind, dtype, raw))

    # ---------------------------------------------------------- data

    def _finish(self, kind: str, dtype: np.dtype, raw: np.ndarray) -> np.ndarray:
        """Elements as they lie in the file -> the in-memory array."""
        if kind == "bool":
            return raw != 0
        if kind == "vstr":
            out = np.empty(raw.shape, dtype=object)
            flat = raw.reshape(-1)
            out.reshape(-1)[:] = [self._vlen(r) for r in flat] if flat.size else []
            return out
        return raw.copy()

    def _vlen(self, rec) -> bytes:
        length, addr, idx = int(rec["len"]), int(rec["addr"]), int(rec["idx"])
        if length == 0:
            return b""
        objects = self._collections.get(addr)
        if objects is None:
            objects = self._collection(addr)
            self._collections[addr] = objects
        start, size = objects[idx]
        return bytes(self.buf[start:start + min(length, size)])

    def _collection(self, addr: int) -> Dict[int, Tuple[int, int]]:
        p = self._at(addr)
        if self.buf[p:p + 4] != b"GCOL":
            raise UnsupportedFormat(f"{self.path}: no global heap collection at {addr:#x}")
        end = p + self._u(p + 8, 8)
        objects = {}
        q = p + 16
        while q + 16 <= end:
            idx, size = self._u(q, 2), self._u(q + 8, 8)
            if idx == 0:
                if size < 16:
                    break
                q += size
                continue
            objects[idx] = (q + 16, size)
            q += 16 + _pad8(size)
        return objects

    def _layout(self, off: int, shape, kind, dtype, where: str):
        """(a loader of the dataset's array, its chunk shape or None)."""
        version, cls = self.buf[off], self.buf[off + 1]
        if version != 3:
            raise UnsupportedFormat(f"{self.path}: {where}: layout message version {version}")
        sdt = _storage_dtype(kind, dtype)
        n = _prod(shape)
        if cls == 1:
            addr = self._u(off + 2, 8)

            def contiguous():
                if addr == _UNDEF or n == 0:
                    raw = np.zeros(shape, dtype=sdt)
                else:
                    raw = np.frombuffer(self.buf, sdt, n, self._at(addr)).reshape(shape)
                return self._finish(kind, dtype, raw)

            return contiguous, None
        if cls == 2:
            ndims = self.buf[off + 2]
            root = self._u(off + 3, 8)
            chunk = tuple(self._u(off + 11 + 4 * i, 4) for i in range(ndims - 1))
            return (lambda: self._finish(
                kind, dtype, self._chunked(root, chunk, shape, sdt, where)
            )), chunk
        name = {0: "compact", 3: "virtual"}.get(cls, f"class-{cls}")
        raise UnsupportedFormat(f"{self.path}: {where}: {name} storage")

    def _chunked(self, root: int, chunk, shape, sdt, where: str) -> np.ndarray:
        out = np.zeros(shape, dtype=sdt)
        if root == _UNDEF or out.size == 0:
            return out
        rank = len(shape)
        key_size = 8 + 8 * (rank + 1)
        per_chunk = _prod(chunk)
        stack = [root]
        while stack:
            node = self._at(stack.pop())
            if self.buf[node:node + 4] != b"TREE" or self.buf[node + 4] != 1:
                raise UnsupportedFormat(f"{self.path}: {where}: bad chunk B-tree node")
            level, n = self.buf[node + 5], self._u(node + 6, 2)
            p = node + 24
            for _ in range(n):
                key, child = p, self._u(p + key_size, 8)
                p += key_size + 8
                if level > 0:
                    stack.append(child)
                    continue
                if self._u(key + 4, 4):
                    raise UnsupportedFormat(f"{self.path}: {where}: a filtered chunk")
                origin = [self._u(key + 8 + 8 * d, 8) for d in range(rank)]
                if any(o >= s for o, s in zip(origin, shape)):
                    continue
                data = np.frombuffer(
                    self.buf, sdt, per_chunk, self._at(child)
                ).reshape(chunk)
                dst = tuple(
                    slice(o, min(o + c, s)) for o, c, s in zip(origin, chunk, shape)
                )
                src = tuple(slice(0, d.stop - d.start) for d in dst)
                out[dst] = data[src]
        return out


# -------------------------------------------------------------- writing


class _Writer:
    """Serializes a tree into one file image, objects in post-order so
    every address is known when the header that holds it is written."""

    def __init__(self):
        self.out = bytearray(96)
        self._heap: Optional[List[int]] = None  # [address, size, used, next index]
        self._heaps: List[List[int]] = []

    def _alloc(self, data: bytes) -> int:
        addr = len(self.out)
        self.out += data
        self.out += bytes(_pad8(len(data)) - len(data))
        return addr

    def image(self, root: "Group") -> bytearray:
        addr, btree, heap = self._group(root)
        for h in self._heaps:
            self._close_collection(h)
        eof = len(self.out)
        self.out[0:96] = (
            _SIGNATURE
            + bytes([0, 0, 0, 0, 0, 8, 8, 0])
            + struct.pack("<HHI", _GROUP_LEAF_K, _GROUP_NODE_K, 0)
            + struct.pack("<QQQQ", 0, _UNDEF, eof, _UNDEF)
            + struct.pack("<QQII", 0, addr, 1, 0)
            + struct.pack("<QQ", btree, heap)
        )
        return self.out

    # ----------------------------------------- global heap (strings)

    def _vlen(self, data: bytes) -> bytes:
        if not data:
            return struct.pack("<IQI", 0, 0, 0)
        need = 16 + _pad8(len(data))
        h = self._heap
        if h is None or h[1] - h[2] < need:
            size = max(4096, 16 + need)
            h = [self._alloc(bytes(size)), size, 16, 1]
            self.out[h[0]:h[0] + 16] = b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size)
            self._heap = h
            self._heaps.append(h)
        at = h[0] + h[2]
        self.out[at:at + 16] = struct.pack("<HH4xQ", h[3], 0, len(data))
        self.out[at + 16:at + 16 + len(data)] = data
        ref = struct.pack("<IQI", len(data), h[0], h[3])
        h[2] += need
        h[3] += 1
        return ref

    def _close_collection(self, h):
        free = h[1] - h[2]
        if free >= 16:
            at = h[0] + h[2]
            self.out[at:at + 16] = struct.pack("<HH4xQ", 0, 0, free)

    # ------------------------------------------- types and messages

    @staticmethod
    def _datatype(kind: str, dtype: np.dtype) -> bytes:
        if kind == "bool":
            base = _Writer._datatype("num", np.dtype("<i1"))
            names = b"".join(
                n + bytes(_pad8(len(n) + 1) - len(n)) for n in (b"FALSE", b"TRUE")
            )
            return struct.pack("<BHBI", 0x18, 2, 0, 1) + base + names + bytes([0, 1])
        if kind == "vstr":
            # variable-length string, null-terminated, UTF-8, over uint8
            base = struct.pack("<BHBIHH", 0x10, 0, 0, 1, 0, 8)
            return struct.pack("<BHBI", 0x19, 0x0101, 0, 16) + base
        if kind == "fstr":
            # null-padded ASCII, as h5py stores numpy "S<n>"
            return struct.pack("<BHBI", 0x13, 1, 0, dtype.itemsize)
        if dtype.kind == "f":
            size = dtype.itemsize
            prec, eloc, esize, mloc, msize, bias = _IEEE[size]
            sign = prec - 1
            return struct.pack(
                "<BBBBIHHBBBBI", 0x11, 0x20, sign, 0, size, 0, prec,
                eloc, esize, mloc, msize, bias,
            )
        signed = 0x08 if dtype.kind == "i" else 0
        return struct.pack("<BHBIHH", 0x10, signed, 0, dtype.itemsize, 0, 8 * dtype.itemsize)

    @staticmethod
    def _dataspace(shape, maxshape=None) -> bytes:
        flags = 1 if maxshape is not None else 0
        out = struct.pack("<BBB5x", 1, len(shape), flags)
        out += b"".join(struct.pack("<Q", s) for s in shape)
        if maxshape is not None:
            out += b"".join(struct.pack("<Q", _UNDEF if m is None else m) for m in maxshape)
        return out

    def _raw(self, kind: str, dtype: np.dtype, arr: np.ndarray) -> bytes:
        if kind == "bool":
            return np.ascontiguousarray(arr, dtype=np.int8).tobytes()
        if kind == "vstr":
            return b"".join(self._vlen(v) for v in arr.reshape(-1))
        return np.ascontiguousarray(arr, dtype=dtype).tobytes()

    def _attribute(self, name: str, kind: str, dtype: np.dtype, arr: np.ndarray) -> bytes:
        bname = name.encode("utf-8") + b"\0"
        dt = self._datatype(kind, dtype)
        ds = self._dataspace(arr.shape)
        body = struct.pack("<BBHHH", 1, 0, len(bname), len(dt), len(ds))
        for part in (bname, dt, ds):
            body += part + bytes(_pad8(len(part)) - len(part))
        return body + self._raw(kind, dtype, arr)

    def _header(self, messages: List[Tuple[int, int, bytes]]) -> int:
        body = bytearray()
        for mtype, flags, data in messages:
            size = _pad8(len(data))
            if size > 0xFFFF:
                raise ValueError(
                    f"a header message of {size} bytes is over HDF5's 64 KiB limit"
                )
            body += struct.pack("<HHB3x", mtype, size, flags)
            body += data + bytes(size - len(data))
        prefix = struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body))
        return self._alloc(bytes(prefix + body))

    def _attr_messages(self, node) -> List[Tuple[int, int, bytes]]:
        return [
            (0x000C, 0, self._attribute(name, *node.attrs._values[name]))
            for name in sorted(node.attrs._values)
        ]

    # ------------------------------------------------------ B-trees

    def _btree(self, ntype: int, k: int, key_size: int, leaves) -> int:
        """Build a B-tree over ``leaves`` [(child address, left key,
        right key)] bottom up, nodes at full capacity ``2k``; returns
        the root's address."""
        level = 0
        entries = leaves
        node_size = 24 + (2 * k + 1) * key_size + 2 * k * 8
        while True:
            groups = [entries[i:i + 2 * k] for i in range(0, len(entries), 2 * k)] or [[]]
            addrs = [self._alloc(bytes(node_size)) for _ in groups]
            parents = []
            for j, (addr, group) in enumerate(zip(addrs, groups)):
                left = addrs[j - 1] if j > 0 else _UNDEF
                right = addrs[j + 1] if j + 1 < len(addrs) else _UNDEF
                node = bytearray(
                    b"TREE" + struct.pack("<BBHQQ", ntype, level, len(group), left, right)
                )
                if group:
                    for child, lkey, _ in group:
                        node += lkey + struct.pack("<Q", child)
                    node += group[-1][2]
                else:
                    node += bytes(key_size)
                self.out[addr:addr + len(node)] = node
                if group:
                    parents.append((addr, group[0][1], group[-1][2]))
            if len(addrs) == 1:
                return addrs[0]
            entries = parents
            level += 1

    # ------------------------------------------------------- objects

    def _group(self, group: "Group") -> Tuple[int, int, int]:
        names = sorted(group._children, key=lambda s: s.encode("utf-8"))
        entries = []
        for name in names:
            child = group._children[name]
            if isinstance(child, Group):
                addr, btree, heap = self._group(child)
                entries.append((addr, 1, struct.pack("<QQ", btree, heap)))
            else:
                entries.append((self._dataset(child), 0, bytes(16)))
        # local heap: the empty name at offset 0, the names, a free block
        heap_data = bytearray(8)
        offsets = []
        for name in names:
            offsets.append(len(heap_data))
            raw = name.encode("utf-8") + b"\0"
            heap_data += raw + bytes(_pad8(len(raw)) - len(raw))
        free_at = len(heap_data)
        heap_data += struct.pack("<QQ", 1, 16)
        heap = self._alloc(
            b"HEAP" + bytes(4) + struct.pack("<QQQ", len(heap_data), free_at, 0)
        )
        data_at = self._alloc(bytes(heap_data))
        self.out[heap + 24:heap + 32] = struct.pack("<Q", data_at)
        # symbol-table nodes, 2K entries each, then the B-tree over them
        leaves = []
        per_node = 2 * _GROUP_LEAF_K
        for i in range(0, len(names), per_node):
            node = bytearray(b"SNOD" + struct.pack("<BBH", 1, 0, len(names[i:i + per_node])))
            for j in range(i, min(i + per_node, len(names))):
                addr, cache, scratch = entries[j]
                node += struct.pack("<QQII", offsets[j], addr, cache, 0) + scratch
            node += bytes(8 + per_node * 40 - len(node))
            left = struct.pack("<Q", offsets[i - 1] if i else 0)
            right = struct.pack("<Q", offsets[min(i + per_node, len(names)) - 1])
            leaves.append((self._alloc(bytes(node)), left, right))
        btree = self._btree(0, _GROUP_NODE_K, 8, leaves)
        messages = [(0x0011, 0, struct.pack("<QQ", btree, heap))]
        return self._header(messages + self._attr_messages(group)), btree, heap

    def _dataset(self, dset: "Dataset") -> int:
        arr = dset._array()
        kind, dtype, shape = dset._kind, dset.dtype, dset.shape
        sdt = _storage_dtype(kind, dtype)
        if dset.chunks is None:
            raw = self._raw(kind, dtype, arr) if arr.size else b""
            addr = self._alloc(raw) if raw else _UNDEF
            layout = struct.pack("<BBQQ", 3, 1, addr, len(raw))
            alloc = 2  # late
        else:
            chunk = dset.chunks
            grid = [-(-s // c) for s, c in zip(shape, chunk)]
            chunk_bytes = _prod(chunk) * sdt.itemsize
            leaves = []
            for index in np.ndindex(*grid) if _prod(grid) else ():
                origin = [i * c for i, c in zip(index, chunk)]
                block = np.zeros(chunk, dtype=arr.dtype)
                if kind == "vstr":
                    block.fill(b"")
                src = tuple(slice(o, min(o + c, s)) for o, c, s in zip(origin, chunk, shape))
                block[tuple(slice(0, d.stop - d.start) for d in src)] = arr[src]
                addr = self._alloc(self._raw(kind, dtype, block))
                key = struct.pack("<II", chunk_bytes, 0) + b"".join(
                    struct.pack("<Q", o) for o in origin + [0]
                )
                # the right key as the library writes it: one chunk on
                # along every axis, the element axis included
                end = [o + c for o, c in zip(origin, chunk)] + [sdt.itemsize]
                right = struct.pack("<II", 0, 0) + b"".join(
                    struct.pack("<Q", o) for o in end
                )
                leaves.append((addr, key, right))
            key_size = 8 + 8 * (len(shape) + 1)
            root = self._btree(1, _CHUNK_K, key_size, leaves) if leaves else _UNDEF
            layout = struct.pack("<BBBQ", 3, 2, len(shape) + 1, root) + b"".join(
                struct.pack("<I", c) for c in list(chunk) + [sdt.itemsize]
            )
            alloc = 3  # incremental
        # fill value version 2: the allocation time, the write time (on
        # allocation for strings, else if set), the default fill value
        fill = struct.pack("<BBBBI", 2, alloc, 0 if kind == "vstr" else 2, 1, 0)
        space = self._dataspace(shape, dset.maxshape if shape else None)
        messages = [
            (0x0001, 0, space),
            (0x0003, 1, self._datatype(kind, dtype)),
            (0x0005, 1, fill),
            (0x0008, 0, layout),
        ]
        return self._header(messages + self._attr_messages(dset))


# ----------------------------------------------------------- the tree


class AttributeManager:
    """An object's attributes, as h5py's ``.attrs``: a string reads
    back as `str`, a number as a numpy scalar, an array as an array."""

    def __init__(self, owner):
        self._owner = owner
        self._values: Dict[str, Tuple[str, np.dtype, np.ndarray]] = {}

    def __getitem__(self, name: str):
        kind, _, arr = self._values[name]
        if kind == "vstr":
            if arr.ndim == 0:
                return arr[()].decode("utf-8")
            out = np.empty(arr.shape, dtype=object)
            out.reshape(-1)[:] = [v.decode("utf-8") for v in arr.reshape(-1)]
            return out
        return arr[()] if arr.ndim == 0 else arr.copy()

    def __setitem__(self, name: str, value):
        self._values[str(name)] = _to_stored(value)
        self._owner._touch()

    def __contains__(self, name) -> bool:
        return name in self._values

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._values))

    def get(self, name: str, default=None):
        return self[name] if name in self._values else default


class _Node:
    def __init__(self, parent, name: str):
        self._parent = parent
        self.name = name
        self.attrs = AttributeManager(self)

    def _touch(self):
        if self._parent is not None:
            self._parent._touch()


class Group(_Node):
    """A group: a mapping from names to groups and datasets."""

    def __init__(self, parent, name: str):
        super().__init__(parent, name)
        self._children: Dict[str, _Node] = {}

    def _walk(self, path: str, create: bool = False):
        """(the group that holds the last name, the last name)."""
        node: Group = self
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise ValueError(f"empty path {path!r}")
        for part in parts[:-1]:
            child = node._children.get(part)
            if child is None:
                if not create:
                    return None, parts[-1]
                child = node._add(part, Group(node, node._path(part)))
            if not isinstance(child, Group):
                raise TypeError(f"{child.name} is a dataset, not a group")
            node = child
        return node, parts[-1]

    def _path(self, name: str) -> str:
        return self.name.rstrip("/") + "/" + name

    def _add(self, name: str, node: _Node) -> _Node:
        self._children[name] = node
        self._touch()
        return node

    def __getitem__(self, path: str):
        group, name = self._walk(path)
        if group is None or name not in group._children:
            raise KeyError(f"{path!r} does not exist in {self.name!r}")
        return group._children[name]

    def __contains__(self, path) -> bool:
        group, name = self._walk(str(path))
        return group is not None and name in group._children

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._children, key=lambda s: s.encode("utf-8")))

    def keys(self) -> List[str]:
        return list(self)

    def get(self, path: str, default=None):
        return self[path] if path in self else default

    def create_group(self, path: str) -> "Group":
        group, name = self._walk(path, create=True)
        if name in group._children:
            raise ValueError(f"{path!r} already exists in {self.name!r}")
        return group._add(name, Group(group, group._path(name)))

    def create_dataset(self, path: str, shape=None, dtype=None, data=None,
                       maxshape=None) -> "Dataset":
        group, name = self._walk(path, create=True)
        if name in group._children:
            raise ValueError(f"{path!r} already exists in {self.name!r}")
        if data is not None:
            kind, dt, arr = _to_stored(data, dtype)
        else:
            if shape is None:
                raise TypeError("create_dataset needs a shape or data")
            kind, dt, arr = _to_stored(
                np.zeros((), dtype=np.dtype(dtype if dtype is not None else "f4"))
            )
            arr = np.zeros(tuple(shape), dtype=arr.dtype)
        shape = arr.shape
        if maxshape is not None:
            maxshape = tuple(maxshape)
            if len(maxshape) != len(shape) or any(
                m is not None and m < s for m, s in zip(maxshape, shape)
            ):
                raise ValueError(f"maxshape {maxshape} does not fit shape {shape}")
        chunks = None
        if maxshape is not None:
            if not shape:
                raise TypeError("a scalar dataset cannot be resizable")
            chunks = _guess_chunk(shape, _storage_dtype(kind, dt).itemsize)
        dset = Dataset(
            group, group._path(name), kind, dt, shape,
            maxshape if maxshape is not None else shape, chunks, array=arr,
        )
        return group._add(name, dset)

    def __setitem__(self, path: str, value):
        self.create_dataset(path, data=value)

    def __delitem__(self, path: str):
        group, name = self._walk(path)
        if group is None or name not in group._children:
            raise KeyError(f"{path!r} does not exist in {self.name!r}")
        del group._children[name]
        group._touch()


class Dataset(_Node):
    """An n-dimensional array. Its values are decoded from the file when
    first indexed and are held in memory until the file closes."""

    def __init__(self, parent, name: str, kind: str, dtype: np.dtype, shape,
                 maxshape, chunks, array: Optional[np.ndarray] = None, loader=None):
        super().__init__(parent, name)
        self._kind = kind
        self.dtype = np.dtype(dtype)
        self.shape = tuple(int(s) for s in shape)
        self.maxshape = tuple(maxshape)
        self.chunks = chunks
        self._data = array
        self._loader = loader

    def _array(self) -> np.ndarray:
        if self._data is None:
            self._data = self._loader()
            self._loader = None
        return self._data

    def __getitem__(self, key):
        arr = self._array()
        if key is Ellipsis or (isinstance(key, tuple) and key == ()):
            return arr[()] if arr.ndim == 0 else arr.copy()
        out = arr[key]
        return out.copy() if isinstance(out, np.ndarray) else out

    def __setitem__(self, key, value):
        arr = self._array()
        if self._kind == "vstr":
            value = _to_stored(value)[2]
        arr[key] = value
        self._touch()

    def resize(self, size):
        if self.chunks is None:
            raise TypeError("only chunked datasets can be resized")
        shape = tuple(int(s) for s in size)
        if len(shape) != len(self.shape) or any(
            m is not None and s > m for s, m in zip(shape, self.maxshape)
        ):
            raise ValueError(f"cannot resize {self.shape} to {shape} (maxshape {self.maxshape})")
        old = self._array()
        new = np.zeros(shape, dtype=old.dtype)
        if self._kind == "vstr":
            new.reshape(-1)[:] = [b""] * new.size
        common = tuple(slice(0, min(a, b)) for a, b in zip(old.shape, shape))
        new[common] = old[common]
        self._data = new
        self.shape = shape
        self._touch()


class File(Group):
    """An HDF5 file, opened "r" (read), "r+" (read and write an existing
    file), "a" (read and write, created if missing) or "w" (created, or
    truncated). A writing open locks the file until `close`."""

    def __init__(self, path, mode: str = "r"):
        super().__init__(None, "/")
        if mode not in ("r", "r+", "a", "w"):
            raise ValueError(f"mode {mode!r} is not one of 'r', 'r+', 'a', 'w'")
        self.filename = os.fspath(path)
        self.mode = mode
        self._lock: Optional[int] = None
        self._dirty = False
        self._closed = False
        if mode == "r":
            with open(self.filename, "rb") as fh:
                self._load(fh.read())
            return
        self._lock = self._acquire(create=mode in ("a", "w"))
        try:
            buf = b"" if mode == "w" else _read_fd(self._lock)
            if buf:
                self._load(buf)
            elif mode == "r+":
                raise UnsupportedFormat(f"{self.filename}: an empty file")
            else:
                self._dirty = True
        except BaseException:
            self._release()
            raise

    def _acquire(self, create: bool) -> int:
        """An exclusive lock on the file at the path now: a writer that
        replaced the file while this one waited leaves it holding the
        old inode, so it opens the path again."""
        flags = os.O_RDWR | (os.O_CREAT if create else 0)
        while True:
            fd = os.open(self.filename, flags, 0o644)
            try:
                fcntl.flock(fd, fcntl.LOCK_EX)
                held = os.fstat(fd)
                try:
                    now = os.stat(self.filename)
                except FileNotFoundError:
                    now = None
            except BaseException:
                os.close(fd)
                raise
            if now is not None and (now.st_ino, now.st_dev) == (held.st_ino, held.st_dev):
                return fd
            os.close(fd)
            if not create and now is None:
                raise FileNotFoundError(self.filename)

    def _release(self):
        if self._lock is not None:
            os.close(self._lock)
            self._lock = None

    def _load(self, buf: bytes):
        root = _Reader(buf, self.filename).root()
        self.attrs = root.attrs
        root.attrs._owner = self
        self._children = root._children
        for child in self._children.values():
            child._parent = self

    def _touch(self):
        if self.mode == "r":
            raise ValueError(f"{self.filename} is open read-only")
        self._dirty = True

    def close(self, commit: bool = True):
        """Write the tree if it changed (and ``commit``), then unlock."""
        if self._closed:
            return
        self._closed = True
        try:
            if commit and self._dirty:
                _replace(self.filename, _Writer().image(self))
        finally:
            self._release()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close(commit=exc_type is None)

    def __del__(self):
        if not getattr(self, "_closed", True):
            self._release()


def _read_fd(fd: int) -> bytes:
    size = os.fstat(fd).st_size
    chunks = []
    offset = 0
    while offset < size:
        block = os.pread(fd, size - offset, offset)
        if not block:
            break
        chunks.append(block)
        offset += len(block)
    return b"".join(chunks)


def _replace(path: str, image: bytearray):
    """Write ``image`` to a temporary file beside ``path``, fsync it and
    rename it over ``path``; on any failure the temporary file goes and
    ``path`` is as it was."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".", suffix=".tmp", dir=directory)
    try:
        with os.fdopen(fd, "wb") as fh:
            fh.write(image)
            fh.flush()
            os.fsync(fh.fileno())
        os.chmod(tmp, 0o644)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise

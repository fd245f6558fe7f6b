"""The subset of HDF5 that the scene format uses, in numpy (no h5py).

What h5py 3.x over HDF5 1.14 writes by default, and this module reads and
writes:

- superblock version 0 at offset 0, 8-byte offsets and lengths, group leaf
  K 4 and internal K 16;
- old-style groups: an object header with a symbol table message, a
  version-1 B-tree (``TREE``) of symbol nodes (``SNOD``, at most 2 x leaf K
  entries each) keyed by names in a local heap (``HEAP``), names in byte
  (``strcmp``) order; the tree may have several levels;
- version-1 object headers, following continuation messages and skipping
  NIL and unknown messages;
- datasets with a version-1 dataspace (scalar or simple) and a contiguous
  version-3 layout: fixed-point and IEEE float
  datatypes of either byte order, and h5py's boolean, an enum over int8
  with members ``FALSE = 0`` and ``TRUE = 1`` (read back as ``np.bool_``).
  A dataset that was never allocated (a zero-length one) has an undefined
  address and reads as zeros of its shape.

The reader follows every address, so files that h5py changed in place
(freed space, a relocated heap, split nodes) read as h5py reads them.
``dataset[()]`` gives what h5py gives: an ndarray, or a numpy scalar for a
scalar dataspace. The writer writes a whole file at once, groups of named
arrays, in h5py's default layout; appending to an existing file is not
supported. Anything outside this subset (compact, chunked or filtered
layouts, strings, compound types, new-style groups, other superblocks and
message versions) raises ``NotImplementedError``.

    with File(path, "w") as f:
        g = f.create_group("1700000000000000000")
        g.create_dataset("lidar", data=points)
    with File(path) as f:
        points = f["1700000000000000000"]["lidar"][()]
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF
LEAF_K = 4  # a symbol node holds at most 2 * LEAF_K entries
INTERNAL_K = 16  # a group B-tree node has at most 2 * INTERNAL_K children
FREE_NULL = 1  # the local heap's "no free block" offset

MSG_NIL, MSG_DATASPACE, MSG_DATATYPE, MSG_FILL = 0x0, 0x1, 0x3, 0x5
MSG_LAYOUT, MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0x8, 0x10, 0x11

ENTRY_SIZE = 40  # a symbol table entry
SNOD_SIZE = 8 + 2 * LEAF_K * ENTRY_SIZE
TREE_SIZE = 24 + (2 * INTERNAL_K + 1) * 8 + 2 * INTERNAL_K * 8


def _u16(b: bytes, at: int) -> int:
    return struct.unpack_from("<H", b, at)[0]


def _u32(b: bytes, at: int) -> int:
    return struct.unpack_from("<I", b, at)[0]


def _u64(b: bytes, at: int) -> int:
    return struct.unpack_from("<Q", b, at)[0]


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ------------------------------------------------------------------ reader


def _parse_datatype(b: bytes, at: int = 0) -> Tuple[np.dtype, int]:
    """(numpy dtype, bytes used) of the datatype message at ``b[at:]``."""
    version, cls = b[at] >> 4, b[at] & 0x0F
    bits = b[at + 1 : at + 4]
    size = _u32(b, at + 4)
    order = ">" if bits[0] & 1 else "<"
    if cls == 0:  # fixed-point
        kind = "i" if bits[0] & 0x08 else "u"
        return np.dtype(f"{order}{kind}{size}"), 12
    if cls == 1:  # IEEE floating point
        if size not in (2, 4, 8):
            raise NotImplementedError(f"HDF5 float of {size} bytes")
        return np.dtype(f"{order}f{size}"), 20
    if cls == 8:  # enumeration
        count = bits[0] | bits[1] << 8
        base, used = _parse_datatype(b, at + 8)
        pos = at + 8 + used
        names = []
        if version > 2:
            raise NotImplementedError(f"HDF5 enum datatype version {version}")
        for _ in range(count):
            end = b.index(b"\0", pos)
            names.append(b[pos:end])
            pos += _pad8(end - pos + 1)
        values = np.frombuffer(b, base, count, pos).tolist()
        pos += count * base.itemsize
        if base.itemsize == 1 and base.kind == "i" and dict(zip(names, values)) == {
            b"FALSE": 0, b"TRUE": 1
        }:
            return np.dtype(np.bool_), pos - at
        return base, pos - at
    raise NotImplementedError(f"HDF5 datatype class {cls} is outside the scene format")


def _parse_dataspace(b: bytes) -> Tuple[int, ...]:
    if b[0] != 1:
        raise NotImplementedError(f"HDF5 dataspace version {b[0]}")
    return tuple(_u64(b, 8 + 8 * i) for i in range(b[1]))


class _Object:
    """An object header's messages, ``{type: [data, ...]}``."""

    def __init__(self, file: "FileReader", address: int):
        self.file = file
        head = file._read(address, 16)
        if head[0] != 1:
            raise NotImplementedError(
                f"HDF5 object header version {head[0]} at {address:#x} (only version 1)"
            )
        remaining = _u16(head, 2)
        self.messages: Dict[int, List[bytes]] = {}
        blocks = [(address + 16, _u32(head, 8))]
        while blocks and remaining > 0:
            start, length = blocks.pop(0)
            block = file._read(start, length)
            pos = 0
            while pos + 8 <= length and remaining > 0:
                mtype, msize, flags = _u16(block, pos), _u16(block, pos + 2), block[pos + 4]
                data = block[pos + 8 : pos + 8 + msize]
                pos += 8 + msize
                remaining -= 1
                if flags & 0x02 and mtype != MSG_NIL:
                    raise NotImplementedError(f"HDF5 shared message of type {mtype:#x}")
                if mtype == MSG_CONTINUATION:
                    blocks.append((_u64(data, 0), _u64(data, 8)))
                elif mtype != MSG_NIL:
                    self.messages.setdefault(mtype, []).append(data)

    def first(self, mtype: int) -> Optional[bytes]:
        found = self.messages.get(mtype)
        return found[0] if found else None


class Dataset:
    """A contiguous dataset; ``[()]`` reads it whole."""

    def __init__(self, obj: _Object, name: str):
        self.name = name
        self._file = obj.file
        self.shape = _parse_dataspace(obj.first(MSG_DATASPACE))
        self.dtype, _ = _parse_datatype(obj.first(MSG_DATATYPE))
        layout = obj.first(MSG_LAYOUT)
        if layout is None or layout[0] != 3 or layout[1] != 1:
            raise NotImplementedError(f"{name}: HDF5 layout other than contiguous "
                                      f"(version 3, class 1): compact, chunked or virtual")
        self._address = _u64(layout, 2)

    def _read(self) -> np.ndarray:
        # Bools are stored as the int8 enum; their bytes are the bool's.
        stored = np.dtype(np.int8) if self.dtype == np.bool_ else self.dtype
        count = int(np.prod(self.shape, dtype=np.int64))
        if self._address == UNDEFINED or count == 0:
            arr = np.zeros(count, stored)
        else:
            arr = self._file._fromfile(self._address, stored, count)
        if self.dtype == np.bool_:
            arr = arr.view(np.bool_)
        return arr.reshape(self.shape)

    def __getitem__(self, key):
        """As numpy indexes the whole array: ``[()]`` is the array, or a
        numpy scalar for a scalar dataset, as h5py returns them."""
        return self._read()[key]

    def __repr__(self) -> str:
        return f"<Dataset {self.name!r} shape {self.shape} dtype {self.dtype}>"


class Group:
    """An old-style group: names in a local heap, children in a B-tree."""

    def __init__(self, obj: _Object, name: str):
        self.name = name
        self._file = obj.file
        stab = obj.first(MSG_SYMBOL_TABLE)
        if stab is None:
            raise NotImplementedError(f"{name}: new-style HDF5 group (no symbol table)")
        self._btree, self._heap = _u64(stab, 0), _u64(stab, 8)
        self._links: Optional[Dict[str, int]] = None

    @property
    def links(self) -> Dict[str, int]:
        """``{name: object header address}`` in the B-tree's (byte) order."""
        if self._links is None:
            heap = self._file._read(self._heap, 32)
            if heap[:4] != b"HEAP":
                raise ValueError(f"{self.name}: no local heap at {self._heap:#x}")
            names = self._file._read(_u64(heap, 24), _u64(heap, 8))
            links: Dict[str, int] = {}
            self._walk(self._btree, names, links, set())
            self._links = links
        return self._links

    def _walk(self, address: int, names: bytes, links: Dict[str, int], seen: set) -> None:
        if address in seen:
            raise ValueError(f"{self.name}: B-tree cycle at {address:#x}")
        seen.add(address)
        node = self._file._read(address, 24)
        if node[:4] != b"TREE" or node[4] != 0:
            raise ValueError(f"{self.name}: no group B-tree node at {address:#x}")
        level, used = node[5], _u16(node, 6)
        body = self._file._read(address + 24, (2 * used + 1) * 8)
        for i in range(used):
            child = _u64(body, 16 * i + 8)
            if level > 0:
                self._walk(child, names, links, seen)
                continue
            snod = self._file._read(child, SNOD_SIZE)
            if snod[:4] != b"SNOD":
                raise ValueError(f"{self.name}: no symbol node at {child:#x}")
            for e in range(_u16(snod, 6)):
                at = 8 + e * ENTRY_SIZE
                off = _u64(snod, at)
                name = names[off : names.index(b"\0", off)].decode()
                links[name] = _u64(snod, at + 8)

    def keys(self) -> List[str]:
        return list(self.links)

    def __iter__(self) -> Iterator[str]:
        return iter(self.links)

    def __contains__(self, path: str) -> bool:
        try:
            self._resolve(path)
        except KeyError:
            return False
        return True

    def _resolve(self, path: str) -> Tuple[int, str]:
        group, parts = self, [p for p in str(path).split("/") if p]
        if not parts:
            raise KeyError(path)
        for part in parts[:-1]:
            child = group[part]
            if not isinstance(child, Group):
                raise KeyError(path)
            group = child
        if parts[-1] not in group.links:
            raise KeyError(path)
        return group.links[parts[-1]], f"{group.name.rstrip('/')}/{parts[-1]}"

    def __getitem__(self, path: str) -> Union["Group", Dataset]:
        address, name = self._resolve(path)
        obj = _Object(self._file, address)
        if MSG_SYMBOL_TABLE in obj.messages:
            return Group(obj, name)
        return Dataset(obj, name)

    def __repr__(self) -> str:
        return f"<Group {self.name!r} ({len(self.links)} members)>"


class FileReader(Group):
    """An HDF5 file opened for reading; the root group."""

    def __init__(self, path):
        self.path = Path(path)
        self._fh = open(self.path, "rb")
        try:
            root = self._superblock()
            Group.__init__(self, _Object(self, root), "/")
        except Exception:
            self._fh.close()
            raise

    def _superblock(self) -> int:
        """Check the version-0 superblock; return the root group's header."""
        sb = self._read(0, 96)
        if sb[:8] != SIGNATURE:
            raise ValueError(f"{self.path}: not an HDF5 file (or one with a user block)")
        if sb[8] != 0:
            raise NotImplementedError(f"HDF5 superblock version {sb[8]}")
        if sb[13] != 8 or sb[14] != 8:
            raise NotImplementedError("HDF5 offsets or lengths other than 8 bytes")
        if _u64(sb, 24) != 0:
            raise NotImplementedError("HDF5 base address other than 0")
        return _u64(sb, 64)

    def _read(self, address: int, n: int) -> bytes:
        self._fh.seek(address)
        return self._fh.read(n)

    def _fromfile(self, address: int, dtype: np.dtype, count: int) -> np.ndarray:
        self._fh.seek(address)
        arr = np.fromfile(self._fh, dtype, count)
        if arr.size != count:
            raise ValueError(f"{self.path}: dataset at {address:#x} runs past the end")
        return arr

    def close(self) -> None:
        self._fh.close()

    def __enter__(self) -> "FileReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ------------------------------------------------------------------ writer


def _datatype_message(dtype: np.dtype) -> bytes:
    """h5py's datatype message for a numeric numpy dtype."""
    if dtype == np.bool_:
        base = _datatype_message(np.dtype(np.int8))
        names = b"FALSE\0\0\0" + b"TRUE\0\0\0\0"
        return struct.pack("<B3BI", 0x18, 2, 0, 0, 1) + base + names + b"\x00\x01"
    order = 1 if dtype.byteorder == ">" else 0
    if dtype.kind in "iu":
        signed = 0x08 if dtype.kind == "i" else 0
        return struct.pack("<B3BIHH", 0x10, order | signed, 0, 0, dtype.itemsize, 0,
                           dtype.itemsize * 8)
    if dtype.kind == "f":
        exp_bits, mant_bits, bias = {2: (5, 10, 15), 4: (8, 23, 127), 8: (11, 52, 1023)}[
            dtype.itemsize]
        sign = dtype.itemsize * 8 - 1
        return struct.pack("<B3BIHHBBBBI", 0x11, order | 0x20, sign, 0, dtype.itemsize,
                           0, dtype.itemsize * 8, mant_bits, exp_bits, 0, mant_bits, bias)
    raise NotImplementedError(f"dtype {dtype} is outside the scene format")


def _dataspace_message(shape: Tuple[int, ...]) -> bytes:
    flags = 1 if shape else 0  # h5py stores the maximum dims (= dims)
    dims = struct.pack(f"<{len(shape)}Q", *shape)
    return struct.pack("<BBBB4x", 1, len(shape), flags, 0) + dims + (dims if shape else b"")


def _object_header(messages: List[Tuple[int, int, bytes]]) -> bytes:
    body = b"".join(
        struct.pack("<HHB3x", mtype, _pad8(len(data)), flags)
        + data + b"\0" * (_pad8(len(data)) - len(data))
        for mtype, flags, data in messages
    )
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _entry(name_offset: int, header: int, stab: Optional[Tuple[int, int]]) -> bytes:
    if stab is None:
        return struct.pack("<QQII16x", name_offset, header, 0, 0)
    return struct.pack("<QQIIQQ", name_offset, header, 1, 0, *stab)


class _WriteDataset:
    def __init__(self, shape, dtype, address, nbytes):
        self.shape, self.dtype, self.address, self.nbytes = shape, dtype, address, nbytes


class WriteGroup:
    """A group being written: children are added, never read back."""

    def __init__(self, writer: "FileWriter", name: str):
        self._writer = writer
        self.name = name
        self._children: Dict[str, Union["WriteGroup", _WriteDataset]] = {}

    def _new_name(self, name: str) -> str:
        name = str(name)
        if not name or "/" in name or "\0" in name:
            raise ValueError(f"invalid HDF5 member name {name!r}")
        if name in self._children:
            raise ValueError(f"{self.name}: {name!r} already exists")
        return name

    def create_group(self, name: str) -> "WriteGroup":
        name = self._new_name(name)
        group = WriteGroup(self._writer, f"{self.name.rstrip('/')}/{name}")
        self._children[name] = group
        return group

    def create_dataset(self, name: str, data) -> None:
        name = self._new_name(name)
        arr = np.asarray(data)
        if arr.dtype.kind not in "biuf":
            raise NotImplementedError(f"{name}: dtype {arr.dtype} is outside the scene format")
        raw = np.ascontiguousarray(arr).tobytes()
        address = self._writer._append(raw) if raw else UNDEFINED
        self._children[name] = _WriteDataset(arr.shape, arr.dtype, address, len(raw))

    def _write(self) -> Tuple[int, Tuple[int, int]]:
        """Write the children's headers, then this group's heap, symbol
        nodes, B-tree and header; returns (header address, (B-tree, heap))."""
        w = self._writer
        names = sorted(self._children, key=lambda s: s.encode())
        entries: List[Tuple[bytes, int]] = []  # (entry, heap offset of its name)
        heap = bytearray(8)  # offset 0: the empty name
        for name in names:
            child = self._children[name]
            if isinstance(child, WriteGroup):
                header, stab = child._write()
            else:
                header, stab = w._append(self._dataset_header(child)), None
            offset, encoded = len(heap), name.encode() + b"\0"
            heap += encoded + b"\0" * (_pad8(len(encoded)) - len(encoded))
            entries.append((_entry(offset, header, stab), offset))
        heap_address = w._append(
            b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap), FREE_NULL, w._eof + 32)
        )
        w._append(bytes(heap))

        # Symbol nodes of at most 2K entries; each leaf key is the heap
        # offset of its node's last name (key 0 is the empty name).
        cap = 2 * LEAF_K
        level: List[Tuple[int, int]] = []  # (child address, offset of its last name)
        for i in range(0, len(entries), cap):
            chunk = entries[i : i + cap]
            body = b"".join(e for e, _ in chunk)
            node = b"SNOD" + struct.pack("<BBH", 1, 0, len(chunk)) + body
            level.append((w._append(node + b"\0" * (SNOD_SIZE - len(node))), chunk[-1][1]))
        depth = 0
        while True:
            groups = [level[i : i + 2 * INTERNAL_K]
                      for i in range(0, max(len(level), 1), 2 * INTERNAL_K)]
            base = w._eof
            addresses = [base + j * TREE_SIZE for j in range(len(groups))]
            parents, left_key = [], 0
            for j, kids in enumerate(groups):
                left = addresses[j - 1] if j > 0 else UNDEFINED
                right = addresses[j + 1] if j + 1 < len(groups) else UNDEFINED
                body = struct.pack("<Q", left_key)
                for child, key in kids:
                    body += struct.pack("<QQ", child, key)
                node = b"TREE" + struct.pack("<BBHQQ", 0, depth, len(kids), left, right) + body
                w._append(node + b"\0" * (TREE_SIZE - len(node)))
                last = kids[-1][1] if kids else 0
                parents.append((addresses[j], last))
                left_key = last
            if len(parents) == 1:
                root = parents[0][0]
                break
            level, depth = parents, depth + 1
        stab = (root, heap_address)
        header = w._append(_object_header([(MSG_SYMBOL_TABLE, 0, struct.pack("<QQ", *stab))]))
        return header, stab

    @staticmethod
    def _dataset_header(ds: _WriteDataset) -> bytes:
        layout = struct.pack("<BBQQ", 3, 1, ds.address, ds.nbytes)
        fill = struct.pack("<BBBB4x", 2, 2, 2, 1)
        return _object_header([
            (MSG_DATASPACE, 0, _dataspace_message(ds.shape)),
            (MSG_DATATYPE, 1, _datatype_message(ds.dtype)),
            (MSG_FILL, 1, fill),
            (MSG_LAYOUT, 0, layout),
        ])


class FileWriter(WriteGroup):
    """A new HDF5 file (an existing one is truncated), written whole:
    datasets' bytes go out as they are created, every header, heap and
    B-tree when the file is closed."""

    def __init__(self, path):
        self.path = Path(path)
        self._fh = open(self.path, "wb")
        self._eof = 0
        WriteGroup.__init__(self, self, "/")
        self._append(b"\0" * 96)  # the superblock, written at close
        self._closed = False

    def _append(self, data: bytes) -> int:
        address = self._eof
        self._fh.write(data)
        self._eof += len(data)
        return address

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        try:
            header, stab = self._write()
            sb = SIGNATURE + struct.pack(
                "<8BHHIQQQQ", 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K, INTERNAL_K, 0,
                0, UNDEFINED, self._eof, UNDEFINED,
            ) + _entry(0, header, stab)
            self._fh.seek(0)
            self._fh.write(sb)
        finally:
            self._fh.close()

    def __enter__(self) -> "FileWriter":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is None:
            self.close()
        else:
            self._closed = True
            self._fh.close()


def File(path, mode: str = "r"):
    """``"r"``: a :class:`FileReader`; ``"w"``: a :class:`FileWriter`."""
    if mode == "r":
        return FileReader(path)
    if mode == "w":
        return FileWriter(path)
    raise ValueError(f"mode {mode!r}: only 'r' and 'w' are supported")

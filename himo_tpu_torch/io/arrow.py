"""The Arrow IPC file format (feather version 2) in numpy, without pandas
or pyarrow.

What ``pandas.DataFrame.to_feather`` writes (through pyarrow), and this
module reads:

- ``ARROW1`` and two bytes of padding at the start, ``ARROW1`` at the end,
  the Footer flatbuffer before it (its length in the int32 just before the
  magic): the schema and one ``Block`` (offset, metadata length, body
  length) per record batch;
- each record batch an encapsulated message: the ``0xFFFFFFFF``
  continuation marker, the int32 metadata length, the ``Message``
  flatbuffer holding a ``RecordBatch`` (its ``FieldNode`` s, ``Buffer`` s
  and optional ``BodyCompression``), then the body, 8-byte aligned;
- in a compressed batch, each non-empty buffer an int64 little-endian
  uncompressed length followed by an LZ4 frame, or by the bytes stored raw
  when the length is -1 (:mod:`himo_tpu_torch.io.lz4` decodes the frames);
- several batches a file (pandas writes 65,536 rows a batch), which
  :func:`read_feather` concatenates column by column.

Column types: signed and unsigned integers of 8 to 64 bits, float16, 32
and 64, bool (bit-packed) and utf8 / large utf8 (int32 / int64 offsets,
read as an object array of ``str``). An empty validity buffer, or a null
count of 0, means every value is valid; a column with nulls is refused.
Custom metadata (pandas' ``pandas`` key) is ignored. Anything else — a
codec other than LZ4_FRAME (ZSTD), another type, a dictionary-encoded or
nested column, a big-endian schema — raises and names the field.

:func:`write_feather` writes numeric, bool and string columns (object
arrays of ``str`` as large utf8, pandas' own choice) as one uncompressed
record batch that pandas reads back to the same columns, dtypes and
values.

Flatbuffers are read through their vtables (:class:`_Table`) and written
front to back (:func:`_flatbuffer`): each table's vtable just before it,
its children after it, every scalar aligned to its size from the start of
the buffer, as the Arrow readers' verifier requires.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Tuple, Union

import numpy as np

from himo_tpu_torch.io import lz4

MAGIC = b"ARROW1"
CONTINUATION = 0xFFFFFFFF
METADATA_V5 = 4
HEADER_SCHEMA, HEADER_RECORD_BATCH = 1, 3
TYPE_INT, TYPE_FLOAT, TYPE_UTF8, TYPE_BOOL, TYPE_LARGE_UTF8 = 2, 3, 5, 6, 20
TYPE_NAMES = {1: "Null", 4: "Binary", 7: "Decimal", 8: "Date", 9: "Time", 10: "Timestamp",
              11: "Interval", 12: "List", 13: "Struct", 14: "Union", 15: "FixedSizeBinary",
              16: "FixedSizeList", 17: "Map", 18: "Duration", 19: "LargeBinary",
              21: "LargeList", 22: "RunEndEncoded", 23: "BinaryView", 24: "Utf8View"}
CODEC_LZ4_FRAME = 0
CODEC_NAMES = {0: "LZ4_FRAME", 1: "ZSTD"}
FLOAT_DTYPES = {0: np.float16, 1: np.float32, 2: np.float64}

# ------------------------------------------------------------------ reader


class _Table:
    """A flatbuffer table at ``pos`` of ``buf``: its fields by vtable slot."""

    __slots__ = ("buf", "pos", "vtable", "vtable_len")

    def __init__(self, buf: bytes, pos: int):
        self.buf, self.pos = buf, pos
        self.vtable = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vtable_len = struct.unpack_from("<H", buf, self.vtable)[0]

    def _offset(self, slot: int) -> int:
        at = 4 + 2 * slot
        if at >= self.vtable_len:
            return 0
        return struct.unpack_from("<H", self.buf, self.vtable + at)[0]

    def scalar(self, slot: int, fmt: str, default=0):
        off = self._offset(slot)
        return struct.unpack_from("<" + fmt, self.buf, self.pos + off)[0] if off else default

    def _target(self, slot: int) -> Optional[int]:
        off = self._offset(slot)
        if not off:
            return None
        at = self.pos + off
        return at + struct.unpack_from("<I", self.buf, at)[0]

    def table(self, slot: int) -> Optional["_Table"]:
        at = self._target(slot)
        return None if at is None else _Table(self.buf, at)

    def vector(self, slot: int) -> Tuple[int, int]:
        """(position of the first element, element count); (0, 0) if absent."""
        at = self._target(slot)
        if at is None:
            return 0, 0
        return at + 4, struct.unpack_from("<I", self.buf, at)[0]

    def tables(self, slot: int) -> List["_Table"]:
        start, n = self.vector(slot)
        return [_Table(self.buf, p + struct.unpack_from("<I", self.buf, p)[0])
                for p in range(start, start + 4 * n, 4)]

    def structs(self, slot: int, fmt: str) -> List[tuple]:
        start, n = self.vector(slot)
        size = struct.calcsize("<" + fmt)
        return [struct.unpack_from("<" + fmt, self.buf, start + i * size) for i in range(n)]

    def string(self, slot: int) -> str:
        start, n = self.vector(slot)
        return self.buf[start:start + n].decode("utf-8")


def _root(buf: bytes) -> _Table:
    return _Table(buf, struct.unpack_from("<I", buf, 0)[0])


def _field_kind(field: _Table, name: str) -> Tuple[str, object]:
    """("fixed", dtype), ("bool", None) or ("utf8", offset dtype) of a
    schema field; raises for anything else."""
    if field.table(4) is not None:
        raise NotImplementedError(f"arrow: field {name!r} is dictionary-encoded")
    if field.vector(5)[1]:
        raise NotImplementedError(f"arrow: field {name!r} has child fields")
    type_id, spec = field.scalar(2, "B"), field.table(3)
    if type_id == TYPE_INT:
        bits, signed = spec.scalar(0, "i"), spec.scalar(1, "?")
        if bits not in (8, 16, 32, 64):
            raise NotImplementedError(f"arrow: field {name!r} is a {bits}-bit int")
        return "fixed", np.dtype(f"<{'i' if signed else 'u'}{bits // 8}")
    if type_id == TYPE_FLOAT:
        return "fixed", np.dtype(FLOAT_DTYPES[spec.scalar(0, "h")]).newbyteorder("<")
    if type_id == TYPE_BOOL:
        return "bool", None
    if type_id == TYPE_UTF8:
        return "utf8", np.dtype("<i4")
    if type_id == TYPE_LARGE_UTF8:
        return "utf8", np.dtype("<i8")
    raise NotImplementedError(
        f"arrow: field {name!r} has type {TYPE_NAMES.get(type_id, type_id)}, which the "
        "reader does not take")


def _message(data: bytes, offset: int) -> _Table:
    """The ``Message`` flatbuffer of the encapsulated message at ``offset``
    (a message written before the continuation marker has none)."""
    length = struct.unpack_from("<I", data, offset)[0]
    start = offset + 4
    if length == CONTINUATION:
        length = struct.unpack_from("<i", data, start)[0]
        start += 4
    return _root(data[start:start + length])


def _buffers(data: bytes, body: int, buffers, codec: Optional[int], name: str):
    """The bytes of each buffer of a batch's body, decompressed."""
    out = []
    for offset, length in buffers:
        raw = data[body + offset:body + offset + length]
        if len(raw) != length:
            raise ValueError(f"arrow: field {name!r}: a buffer runs past the file's end")
        if codec is not None and length:
            size = struct.unpack_from("<q", raw, 0)[0]
            raw = raw[8:] if size == -1 else lz4.decode(raw[8:], size)
        out.append(raw)
    return out


def _column(kind, dtype, length: int, bufs) -> np.ndarray:
    if kind == "fixed":
        values = np.frombuffer(bufs[1], dtype=dtype, count=length)
        return values.astype(dtype.newbyteorder("="))
    if kind == "bool":
        bits = np.unpackbits(np.frombuffer(bufs[1], np.uint8), bitorder="little")
        return bits[:length].astype(bool)
    offsets = np.frombuffer(bufs[1], dtype=dtype, count=length + 1) if length else [0]
    text = bytes(bufs[2])
    out = np.empty(length, dtype=object)
    for i in range(length):
        out[i] = text[offsets[i]:offsets[i + 1]].decode("utf-8")
    return out


def _empty(kind, dtype) -> np.ndarray:
    if kind == "fixed":
        return np.empty(0, dtype=dtype.newbyteorder("="))
    return np.empty(0, dtype=bool if kind == "bool" else object)


def read_feather(source: Union[str, Path, bytes]) -> Dict[str, np.ndarray]:
    """Every column of an Arrow IPC file (a path, or the file's bytes), in
    schema order, each batch's values concatenated."""
    data = bytes(source) if isinstance(source, (bytes, bytearray, memoryview)) \
        else Path(source).read_bytes()
    if len(data) < 18 or data[:6] != MAGIC or data[-6:] != MAGIC:
        raise ValueError("arrow: not an Arrow IPC file (no ARROW1 at both ends)")
    footer_len = struct.unpack_from("<i", data, len(data) - 10)[0]
    footer_start = len(data) - 10 - footer_len
    if footer_len <= 0 or footer_start < 8:
        raise ValueError(f"arrow: footer length {footer_len} outside the file")
    footer = _root(data[footer_start:len(data) - 10])
    schema = footer.table(1)
    if schema is None:
        raise ValueError("arrow: the footer has no schema")
    if schema.scalar(0, "h"):
        raise NotImplementedError("arrow: big-endian schema")
    fields = []
    for field in schema.tables(1):
        name = field.string(0)
        fields.append((name, *_field_kind(field, name)))
    if footer.vector(2)[1]:
        raise NotImplementedError("arrow: the file holds dictionary batches")
    parts: Dict[str, list] = {name: [] for name, _, _ in fields}
    for offset, meta_len, _ in footer.structs(3, "qi4xq"):
        message = _message(data, offset)
        if message.scalar(1, "B") != HEADER_RECORD_BATCH:
            raise ValueError(f"arrow: the block at {offset} holds no record batch")
        batch = message.table(2)
        body = offset + meta_len
        nodes = batch.structs(1, "qq")
        buffers = batch.structs(2, "qq")
        compression = batch.table(3)
        codec = None
        if compression is not None:
            codec = compression.scalar(0, "b")
            if codec != CODEC_LZ4_FRAME or compression.scalar(1, "b") != 0:
                raise NotImplementedError(
                    f"arrow: field {fields[0][0] if fields else None!r}: codec "
                    f"{CODEC_NAMES.get(codec, codec)}; the reader decodes LZ4_FRAME only")
        if len(nodes) != len(fields):
            raise ValueError(f"arrow: {len(nodes)} field nodes for {len(fields)} fields")
        at = 0
        for (name, kind, dtype), (length, nulls) in zip(fields, nodes):
            count = 3 if kind == "utf8" else 2
            bufs = _buffers(data, body, buffers[at:at + count], codec, name)
            at += count
            if nulls and len(bufs[0]):
                raise NotImplementedError(f"arrow: field {name!r} holds {nulls} nulls")
            parts[name].append(_column(kind, dtype, length, bufs))
    return {name: np.concatenate(parts[name]) if parts[name] else _empty(kind, dtype)
            for name, kind, dtype in fields}


# ------------------------------------------------------------------ writer


class _Vec:
    """A flatbuffer vector: of structs (``raw`` bytes, ``count`` elements
    aligned to ``align``), or of tables (``tables``)."""

    def __init__(self, raw: bytes = b"", count: int = 0, align: int = 4, tables=()):
        self.raw, self.count, self.align, self.tables = raw, count, align, list(tables)


def _pad_to(buf: bytearray, align: int, rest: int = 0) -> None:
    while len(buf) % align != rest:
        buf.append(0)


def _write(buf: bytearray, obj) -> int:
    """Append ``obj`` (a table as a list of ``(slot, fmt, value)``, where
    ``fmt`` is a struct code for a scalar or ``"o"`` for a child; a
    :class:`_Vec`; a ``str``) and its children; return its position."""
    if isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pad_to(buf, 4)
        pos = len(buf)
        buf += struct.pack("<I", len(raw)) + raw + b"\0"
        return pos
    if isinstance(obj, _Vec):
        _pad_to(buf, max(obj.align, 4), 4 % max(obj.align, 4))
        pos = len(buf)
        if obj.tables:
            buf += struct.pack("<I", len(obj.tables)) + bytes(4 * len(obj.tables))
            for i, child in enumerate(obj.tables):
                at = pos + 4 + 4 * i
                struct.pack_into("<I", buf, at, _write(buf, child) - at)
        else:
            buf += struct.pack("<I", obj.count) + obj.raw
        return pos
    slots = max((slot + 1 for slot, _, _ in obj), default=0)
    offsets, size = {}, 4
    for slot, fmt, _ in obj:
        width = 4 if fmt == "o" else struct.calcsize(fmt)
        size = (size + width - 1) // width * width
        offsets[slot] = size
        size += width
    vtable = struct.pack(f"<HH{slots}H", 4 + 2 * slots, size,
                         *(offsets.get(i, 0) for i in range(slots)))
    _pad_to(buf, 2)
    vpos = len(buf)
    buf += vtable
    _pad_to(buf, 8)
    pos = len(buf)
    buf += bytes(size)
    struct.pack_into("<i", buf, pos, pos - vpos)
    for slot, fmt, value in obj:
        if fmt != "o":
            struct.pack_into("<" + fmt, buf, pos + offsets[slot], value)
    for slot, fmt, value in obj:
        if fmt == "o":
            at = pos + offsets[slot]
            struct.pack_into("<I", buf, at, _write(buf, value) - at)
    return pos


def _flatbuffer(root) -> bytes:
    buf = bytearray(4)
    struct.pack_into("<I", buf, 0, _write(buf, root))
    _pad_to(buf, 8)
    return bytes(buf)


def _type_of(name: str, arr: np.ndarray) -> Tuple[int, list]:
    """The union type id and type table of a numpy column."""
    kind = arr.dtype.kind
    if kind == "b":
        return TYPE_BOOL, []
    if kind in "iu":
        return TYPE_INT, [(0, "i", arr.dtype.itemsize * 8), (1, "?", kind == "i")]
    if kind == "f" and arr.dtype.itemsize in (2, 4, 8):
        return TYPE_FLOAT, [(0, "h", {2: 0, 4: 1, 8: 2}[arr.dtype.itemsize])]
    if kind == "O" and all(isinstance(v, str) for v in arr):
        return TYPE_LARGE_UTF8, []
    raise NotImplementedError(f"arrow: column {name!r} of dtype {arr.dtype}: the writer "
                              "takes numeric, bool and str columns")


def _values(arr: np.ndarray) -> List[bytes]:
    """The data buffers of a column after its validity buffer: the values
    (bools bit-packed), or a string column's int64 offsets and UTF-8 bytes."""
    if arr.dtype.kind == "b":
        return [np.packbits(arr, bitorder="little").tobytes()]
    if arr.dtype.kind == "O":
        encoded = [v.encode("utf-8") for v in arr]
        offsets = np.zeros(len(encoded) + 1, dtype="<i8")
        np.cumsum([len(e) for e in encoded], out=offsets[1:])
        return [offsets.tobytes(), b"".join(encoded)]
    return [arr.astype(arr.dtype.newbyteorder("<")).tobytes()]


def _encapsulate(message) -> bytes:
    meta = _flatbuffer(message)
    return struct.pack("<Ii", CONTINUATION, len(meta)) + meta


def write_feather(columns: Mapping[str, np.ndarray], dest: Union[str, Path]) -> None:
    """Write ``columns`` (equal-length 1-D numeric or bool arrays, or
    object arrays of ``str``, written as large utf8) to ``dest`` as an
    uncompressed Arrow IPC file of one record batch."""
    arrays = {name: np.ascontiguousarray(arr) for name, arr in columns.items()}
    lengths = {len(a) for a in arrays.values()}
    if len(lengths) > 1 or any(a.ndim != 1 for a in arrays.values()):
        raise ValueError(f"arrow: columns of shapes {[a.shape for a in arrays.values()]}")
    rows = lengths.pop() if lengths else 0
    fields, body, buffers, nodes = [], bytearray(), [], []
    for name, arr in arrays.items():
        type_id, spec = _type_of(name, arr)
        fields.append([(0, "o", name), (1, "?", True), (2, "B", type_id), (3, "o", spec),
                       (5, "o", _Vec())])
        buffers.append((len(body), 0))
        for raw in _values(arr):
            buffers.append((len(body), len(raw)))
            body += raw
            _pad_to(body, 8)
        nodes.append((rows, 0))
    schema = [(1, "o", _Vec(tables=fields))]

    def flat(pairs):
        return _Vec(b"".join(struct.pack("<qq", *p) for p in pairs), len(pairs), 8)

    batch = [(0, "q", rows), (1, "o", flat(nodes)), (2, "o", flat(buffers))]
    out = bytearray(MAGIC + b"\0\0")
    out += _encapsulate([(0, "h", METADATA_V5), (1, "B", HEADER_SCHEMA), (2, "o", schema),
                         (3, "q", 0)])
    block_at = len(out)
    meta = _encapsulate([(0, "h", METADATA_V5), (1, "B", HEADER_RECORD_BATCH),
                         (2, "o", batch), (3, "q", len(body))])
    out += meta + body
    out += struct.pack("<Ii", CONTINUATION, 0)  # the end-of-stream marker
    block = struct.pack("<qi4xq", block_at, len(meta), len(body))
    footer = _flatbuffer([(0, "h", METADATA_V5), (1, "o", schema),
                          (2, "o", _Vec(b"", 0, 8)), (3, "o", _Vec(block, 1, 8))])
    out += footer + struct.pack("<i", len(footer)) + MAGIC
    Path(dest).write_bytes(bytes(out))

"""The port's LZ4 frame decoders (``himo_tpu_torch/io/lz4.py`` in Python,
``native.lz4_frame_decode`` in the C++ host library) against the frames
``pyarrow.compress(codec="lz4")`` writes, the codec of pandas' feather
files. Both decoders must return the input byte for byte, and each
other's bytes; malformed frames raise."""

import struct

import numpy as np
import pyarrow as pa
import pytest

from himo_tpu_torch import native
from himo_tpu_torch.io import lz4


def _inputs():
    rng = np.random.default_rng(0)
    ramp = (np.arange(300_000) // 7 % 251).astype(np.uint8).tobytes()
    return {
        "empty": b"",
        "short": b"hello",
        "compressible": ramp,
        # incompressible: pyarrow stores the blocks raw (size word's high bit)
        "incompressible": rng.integers(0, 256, 800_000, dtype=np.uint8).tobytes(),
        # offset 2, matches far longer than their offset; runs of 255 and more
        "overlapping": b"ab" * 100_000 + b"x" * 70_000,
        "long literals": rng.integers(0, 256, 1_000, dtype=np.uint8).tobytes() * 300,
        "floats": np.round(rng.normal(0, 1, 200_000), 2).astype(np.float32).tobytes(),
    }


INPUTS = _inputs()


def _frame(data: bytes) -> bytes:
    return pa.compress(data, codec="lz4", asbytes=True)


def _blocks(frame: bytes):
    """(FLG, [(raw?, payload)]) of a pyarrow frame (no optional fields)."""
    assert struct.unpack_from("<I", frame, 0)[0] == lz4.MAGIC
    flg, pos, blocks = frame[4], 7, []
    while True:
        word = struct.unpack_from("<I", frame, pos)[0]
        pos += 4
        if not word:
            return flg, blocks
        size = word & 0x7FFFFFFF
        blocks.append((bool(word >> 31), frame[pos:pos + size]))
        pos += size


def _decoders():
    decoders = {"python": lz4.decode_frame}
    if native.available():
        decoders["native"] = native.lz4_frame_decode
    return decoders


@pytest.mark.parametrize("name", list(INPUTS))
def test_decoders_return_pyarrows_input(name):
    data = INPUTS[name]
    frame = _frame(data)
    outs = {k: fn(frame, len(data)) for k, fn in _decoders().items()}
    for k, out in outs.items():
        assert out == data, k
    assert lz4.decode(frame, len(data)) == data
    if "native" in outs:
        assert outs["native"] == outs["python"]


def test_frames_hold_what_the_tests_need():
    """pyarrow's frames link their 64 KiB blocks (a match reaches into the
    block before: decoding each block alone fails), store incompressible
    blocks raw, and hold matches longer than their offset."""
    for name in ("compressible", "floats", "overlapping"):
        flg, blocks = _blocks(_frame(INPUTS[name]))
        assert flg == 0b01000000 and len(blocks) > 1, name  # version 1, linked
        with pytest.raises(ValueError, match="outside the"):
            for raw, payload in blocks:
                if not raw:
                    lz4._block(payload, 0, len(payload), bytearray())
    flg, blocks = _blocks(_frame(INPUTS["incompressible"]))
    assert len(blocks) > 1 and all(raw for raw, _ in blocks)
    out = bytearray()
    payload = _blocks(_frame(INPUTS["overlapping"]))[1][0][1]
    lz4._block(payload, 0, len(payload), out)
    assert out[:4] == b"abab" and len(out) == 64 << 10


def _with_options(frame: bytes, content_size=None, checksums=False) -> bytes:
    """``frame`` rewritten with a content size, and with (unverified)
    block and content checksums."""
    flg, blocks = _blocks(frame)
    flg |= (0x08 if content_size is not None else 0) | (0x14 if checksums else 0)
    out = bytearray(struct.pack("<I", lz4.MAGIC)) + bytes([flg, frame[5]])
    if content_size is not None:
        out += struct.pack("<Q", content_size)
    out.append(0)  # the header checksum: parsed, not verified
    for raw, payload in blocks:
        out += struct.pack("<I", len(payload) | (raw << 31)) + payload
        if checksums:
            out += b"\xaa\xbb\xcc\xdd"
    out += bytes(4)
    if checksums:
        out += b"\x11\x22\x33\x44"
    return bytes(out)


def test_optional_fields_skippable_and_concatenated_frames():
    data = INPUTS["floats"]
    frame = _frame(data)
    variants = {
        "content size": _with_options(frame, content_size=len(data)),
        "checksums": _with_options(frame, checksums=True),
        "both": _with_options(frame, content_size=len(data), checksums=True),
        "skippable first": struct.pack("<II", 0x184D2A53, 5) + b"12345" + frame,
    }
    for name, variant in variants.items():
        for k, fn in _decoders().items():
            assert fn(variant, len(data)) == data, (name, k)
    two = _frame(b"first ") + _frame(b"second")
    for k, fn in _decoders().items():
        assert fn(two, 12) == b"first second", k


@pytest.mark.parametrize("case", ["bad magic", "truncated", "short output", "long output",
                                  "bad offset", "dictionary", "content size", "version"])
def test_malformed_frames_raise(case):
    data = INPUTS["compressible"]
    frame = _frame(data)
    n = len(data)
    bad = {
        "bad magic": (b"\0" + frame[1:], n),
        "truncated": (frame[:len(frame) // 2], n),
        "short output": (frame, n - 1),
        "long output": (frame, n + 1),
        "dictionary": (frame[:4] + bytes([frame[4] | 1]) + frame[5:], n),
        "content size": (_with_options(frame, content_size=n - 5), n),
        "version": (frame[:4] + bytes([frame[4] & 0x3F]) + frame[5:], n),
    }
    if case == "bad offset":  # a first sequence whose match reaches before the output
        block = bytes([0x10]) + b"a" + struct.pack("<H", 9) + bytes([0x10]) + b"b"
        bad[case] = (struct.pack("<I", lz4.MAGIC) + bytes([0x40, 0x40, 0])
                     + struct.pack("<I", len(block)) + block + bytes(4), 7)
    frame, size = bad[case]
    for k, fn in _decoders().items():
        with pytest.raises(ValueError, match="lz4"):
            fn(frame, size)

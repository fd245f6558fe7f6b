"""LZ4 frame decoding in Python, and the choice of decoder.

The Arrow IPC files that pandas writes (``DataFrame.to_feather``) hold
their buffers as LZ4 frames (the LZ4 frame format, version 1.6.x of its
specification). :func:`decode_frame` decodes the whole format:

- the magic number ``0x184D2204``; skippable frames (``0x184D2A50`` to
  ``0x184D2A5F``) are passed over, and frames that follow one another are
  decoded one after the other;
- the FLG and BD bytes, the optional content size (checked against the
  output when present), the header checksum byte (parsed, not verified);
- blocks of at most the BD byte's size, each a compressed LZ4 block or,
  when its size word has its high bit set, stored raw; an optional block
  checksum after each (parsed, not verified); the end mark (a zero size
  word) and the optional content checksum (parsed, not verified);
- linked blocks: every block decodes into one output, so a match may reach
  back into the blocks before it (the window is the whole output);
- matches that overlap their own output (an offset below the match
  length), and the 255-run extensions of literal and match lengths.

A frame that needs a dictionary (the FLG's DictID bit) is refused.

:func:`decode` is what readers call: the native library's decoder
(``native.lz4_frame_decode``, the same format in C++) where it is built,
else :func:`decode_frame`; both raise unless the output is exactly the
length the caller expects.
"""

from __future__ import annotations

import struct
from typing import Optional

MAGIC = 0x184D2204
SKIPPABLE_MASK = 0xFFFFFFF0
SKIPPABLE = 0x184D2A50
BLOCK_MAX = {4: 64 << 10, 5: 256 << 10, 6: 1 << 20, 7: 4 << 20}


def _need(src, pos: int, n: int) -> None:
    if pos + n > len(src):
        raise ValueError(f"lz4: truncated frame ({n} bytes needed at {pos} of {len(src)})")


def _block(src, pos: int, end: int, out: bytearray) -> None:
    """Decode the LZ4 block ``src[pos:end]`` onto the end of ``out``."""
    while True:
        if pos >= end:
            raise ValueError("lz4: block ends inside a sequence")
        token = src[pos]
        pos += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if pos >= end:
                    raise ValueError("lz4: block ends inside a literal length")
                b = src[pos]
                pos += 1
                lit += b
                if b != 255:
                    break
        if pos + lit > end:
            raise ValueError("lz4: literals run past the block")
        out += src[pos:pos + lit]
        pos += lit
        if pos == end:  # the last sequence holds literals only
            return
        if pos + 2 > end:
            raise ValueError("lz4: block ends inside a match offset")
        offset = src[pos] | (src[pos + 1] << 8)
        pos += 2
        if offset == 0 or offset > len(out):
            raise ValueError(f"lz4: match offset {offset} outside the {len(out)} bytes "
                             "decoded")
        length = token & 15
        if length == 15:
            while True:
                if pos >= end:
                    raise ValueError("lz4: block ends inside a match length")
                b = src[pos]
                pos += 1
                length += b
                if b != 255:
                    break
        length += 4
        start = len(out) - offset
        if length <= offset:
            out += out[start:start + length]
        else:  # the match overlaps its own output: the last `offset` bytes repeat
            reps, rest = divmod(length, offset)
            pattern = bytes(out[start:])
            out += pattern * reps + pattern[:rest]


def decode_frame(data, size: Optional[int] = None) -> bytes:
    """The bytes that the LZ4 frame(s) in ``data`` hold; raises unless they
    are ``size`` bytes, where ``size`` is given."""
    src = bytes(data)
    out = bytearray()
    pos = 0
    while pos < len(src):
        _need(src, pos, 4)
        magic = struct.unpack_from("<I", src, pos)[0]
        pos += 4
        if magic & SKIPPABLE_MASK == SKIPPABLE:
            _need(src, pos, 4)
            pos += 4 + struct.unpack_from("<I", src, pos)[0]
            _need(src, pos, 0)
            continue
        if magic != MAGIC:
            raise ValueError(f"lz4: bad magic 0x{magic:08X} at {pos - 4}")
        _need(src, pos, 2)
        flg, bd = src[pos], src[pos + 1]
        pos += 2
        if flg >> 6 != 1:
            raise ValueError(f"lz4: frame version {flg >> 6}, not 1")
        if flg & 1:
            raise ValueError("lz4: the frame needs a dictionary")
        block_max = BLOCK_MAX.get((bd >> 4) & 7)
        if block_max is None:
            raise ValueError(f"lz4: bad block size code in BD 0x{bd:02X}")
        block_checksum, content_checksum = flg & 0x10, flg & 0x04
        content_size = None
        if flg & 0x08:
            _need(src, pos, 8)
            content_size = struct.unpack_from("<Q", src, pos)[0]
            pos += 8
        _need(src, pos, 1)
        pos += 1  # the header checksum
        first = len(out)
        while True:
            _need(src, pos, 4)
            word = struct.unpack_from("<I", src, pos)[0]
            pos += 4
            if word == 0:
                break
            n_block = word & 0x7FFFFFFF
            if n_block > block_max:
                raise ValueError(f"lz4: block of {n_block} bytes above the frame's "
                                 f"{block_max}")
            _need(src, pos, n_block)
            if word & 0x80000000:
                out += src[pos:pos + n_block]
            else:
                before = len(out)
                _block(src, pos, pos + n_block, out)
                if len(out) - before > block_max:
                    raise ValueError(f"lz4: block decodes to more than {block_max} bytes")
            pos += n_block
            if block_checksum:
                _need(src, pos, 4)
                pos += 4
        if content_checksum:
            _need(src, pos, 4)
            pos += 4
        if content_size is not None and len(out) - first != content_size:
            raise ValueError(f"lz4: frame holds {len(out) - first} bytes, its header "
                             f"says {content_size}")
    if size is not None and len(out) != size:
        raise ValueError(f"lz4: frame holds {len(out)} bytes, not the {size} expected")
    return bytes(out)


def decode(data, size: int) -> bytes:
    """The ``size`` bytes that the LZ4 frame ``data`` holds, through the
    native library where it is built; raises unless the frame holds
    exactly ``size`` bytes."""
    from himo_tpu_torch import native

    if native.available():
        return native.lz4_frame_decode(data, size)
    return decode_frame(data, size)

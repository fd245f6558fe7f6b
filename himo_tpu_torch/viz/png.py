"""PNG stills and APNG animations with numpy and ``zlib`` alone.

The JAX package writes its images with ``cv2.imwrite`` and its fly-throughs
with ``cv2.VideoWriter``; the port writes both without cv2 or PIL:

- :func:`write` / :func:`encode`: one 8-bit RGB image (colour type 2, not
  interlaced) as signature, IHDR, one IDAT and IEND.
- :class:`APNGWriter`: an animated PNG. The file holds IHDR, ``acTL``, then
  for each frame an ``fcTL`` (the whole canvas, a delay of ``1/fps`` s, no
  disposal, source blending) followed by the frame's data, in ``IDAT`` for
  the first frame (which is also the still a plain PNG viewer shows) and in
  ``fdAT`` after it. Frames go to disk as they come; ``close`` patches the
  frame count into ``acTL`` and that chunk's CRC.
- :func:`read` / :func:`read_apng`: readers for exactly what the writers
  emit. They raise on anything else (another colour type or bit depth,
  interlacing, an unknown chunk, a bad CRC, another row filter).

Every row is stored with the PNG "Up" filter (type 2): each byte minus the
byte above it. The writer computes it for the whole image at once, and the
reader undoes it with one ``cumsum`` down the columns (modulo 256), where
a Paeth decode would need a Python loop per pixel.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import List, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
FILTER_UP = 2
COMPRESS_LEVEL = 6  # zlib's default
_IHDR_TAIL = bytes([8, 2, 0, 0, 0])  # bit depth 8, RGB, deflate, filter method 0, no interlace
_ACTL_OFFSET = len(SIGNATURE) + 12 + 13  # acTL follows the signature and IHDR


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(
        ">I", zlib.crc32(kind + data))


def _check_image(image: np.ndarray) -> np.ndarray:
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3 or 0 in image.shape:
        raise ValueError(f"PNG images are (H, W, 3) uint8 RGB, not {image.dtype} "
                         f"{image.shape}")
    return image


def _header(height: int, width: int) -> bytes:
    return SIGNATURE + _chunk(b"IHDR", struct.pack(">II", width, height) + _IHDR_TAIL)


def image_data(image: np.ndarray) -> bytes:
    """The IDAT / fdAT payload of an image: its scanlines, each
    ``FILTER_UP`` then the row minus the row above it (the first row minus
    zeros), zlib-compressed."""
    h, w, _ = image.shape
    rows = np.empty((h, 1 + 3 * w), np.uint8)
    rows[:, 0] = FILTER_UP
    flat = image.reshape(h, 3 * w)
    rows[0, 1:] = flat[0]
    np.subtract(flat[1:], flat[:-1], out=rows[1:, 1:])  # uint8 arithmetic wraps mod 256
    return zlib.compress(rows.tobytes(), COMPRESS_LEVEL)


def encode(image: np.ndarray) -> bytes:
    """The PNG file of an (H, W, 3) uint8 RGB image."""
    image = _check_image(image)
    return (_header(*image.shape[:2]) + _chunk(b"IDAT", image_data(image))
            + _chunk(b"IEND", b""))


def write(path, image: np.ndarray) -> str:
    """Write ``image`` as a PNG file at ``path``; returns the path."""
    data = encode(image)
    Path(path).write_bytes(data)
    return str(path)


class APNGWriter:
    """An animated PNG written frame by frame (``with APNGWriter(...) as w:
    w.write(frame)``). Every frame is the whole ``(height, width)`` canvas
    and shows for ``1/fps`` s; the animation loops forever."""

    def __init__(self, path, fps: int, height: int, width: int):
        if fps <= 0 or fps > 0xFFFF:
            raise ValueError(f"fps must be in 1..65535, not {fps}")
        self.path, self.fps, self.shape = str(path), int(fps), (height, width)
        self.frames = 0
        self._seq = 0
        self._file = open(self.path, "wb")
        self._file.write(_header(height, width) + _chunk(b"acTL", struct.pack(">II", 0, 0)))

    def write(self, image: np.ndarray) -> None:
        image = _check_image(image)
        if image.shape[:2] != self.shape:
            raise ValueError(f"frame {image.shape[:2]} on a {self.shape} canvas")
        h, w = self.shape
        fctl = struct.pack(">IIIIIHHBB", self._seq, w, h, 0, 0, 1, self.fps, 0, 0)
        data = image_data(image)
        if self.frames == 0:
            out = _chunk(b"fcTL", fctl) + _chunk(b"IDAT", data)
            self._seq += 1
        else:
            out = _chunk(b"fcTL", fctl) + _chunk(b"fdAT", struct.pack(">I", self._seq + 1) + data)
            self._seq += 2
        self._file.write(out)
        self.frames += 1

    def close(self) -> None:
        """End the file and patch the frame count into ``acTL``; an
        animation needs at least one frame."""
        if self._file.closed:
            return
        try:
            if not self.frames:
                raise ValueError(f"{self.path}: an APNG needs at least one frame")
            self._file.write(_chunk(b"IEND", b""))
            self._file.seek(_ACTL_OFFSET)
            self._file.write(_chunk(b"acTL", struct.pack(">II", self.frames, 0)))
        finally:
            self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is not None:  # keep the error; the partial file stays unfinished
            self._file.close()
        self.close()


def _chunks(data: bytes):
    """(type, payload) of every chunk after the signature, CRCs checked."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("truncated PNG chunk")
        (length,) = struct.unpack_from(">I", data, pos)
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        end = pos + 12 + length
        if end > len(data) or struct.unpack_from(">I", data, end - 4)[0] != zlib.crc32(
                kind + body):
            raise ValueError(f"bad CRC or truncated chunk {kind!r}")
        yield kind, body
        pos = end


def _unfilter(compressed: bytes, height: int, width: int) -> np.ndarray:
    raw = np.frombuffer(zlib.decompress(compressed), np.uint8)
    if raw.size != height * (1 + 3 * width):
        raise ValueError(f"image data of {raw.size} bytes for {height} x {width} RGB")
    rows = raw.reshape(height, 1 + 3 * width)
    if (rows[:, 0] != FILTER_UP).any():
        raise ValueError("a row filter other than Up (2)")
    return np.cumsum(rows[:, 1:], axis=0, dtype=np.uint8).reshape(height, width, 3)


def _parse(data: bytes) -> Tuple[List[np.ndarray], List[Tuple[int, int]], bool]:
    """(frames, delays as (numerator, denominator), animated) of a file
    in the writers' form."""
    chunks = list(_chunks(data))
    if not chunks or chunks[0][0] != b"IHDR" or chunks[-1] != (b"IEND", b""):
        raise ValueError("a PNG must open with IHDR and end with an empty IEND")
    ihdr = chunks[0][1]
    if len(ihdr) != 13 or ihdr[8:] != _IHDR_TAIL:
        raise ValueError("only 8-bit RGB, non-interlaced PNGs are read")
    width, height = struct.unpack(">II", ihdr[:8])
    body = chunks[1:-1]
    if body and body[0][0] != b"acTL":
        if any(kind != b"IDAT" for kind, _ in body):
            raise ValueError(f"unexpected chunks {[k for k, _ in body]}")
        return [_unfilter(b"".join(d for _, d in body), height, width)], [], False
    if not body:
        raise ValueError("no image data")
    count, plays = struct.unpack(">II", body[0][1])
    frames, delays, seq = [], [], 0
    rest = body[1:]
    while rest:
        kind, fctl = rest[0]
        if kind != b"fcTL" or len(fctl) != 26:
            raise ValueError(f"expected fcTL, got {kind!r}")
        s, w, h, x, y, num, den, dispose, blend = struct.unpack(">IIIIIHHBB", fctl)
        if (s, w, h, x, y, dispose, blend) != (seq, width, height, 0, 0, 0, 0):
            raise ValueError("only whole-canvas frames in sequence are read")
        data_kind = b"IDAT" if not frames else b"fdAT"
        if len(rest) < 2 or rest[1][0] != data_kind:
            raise ValueError(f"frame {len(frames)} lacks its {data_kind!r}")
        payload = rest[1][1]
        if frames:
            if struct.unpack(">I", payload[:4])[0] != seq + 1:
                raise ValueError("fdAT out of sequence")
            payload, seq = payload[4:], seq + 2
        else:
            seq += 1
        frames.append(_unfilter(payload, height, width))
        delays.append((num, den))
        rest = rest[2:]
    if count != len(frames) or plays != 0:
        raise ValueError(f"acTL says {count} frames ({plays} plays), the file has "
                         f"{len(frames)}")
    return frames, delays, True


def read(path) -> np.ndarray:
    """The (H, W, 3) uint8 RGB image of a PNG that :func:`write` wrote."""
    frames, _, animated = _parse(Path(path).read_bytes())
    if animated:
        raise ValueError(f"{path} is an APNG: read it with read_apng")
    return frames[0]


def read_apng(path) -> Tuple[List[np.ndarray], List[Tuple[int, int]]]:
    """(frames, delays) of an APNG that :class:`APNGWriter` wrote: every
    frame as an (H, W, 3) uint8 RGB image, each delay as (numerator,
    denominator) seconds."""
    frames, delays, animated = _parse(Path(path).read_bytes())
    if not animated:
        raise ValueError(f"{path} is a still PNG: read it with read")
    return frames, delays

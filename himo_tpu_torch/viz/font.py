"""A bitmap font for labels drawn into numpy images (the port has no cv2).

The glyphs are the public-domain 8x8 ``font8x8_basic`` (the IBM PC BIOS
shapes) for printable ASCII, U+0020 to U+007E, typed in as data: eight
rows per glyph, top first, bit 0 of each byte the leftmost pixel. Row 7 is
below the baseline (descenders). :func:`draw_text` scales the glyphs by an
integer factor and, like ``cv2.putText``, places the text by the left end
of its baseline and clips it to the image.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

GLYPH = 8  # pixels a side, unscaled
BASELINE_ROW = 7  # the first glyph row below the baseline

_ROWS = (
    "0000000000000000", "183c3c1818001800", "3636000000000000", "36367f367f363600",  # ' !"#
    "0c3e031e301f0c00", "006333180c666300", "1c361c6e3b336e00", "0606030000000000",  # $%&'
    "180c0606060c1800", "060c1818180c0600", "00663cff3c660000", "000c0c3f0c0c0000",  # ()*+
    "00000000000c0c06", "0000003f00000000", "00000000000c0c00", "6030180c06030100",  # ,-./
    "3e63737b6f673e00", "0c0e0c0c0c0c3f00", "1e33301c06333f00", "1e33301c30331e00",  # 0123
    "383c36337f307800", "3f031f3030331e00", "1c06031f33331e00", "3f3330180c0c0c00",  # 4567
    "1e33331e33331e00", "1e33333e30180e00", "000c0c00000c0c00", "000c0c00000c0c06",  # 89:;
    "180c0603060c1800", "00003f00003f0000", "060c1830180c0600", "1e3330180c000c00",  # <=>?
    "3e637b7b7b031e00", "0c1e33333f333300", "3f66663e66663f00", "3c66030303663c00",  # @ABC
    "1f36666666361f00", "7f46161e16467f00", "7f46161e16060f00", "3c66030373667c00",  # DEFG
    "3333333f33333300", "1e0c0c0c0c0c1e00", "7830303033331e00", "6766361e36666700",  # HIJK
    "0f06060646667f00", "63777f7f6b636300", "63676f7b73636300", "1c36636363361c00",  # LMNO
    "3f66663e06060f00", "1e3333333b1e3800", "3f66663e36666700", "1e33070e38331e00",  # PQRS
    "3f2d0c0c0c0c1e00", "3333333333333f00", "33333333331e0c00", "6363636b7f776300",  # TUVW
    "6363361c1c366300", "3333331e0c0c1e00", "7f6331184c667f00", "1e06060606061e00",  # XYZ[
    "03060c1830604000", "1e18181818181e00", "081c366300000000", "00000000000000ff",  # \]^_
    "0c0c180000000000", "00001e303e336e00", "0706063e66663b00", "00001e3303331e00",  # `abc
    "3830303e33336e00", "00001e333f031e00", "1c36060f06060f00", "00006e33333e301f",  # defg
    "0706366e66666700", "0c000e0c0c0c1e00", "300030303033331e", "070666361e366700",  # hijk
    "0e0c0c0c0c0c1e00", "0000337f7f6b6300", "00001f3333333300", "00001e3333331e00",  # lmno
    "00003b66663e060f", "00006e33333e3078", "00003b6e66060f00", "00003e031e301f00",  # pqrs
    "080c3e0c0c2c1800", "0000333333336e00", "00003333331e0c00", "0000636b7f7f3600",  # tuvw
    "000063361c366300", "00003333333e301f", "00003f190c263f00", "380c0c070c0c3800",  # xyz{
    "1818180018181800", "070c0c380c0c0700", "6e3b000000000000",                      # |}~
)
FIRST = 0x20
# (95, 8, 8) bool: glyph, row, column.
GLYPHS = np.unpackbits(
    np.frombuffer(bytes.fromhex("".join(_ROWS)), np.uint8).reshape(-1, GLYPH, 1),
    axis=2, bitorder="little").astype(bool)


def _glyph(ch: str) -> np.ndarray:
    code = ord(ch)
    if not FIRST <= code < FIRST + len(GLYPHS):
        code = ord("?")
    return GLYPHS[code - FIRST]


def text_mask(text: str, scale: int = 2) -> np.ndarray:
    """(8 * scale, 8 * scale * len(text)) bool pixels of ``text``; a
    character outside printable ASCII shows as '?'."""
    if not text:
        return np.zeros((GLYPH * scale, 0), bool)
    mask = np.concatenate([_glyph(ch) for ch in text], axis=1)
    return mask.repeat(scale, axis=0).repeat(scale, axis=1)


def text_box(text: str, org: Tuple[int, int], scale: int = 2) -> Tuple[int, int, int, int]:
    """(top, left, bottom, right) of the pixels :func:`draw_text` may set,
    bottom and right exclusive, before clipping to the image."""
    x, y = org
    top = y - BASELINE_ROW * scale
    return top, x, top + GLYPH * scale, x + GLYPH * scale * len(text)


def draw_text(img: np.ndarray, text: str, org: Tuple[int, int], color, scale: int = 2
              ) -> np.ndarray:
    """Draw ``text`` into ``img`` (H, W, C) in place, ``org`` = (x, y) the
    left end of the baseline as in ``cv2.putText``; clipped to the image."""
    mask = text_mask(text, scale)
    top, left, bottom, right = text_box(text, org, scale)
    h, w = img.shape[:2]
    t, l, b, r = max(top, 0), max(left, 0), min(bottom, h), min(right, w)
    if t < b and l < r:
        region = img[t:b, l:r]
        region[mask[t - top:b - top, l - left:r - left]] = color
    return img

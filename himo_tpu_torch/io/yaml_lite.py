"""The subset of YAML that vehicle extrinsics files use, read without PyYAML
(the GPU host has none): what ``data/scania.load_lidar_extrinsics`` reads
from a ``{vehicle}-generated.yml``.

What it reads, to what ``yaml.safe_load`` gives:

- one document (an optional ``---`` first and ``...`` last);
- block mappings nested by indentation, block sequences (``- item``, also
  at their parent key's indentation, also holding mappings: ``- key: v``),
  flow sequences and mappings (``[a, b]``, ``{k: v}``, nested, across
  lines), and comments;
- plain, single- and double-quoted scalars on one line, quoted ones with
  their escapes; plain scalars and keys resolved by YAML 1.1's rules as
  PyYAML's safe loader does: bool (``yes``/``no``/``on``/``off``/``true``/
  ``false`` in three cases), int (decimal, ``0x``, ``0b``, a leading-0
  octal, ``_`` separators, base 60 ``1:30``), float (a dot required,
  ``1.5e+3``, ``.inf``, ``-.Inf``, ``.nan``, base 60), null (``~``,
  ``null``, nothing), else str. A repeated key keeps its last value.

Anything else raises :class:`YAMLSubsetError`, naming the line: anchors
and aliases (``&a``, ``*a``), tags (``!x``), block scalars (``|``, ``>``),
multi-line plain or quoted scalars, complex keys (``?``), merge keys
(``<<``), timestamps, directives and a second document.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Any, List, NamedTuple, Tuple, Union

_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_NULL = {"~", "null", "Null", "NULL", ""}
# PyYAML's implicit resolvers (resolver.py), in the order it tries them.
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9_]+(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                    (?:[Tt]|[ \t]+)[0-9][0-9]?
                    :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                    (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_REFUSED_START = {"&": "an anchor", "*": "an alias", "!": "a tag", "|": "a block scalar",
                  ">": "a block scalar", "%": "a directive", "@": "a reserved indicator",
                  "`": "a reserved indicator", "?": "a complex key",
                  ",": "a flow indicator outside a flow collection",
                  "]": "a flow indicator outside a flow collection",
                  "}": "a flow indicator outside a flow collection"}


class YAMLSubsetError(ValueError):
    """Outside the subset, or not YAML; the message names the line."""


class _Line(NamedTuple):
    number: int  # 1-based
    indent: int
    text: str  # without indentation, comment and trailing blanks


def _sexagesimal(value: str, kind):
    total, base = kind(0), 1
    for part in reversed(value.split(":")):
        total += kind(part) * base
        base *= 60
    return total


def _resolve(text: str, where: str) -> Any:
    """A plain scalar's value under PyYAML's safe resolvers."""
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        value = value.lstrip("+-")
        if value == ".inf":
            return sign * float("inf")
        if value == ".nan":
            return float("nan")
        return sign * (_sexagesimal(value, float) if ":" in value else float(value))
    if _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        return sign * (_sexagesimal(value, int) if ":" in value else int(value))
    if text in ("<<", "="):
        raise YAMLSubsetError(f"{where}: the {text!r} key is outside the subset")
    if text in _NULL:
        return None
    if _TIMESTAMP.match(text):
        raise YAMLSubsetError(f"{where}: timestamp {text!r} is outside the subset")
    return text


def _quoted(text: str, pos: int, where: str) -> Tuple[str, int]:
    """The quoted scalar opening at ``text[pos]``; (value, position after it)."""
    quote, out, i = text[pos], [], pos + 1
    while i < len(text):
        ch = text[i]
        if ch == quote:
            if quote == "'" and text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if ch == "\\" and quote == '"':
            code = text[i + 1:i + 2]
            if code in _ESCAPES:
                out.append(_ESCAPES[code])
                i += 2
            elif code in _HEX_ESCAPES:
                digits = text[i + 2:i + 2 + _HEX_ESCAPES[code]]
                if len(digits) != _HEX_ESCAPES[code] or not all(
                        c in "0123456789abcdefABCDEF" for c in digits):
                    raise YAMLSubsetError(f"{where}: bad escape \\{code}{digits}")
                out.append(chr(int(digits, 16)))
                i += 2 + len(digits)
            else:
                raise YAMLSubsetError(f"{where}: unknown escape \\{code}")
            continue
        out.append(ch)
        i += 1
    raise YAMLSubsetError(f"{where}: a quoted scalar that does not close on its line "
                          "(multi-line scalars are outside the subset)")


def _strip_comment(text: str, where: str) -> str:
    """``text`` without its comment: a ``#`` at the start or after a blank,
    outside quotes. A quote opens a scalar only where one may start."""
    i = 0
    while i < len(text):
        ch = text[i]
        if ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        if ch in "'\"":
            before = text[:i].rstrip()
            if not before or before[-1] in "[{," or (
                    text[i - 1] in " \t" and before[-1] in ":-"):
                _, i = _quoted(text, i, where)
                continue
        i += 1
    return text.rstrip()


class _Parser:
    def __init__(self, source: str, name: str):
        self.name = name
        self.lines: List[_Line] = []
        started = ended = False
        for number, raw in enumerate(source.splitlines(), 1):
            where = f"{name}:{number}"
            body = raw.lstrip(" ")
            if body[:1] == "\t" and body.strip():
                raise YAMLSubsetError(f"{where}: a tab in the indentation")
            text = _strip_comment(body, where)
            if not text:
                continue
            indent = len(raw) - len(body)
            if indent == 0 and (text == "---" or text.startswith("--- ")):
                if started or self.lines:
                    raise YAMLSubsetError(f"{where}: a second document is outside the subset")
                if text != "---":
                    raise YAMLSubsetError(f"{where}: content after '---' is outside the subset")
                started = True
                continue
            elif indent == 0 and text == "...":
                ended = True
                continue
            elif ended:
                raise YAMLSubsetError(f"{where}: content after the document's end")
            elif indent == 0 and text.startswith("%"):
                raise YAMLSubsetError(f"{where}: a directive is outside the subset")
            self.lines.append(_Line(number, indent, text))

    def where(self, i: int) -> str:
        number = self.lines[i].number if i < len(self.lines) else "end"
        return f"{self.name}:{number}"

    def document(self) -> Any:
        if not self.lines:
            return None
        value, i = self.block(0, self.lines[0].indent)
        if i < len(self.lines):
            raise YAMLSubsetError(f"{self.where(i)}: unexpected indentation")
        return value

    @staticmethod
    def _is_item(text: str) -> bool:
        return text == "-" or text.startswith("- ")

    def block(self, i: int, indent: int) -> Tuple[Any, int]:
        text = self.lines[i].text
        if self._is_item(text):
            return self.sequence(i, indent)
        if self._split_key(text, i) is not None:
            return self.mapping(i, indent)
        return self.inline(text, i)

    def _nested(self, i: int, indent: int, indentless: bool) -> Tuple[Any, int]:
        """The block value below the line ``i - 1`` at ``indent``: more
        indented lines, or (``indentless``) a sequence at ``indent``."""
        if i < len(self.lines):
            line = self.lines[i]
            if line.indent > indent:
                return self.block(i, line.indent)
            if indentless and line.indent == indent and self._is_item(line.text):
                return self.sequence(i, indent)
        return None, i

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out: dict = {}
        while i < len(self.lines) and self.lines[i].indent == indent:
            split = None if self._is_item(self.lines[i].text) else \
                self._split_key(self.lines[i].text, i)
            if split is None:
                raise YAMLSubsetError(f"{self.where(i)}: expected 'key: value' in a mapping")
            key, rest = split
            if rest:
                out[key], i = self.inline(rest, i)
            else:
                out[key], i = self._nested(i + 1, indent, indentless=True)
        if i < len(self.lines) and self.lines[i].indent > indent:
            raise YAMLSubsetError(f"{self.where(i)}: unexpected indentation")
        return out, i

    def sequence(self, i: int, indent: int) -> Tuple[list, int]:
        out: list = []
        while (i < len(self.lines) and self.lines[i].indent == indent
               and self._is_item(self.lines[i].text)):
            line = self.lines[i]
            rest = line.text[1:].lstrip(" ")
            if rest:
                # The item's node starts where its text does.
                column = indent + len(line.text) - len(rest)
                self.lines[i] = _Line(line.number, column, rest)
                value, i = self.block(i, column)
            else:
                value, i = self._nested(i + 1, indent, indentless=False)
            out.append(value)
        if i < len(self.lines) and self.lines[i].indent > indent:
            raise YAMLSubsetError(f"{self.where(i)}: unexpected indentation")
        return out, i

    def _split_key(self, text: str, i: int):
        """(key, rest) of a ``key: rest`` line, or None."""
        where = self.where(i)
        if text[0] in "'\"":
            value, end = _quoted(text, 0, where)
            after = text[end:].lstrip(" ")
            if after == ":" or after.startswith(": "):
                return value, after[1:].strip()
            return None
        if text[0] in "[{":
            return None
        m = re.search(r":(?= |$)", text)
        if m is None:
            return None
        if text[0] in _REFUSED_START:
            raise YAMLSubsetError(f"{where}: {_REFUSED_START[text[0]]} is outside the subset")
        return _resolve(text[:m.start()].rstrip(), where), text[m.end():].strip()

    def inline(self, text: str, i: int) -> Tuple[Any, int]:
        """The one-line node ``text`` of line ``i`` (a flow collection may
        continue on the next lines); (value, next line)."""
        where, indent = self.where(i), self.lines[i].indent
        if text[0] in "[{":
            j = i
            while True:
                try:
                    value, end = _Flow(text, where).node(0)
                    break
                except _Unclosed:
                    j += 1
                    if j == len(self.lines):
                        raise YAMLSubsetError(f"{where}: a flow collection that never closes")
                    text += " " + self.lines[j].text
            if text[end:].strip():
                raise YAMLSubsetError(f"{where}: text after a flow collection")
            i = j
        elif text[0] in "'\"":
            value, end = _quoted(text, 0, where)
            if text[end:].strip():
                raise YAMLSubsetError(f"{where}: text after a quoted scalar")
        else:
            if text[0] in _REFUSED_START or self._is_item(text):
                what = _REFUSED_START.get(text[0], "a sequence entry")
                raise YAMLSubsetError(f"{where}: {what} is outside the subset here")
            if re.search(r":(?= |$)", text):
                raise YAMLSubsetError(f"{where}: a mapping value is not allowed here")
            value = _resolve(text, where)
        if i + 1 < len(self.lines) and self.lines[i + 1].indent > indent:
            raise YAMLSubsetError(f"{self.where(i + 1)}: a multi-line scalar, or bad "
                                  "indentation (outside the subset)")
        return value, i + 1


class _Unclosed(Exception):
    pass


# A plain scalar inside a flow collection: up to a flow indicator, or a ':'
# followed by a blank, an indicator or the end.
_FLOW_PLAIN = re.compile(r"[^,\[\]{}]*?(?=\s*(?:[,\[\]{}]|:(?:[ ,\[\]{}]|$)|$))")


class _Flow:
    """Flow collections and their scalars, over one (joined) text."""

    def __init__(self, text: str, where: str):
        self.text, self.where = text, where

    def _skip(self, pos: int) -> int:
        while pos < len(self.text) and self.text[pos] == " ":
            pos += 1
        if pos == len(self.text):
            raise _Unclosed
        return pos

    def node(self, pos: int) -> Tuple[Any, int]:
        pos = self._skip(pos)
        ch = self.text[pos]
        if ch == "[":
            return self._collection(pos + 1, "]")
        if ch == "{":
            return self._collection(pos + 1, "}")
        if ch in "'\"":
            return _quoted(self.text, pos, self.where)
        if ch in _REFUSED_START or ch == "-" and self.text[pos + 1:pos + 2] in (" ", ""):
            raise YAMLSubsetError(
                f"{self.where}: {_REFUSED_START.get(ch, 'a block entry')} is outside the subset")
        m = _FLOW_PLAIN.match(self.text, pos)
        if not m.group():
            raise YAMLSubsetError(f"{self.where}: an empty flow entry")
        return _resolve(m.group(), self.where), m.end()

    def _collection(self, pos: int, close: str) -> Tuple[Any, int]:
        items: list = []
        out: Union[list, dict] = items if close == "]" else {}
        while True:
            pos = self._skip(pos)
            if self.text[pos] == close:
                return out, pos + 1
            value, pos = self.node(pos)
            pos = self._skip(pos)
            if close == "}":
                if self.text[pos] != ":":
                    raise YAMLSubsetError(f"{self.where}: expected ':' in a flow mapping")
                out[value], pos = self.node(pos + 1)
                pos = self._skip(pos)
            elif self.text[pos] == ":":
                raise YAMLSubsetError(f"{self.where}: a mapping inside a flow sequence "
                                      "is outside the subset")
            else:
                items.append(value)
            if self.text[pos] == ",":
                pos += 1
            elif self.text[pos] != close:
                raise YAMLSubsetError(f"{self.where}: expected ',' or {close!r}")


def safe_load(text: str, name: str = "<string>") -> Any:
    """The document in ``text``, as ``yaml.safe_load`` reads it."""
    return _Parser(text, name).document()


def load(path: Union[str, Path]) -> Any:
    """The document in the file at ``path``."""
    return safe_load(Path(path).read_text(encoding="utf-8"), str(path))

"""A reader for the part of YAML the model configs use: the port's only
config reader, so that a machine without PyYAML reads them as one with it.

Block mappings and block sequences by indentation, flow sequences and
mappings (``[a, "b"]``, ``{k: v}``, also over several lines), plain, single- and double-quoted
scalars resolved as PyYAML's ``safe_load`` resolves them (YAML 1.1: null,
booleans with yes/no/on/off, ints, floats that carry a dot or are
``.inf`` / ``.nan``, the rest strings), comments, anchors (``&name``),
aliases (``*name``), the ``!!merge`` tag and merge keys (``<<: *name``).
Anything else (multi-line scalars, block literals, documents, other tags)
raises ``ValueError``.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple

_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
# PyYAML's resolvers (sexagesimal numbers left out)
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_INT_BASES = ((re.compile(r"^[-+]?0b[01_]+$"), 2), (re.compile(r"^[-+]?0x[0-9a-fA-F_]+$"), 16),
              (re.compile(r"^[-+]?0[0-7_]+$"), 8))
_FLOAT = re.compile(r"^([-+]?[0-9][0-9_]*\.[0-9_]*([eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*([eE][-+][0-9]+)?)$")
_INF = re.compile(r"^[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"^\.(nan|NaN|NAN)$")
_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", '"': '"', "\\": "\\", "/": "/", "0": "\0",
            "b": "\b", "f": "\f", " ": " "}


def _plain(s: str) -> Any:
    if s in _NULL:
        return None
    if s in _TRUE:
        return True
    if s in _FALSE:
        return False
    if _INT.match(s):
        return int(s.replace("_", ""))
    for pattern, base in _INT_BASES:
        if pattern.match(s):
            digits = s.replace("_", "").lstrip("+-")
            value = int(digits[2:] if base != 8 else digits, base)
            return -value if s.startswith("-") else value
    if _FLOAT.match(s):
        return float(s.replace("_", ""))
    if _INF.match(s):
        return float("-inf") if s.startswith("-") else float("inf")
    if _NAN.match(s):
        return float("nan")
    return s


def _strip_comment(line: str) -> str:
    """The line without a trailing comment (a # outside quotes, at the start
    or after whitespace)."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


# what may stand before a flow collection that opens a value on its line
_FLOW_START = re.compile(r"^\s*(-\s+|.*?:\s+)?((&|!!)\S+\s+)*$")


def _flow_depth(line: str, depth: int) -> int:
    """The depth of open flow collections after ``line``, ``depth`` open
    before it. At depth 0 a bracket opens one only where a value starts."""
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = c
        elif c in "[{" and (depth or _FLOW_START.match(line[:i])):
            depth += 1
        elif c in "]}" and depth:
            depth -= 1
    return depth


class _Reader:
    def __init__(self, text: str):
        self.lines: List[Tuple[int, str]] = []
        depth = 0
        for raw in text.splitlines():
            if "\t" in raw[: len(raw) - len(raw.lstrip())] and not depth:
                raise ValueError("tabs in indentation")
            line = _strip_comment(raw)
            if depth:  # a flow collection carried on from the line before
                if line.strip():
                    ind, prev = self.lines[-1]
                    self.lines[-1] = (ind, f"{prev} {line.strip()}")
                    depth = _flow_depth(line.strip(), depth)
                continue
            if not line.strip() or line.strip() in ("---", "..."):
                continue
            if line.lstrip().startswith("%"):
                raise ValueError(f"unsupported YAML directive: {line!r}")
            self.lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
            depth = _flow_depth(line.strip(), 0)
        if depth:
            raise ValueError(f"unterminated flow collection: {self.lines[-1][1]!r}")
        self.i = 0
        self.anchors: Dict[str, Any] = {}

    # ------------------------------------------------------------- scalars
    def _quoted(self, s: str, pos: int) -> Tuple[str, int]:
        q, out, i = s[pos], [], pos + 1
        while i < len(s):
            c = s[i]
            if q == "'" and c == "'":
                if s[i + 1: i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            if q == '"' and c == "\\":
                e = s[i + 1]
                if e == "x":
                    out.append(chr(int(s[i + 2: i + 4], 16)))
                    i += 4
                elif e == "u":
                    out.append(chr(int(s[i + 2: i + 6], 16)))
                    i += 6
                elif e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    i += 2
                else:
                    raise ValueError(f"unsupported escape \\{e} in {s!r}")
                continue
            if q == '"' and c == '"':
                return "".join(out), i + 1
            out.append(c)
            i += 1
        raise ValueError(f"unterminated quote in {s!r}")

    def _node_props(self, s: str) -> Tuple[str | None, str]:
        """Strip a leading tag (!!merge, !!str ...) and anchor; returns
        (anchor, rest)."""
        anchor = None
        while True:
            s = s.lstrip()
            if s.startswith("!!"):
                tag, _, s = s.partition(" ")
                if tag not in ("!!merge", "!!map", "!!seq"):
                    raise ValueError(f"unsupported YAML tag {tag}")
            elif s.startswith("&"):
                anchor, _, s = s[1:].partition(" ")
            else:
                return anchor, s

    def _flow(self, s: str, pos: int) -> Tuple[Any, int]:
        """One flow node starting at s[pos]; returns (value, end)."""
        while s[pos] == " ":
            pos += 1
        c = s[pos]
        if c in "[{":
            close = "]" if c == "[" else "}"
            items, pairs, pos = [], {}, pos + 1
            while True:
                while s[pos] in " ,":
                    pos += 1
                if s[pos] == close:
                    return (items if c == "[" else pairs), pos + 1
                if c == "[":
                    v, pos = self._flow(s, pos)
                    items.append(v)
                else:
                    k, pos = self._flow(s, pos)
                    while s[pos] == " ":
                        pos += 1
                    if s[pos] != ":":
                        raise ValueError(f"expected ':' in flow mapping {s!r}")
                    v, pos = self._flow(s, pos + 1)
                    pairs[k] = v
        if c in "'\"":
            return self._quoted(s, pos)
        if c == "*":
            m = re.match(r"\*([^\s,\]}]+)", s[pos:])
            return self._alias(m.group(1)), pos + m.end()
        m = re.match(r"[^,\]}:]*(:[^\s,\]}][^,\]}:]*)*", s[pos:])
        return _plain(m.group(0).strip()), pos + m.end()

    def _alias(self, name: str) -> Any:
        if name not in self.anchors:
            raise ValueError(f"unknown YAML alias *{name}")
        return self.anchors[name]

    def _inline(self, s: str) -> Any:
        """The value written after ``key:`` or ``- `` on one line."""
        if s.startswith("*"):
            return self._alias(s[1:].strip())
        if s[:1] in "[{'\"":
            v, end = self._flow(s, 0)
            if s[end:].strip():
                raise ValueError(f"trailing text after a value: {s!r}")
            return v
        if s[:1] in "|>":
            raise ValueError("block scalars are not supported")
        return _plain(s)

    # -------------------------------------------------------------- blocks
    def _value_after(self, rest: str, indent: int) -> Any:
        """The value of a key (or item) whose line ends with ``rest``: inline,
        or the block on the following, deeper lines."""
        anchor, rest = self._node_props(rest)
        if rest:
            v = self._inline(rest)
        elif self.i < len(self.lines) and (
                self.lines[self.i][0] > indent
                or (self.lines[self.i][0] == indent and self.lines[self.i][1].startswith("- "))):
            v = self._block(self.lines[self.i][0])
        else:
            v = None
        if anchor:
            self.anchors[anchor] = v
        return v

    def _split_key(self, text: str) -> Tuple[Any, str]:
        if text[:1] in "'\"":
            k, end = self._quoted(text, 0)
            rest = text[end:].lstrip()
            if not rest.startswith(":"):
                raise ValueError(f"expected ':' after a key: {text!r}")
            return k, rest[1:].strip()
        m = re.match(r"(.*?):(\s|$)", text)
        if m is None:
            raise ValueError(f"expected 'key: value': {text!r}")
        return _plain(m.group(1).strip()), text[m.end():].strip()

    def _block(self, indent: int) -> Any:
        if self.lines[self.i][1].startswith("- ") or self.lines[self.i][1] == "-":
            return self._sequence(indent)
        return self._mapping(indent)

    def _sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind != indent or not (text.startswith("- ") or text == "-"):
                break
            rest = text[1:].strip()
            self.i += 1
            anchor, rest = self._node_props(rest)
            if rest and not rest.startswith(("*", "[", "{", "'", '"')) and re.match(
                    r"[^:]*:(\s|$)", rest):
                # an item that opens a mapping: its first key on the dash's line
                self.lines.insert(self.i, (indent + 2, rest))
                v = self._mapping(indent + 2)
            else:
                v = self._value_after(rest, indent)
            if anchor:
                self.anchors[anchor] = v
            out.append(v)
        return out

    def _mapping(self, indent: int) -> dict:
        out: Dict[Any, Any] = {}
        merged: Dict[Any, Any] = {}
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"unexpected indentation: {text!r}")
            if text.startswith("- "):
                break
            self.i += 1
            _, text = self._node_props(text)
            key, rest = self._split_key(text)
            value = self._value_after(rest, indent)
            if key == "<<":
                for src in value if isinstance(value, list) else [value]:
                    if not isinstance(src, dict):
                        raise ValueError("a merge key needs a mapping")
                    for k, v in src.items():
                        merged.setdefault(k, v)
            else:
                out[key] = value
        return {**merged, **out}

    def document(self) -> Any:
        if not self.lines:
            return None
        if self.lines[0][0] != 0:
            raise ValueError("a document must start at column 0")
        if len(self.lines) == 1 and ":" not in self.lines[0][1]:
            return self._inline(self.lines[0][1])
        v = self._block(0)
        if self.i != len(self.lines):
            raise ValueError(f"could not read line: {self.lines[self.i][1]!r}")
        return v


def safe_load(text: str) -> Any:
    """The document in ``text``, as ``yaml.safe_load`` gives it."""
    return _Reader(text).document()

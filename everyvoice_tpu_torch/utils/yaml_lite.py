"""A YAML reader and writer for configuration files, without PyYAML.

``load(text)`` reads one block-style YAML document as ``yaml.safe_load``
does: mappings, sequences (also at their parent key's indentation),
flow collections (``[1, 3, 5]``, ``{a: 1}``, ``{}``) across lines,
single- and double-quoted scalars with their escapes and line folding,
plain scalars across lines, comments, ``---`` and ``...``. Plain scalars
resolve with PyYAML's YAML 1.1 implicit resolvers (``yaml/resolver.py``),
copied below as data: ``yes``/``no``/``on``/``off`` are booleans, ``1e-5``
is a string but ``1.0e-5`` a float, ``017``, ``0x1f``, ``1_000`` and
``1:30`` are ints, ``2024-01-02`` a ``datetime.date``. An empty document
loads as ``None``.

``dump(data)`` writes a tree of dicts, lists, strings, numbers, booleans,
``None`` and dates in block style, as ``yaml.safe_dump(data,
allow_unicode=True, sort_keys=False)`` lays it out, quoting every string
that would read back as something else.

What neither reads nor writes raises ``ValueError`` with the line:
anchors and aliases, tags, block scalars (``|``, ``>``), directives,
merge keys and a second document.
"""

from __future__ import annotations

import bisect
import datetime
import math
import re

__all__ = ["load", "dump"]

# PyYAML's implicit resolvers (yaml/resolver.py), in its order of
# registration; each applies to plain scalars whose first character is in
# the third field.
_RESOLVERS = (
    ("bool", re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$""", re.X), "yYnNtTfFoO"),
    ("float", re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X), "-+0123456789."),
    ("int", re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X), "-+0123456789"),
    ("merge", re.compile(r"^(?:<<)$"), "<"),
    ("null", re.compile(r"""^(?: ~
                    |null|Null|NULL
                    | )$""", re.X), "~nN"),
    ("timestamp", re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X), "0123456789"),
    ("value", re.compile(r"^(?:=)$"), "="),
)
_TIMESTAMP = re.compile(r"""^(?P<year>[0-9][0-9][0-9][0-9])
                -(?P<month>[0-9][0-9]?)
                -(?P<day>[0-9][0-9]?)
                (?:(?:[Tt]|[ \t]+)
                (?P<hour>[0-9][0-9]?)
                :(?P<minute>[0-9][0-9])
                :(?P<second>[0-9][0-9])
                (?:\.(?P<fraction>[0-9]*))?
                (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
                (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)
_BOOLS = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}

_BREAKS = "\r\n\x85\u2028\u2029"
_WS_BREAKS = "\0 \t" + _BREAKS
_LINE_BREAK = re.compile("\r\n|[\r\n\x85\u2028\u2029]")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_ESCAPE_CODES = {"x": 2, "u": 4, "U": 8}
_KEY_COLON = re.compile(r":(?=[ \t]|$)")
_COMMENT = re.compile(r"[ \t]#")
_UNSUPPORTED = {"&": "anchors", "*": "aliases", "!": "tags", "|": "block scalars ('|')",
                ">": "block scalars ('>')", "%": "directives", "@": "'@'", "`": "'`'"}


def _sexagesimal(text: str, cast):
    value = cast(0)
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def _construct(kind: str, text: str):
    if kind == "bool":
        return _BOOLS[text.lower()]
    if kind == "null":
        return None
    if kind == "int":
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-") if value[0] in "+-" else value
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        if ":" in value:
            return sign * _sexagesimal(value, int)
        return sign * int(value)
    if kind == "float":
        value = text.replace("_", "").lower()
        sign = -1 if value[0] == "-" else 1
        value = value[1:] if value[0] in "+-" else value
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        if ":" in value:
            return sign * _sexagesimal(value, float)
        return sign * float(value)
    if kind == "timestamp":
        v = _TIMESTAMP.match(text).groupdict()
        if not v["hour"]:
            return datetime.date(int(v["year"]), int(v["month"]), int(v["day"]))
        fraction = int((v["fraction"] or "")[:6].ljust(6, "0"))
        tzinfo = None
        if v["tz_sign"]:
            delta = datetime.timedelta(hours=int(v["tz_hour"]), minutes=int(v["tz_minute"] or 0))
            tzinfo = datetime.timezone(-delta if v["tz_sign"] == "-" else delta)
        elif v["tz"]:
            tzinfo = datetime.timezone.utc
        return datetime.datetime(int(v["year"]), int(v["month"]), int(v["day"]), int(v["hour"]),
                                 int(v["minute"]), int(v["second"]), fraction, tzinfo=tzinfo)
    raise ValueError(f"'{text}' resolves to the YAML '{kind}' type, which is not supported")


def _implicit_kind(text: str):
    """The YAML 1.1 type a plain scalar resolves to, None for a string."""
    if text == "":
        return "null"
    for kind, pattern, first in _RESOLVERS:
        if text[0] in first and pattern.match(text):
            return kind
    return None


class _Reader:
    """One document, read from its text with an offset; block structure by
    lines, scalars and flow collections character by character, as
    PyYAML's scanner reads them."""

    def __init__(self, text: str):
        self.text = text
        self.lines = _LINE_BREAK.split(text)
        self.starts = [0]
        for m in _LINE_BREAK.finditer(text):
            self.starts.append(m.end())
        self.i = 0

    # -- positions ------------------------------------------------------
    def fail(self, message: str, line: int):
        raise ValueError(f"YAML line {line + 1}: {message}")

    def peek(self, pos: int) -> str:
        return self.text[pos] if pos < len(self.text) else "\0"

    def line_of(self, pos: int) -> int:
        return bisect.bisect_right(self.starts, pos) - 1

    def offset(self, line: int, col: int) -> int:
        return self.starts[line] + col

    def is_marker(self, line: int) -> bool:
        s = self.lines[line]
        return s[:3] in ("---", "...") and (len(s) == 3 or s[3] in " \t")

    def at_marker(self, pos: int) -> bool:
        """A document marker starts at ``pos`` (the start of a line)."""
        return (self.text[pos:pos + 3] in ("---", "...")
                and self.peek(pos + 3) in _WS_BREAKS)

    @staticmethod
    def blank(s: str) -> bool:
        s = s.strip(" \t")
        return not s or s[0] == "#"

    @staticmethod
    def indent_of(s: str) -> int:
        return len(s) - len(s.lstrip(" "))

    def next_content(self):
        """The next line with content at or after ``self.i``, None at the
        end of the document."""
        while self.i < len(self.lines):
            if self.is_marker(self.i):
                return None
            s = self.lines[self.i]
            if not self.blank(s):
                n = self.indent_of(s)
                if s[n] == "\t":
                    self.fail("a tab in the indentation", self.i)
                return self.i
            self.i += 1
        return None

    def rest_is_blank(self, pos: int) -> int:
        """Check that only a comment follows ``pos`` on its line; returns
        the next line's index."""
        line = self.line_of(pos)
        rest = self.lines[line][pos - self.starts[line]:]
        if not self.blank(rest):
            self.fail(f"unexpected content '{rest.strip()}'", line)
        return line + 1

    def resolve(self, text: str, line: int):
        kind = _implicit_kind(text)
        if kind == "merge":
            self.fail("merge keys ('<<') are not supported", line)
        try:
            return text if kind is None else _construct(kind, text)
        except ValueError as e:
            self.fail(str(e), line)

    # -- document -------------------------------------------------------
    def document(self):
        i = self.next_content()
        first = None
        if i is None and self.i < len(self.lines) and self.lines[self.i].startswith("---"):
            marker = self.i
            rest = self.lines[marker][3:]
            self.i += 1
            if not self.blank(rest):
                col = 3 + self.indent_of(rest)
                first = (marker, col)
        elif i is not None and self.lines[i].startswith("%"):
            self.fail("directives are not supported", i)
        if first is not None:
            value = self.node_at(first[0], first[1], -1)
        else:
            value = self.node(-1)
        i = self.next_content()
        if i is not None:
            self.fail(f"unexpected content '{self.lines[i].strip()}'", i)
        if self.i < len(self.lines) and self.lines[self.i].startswith("..."):
            if not self.blank(self.lines[self.i][3:]):
                self.fail("content after '...'", self.i)
            self.i += 1
            while self.i < len(self.lines) and self.blank(self.lines[self.i]):
                self.i += 1
        if self.i < len(self.lines):
            self.fail("a second document is not supported", self.i)
        return value

    # -- block structure ------------------------------------------------
    def node(self, parent_indent: int, sequence_at_parent: bool = False):
        """The block node on the next content lines, indented deeper than
        ``parent_indent`` (a sequence may sit at it when
        ``sequence_at_parent``); None when there is none."""
        i = self.next_content()
        if i is None:
            return None
        n = self.indent_of(self.lines[i])
        if n < parent_indent or (n == parent_indent and not (
                sequence_at_parent and self.is_entry(self.lines[i][n:]))):
            return None
        return self.node_at(i, n, parent_indent)

    @staticmethod
    def is_entry(s: str) -> bool:
        return s[:1] == "-" and (len(s) == 1 or s[1] in " \t")

    @staticmethod
    def is_indicator(s: str, ch: str) -> bool:
        return s[:1] == ch and (len(s) == 1 or s[1] in " \t")

    def node_at(self, i: int, col: int, parent_indent: int):
        s = self.lines[i][col:]
        if self.is_entry(s):
            return self.sequence(i, col)
        if self.is_indicator(s, "?") or self.key_end(i, col) is not None:
            return self.mapping(i, col)
        return self.value_at(i, col, parent_indent)

    def after_indicator(self, i: int, col: int):
        """The node after a '-', '?' or ':' indicator at (i, col): on the
        same line (a compact collection or a scalar) or on the lines below,
        indented deeper than ``col``."""
        after = self.lines[i][col + 1:]
        self.i = i + 1
        if self.blank(after):
            return self.node(col)
        if after.lstrip(" ")[:1] == "\t":
            self.fail("a tab after an indicator", i)
        return self.node_at(i, col + 1 + self.indent_of(after), col)

    def sequence(self, i: int, indent: int) -> list:
        items = []
        while True:
            items.append(self.after_indicator(i, indent))
            i = self.next_content()
            if i is None:
                return items
            n = self.indent_of(self.lines[i])
            if n > indent:
                self.fail("unexpected indentation in a sequence", i)
            if n < indent or not self.is_entry(self.lines[i][n:]):
                return items

    def key_end(self, i: int, col: int):
        """(key, offset after its ':') when the line holds a simple key at
        ``col``, else None."""
        s = self.lines[i]
        ch = s[col:col + 1]
        if ch in ("[", "{", ""):
            return None
        if ch in ("'", '"'):
            value, end = self.quoted(self.offset(i, col))
            if self.line_of(end) != i:
                return None
            pos = end
            while self.peek(pos) in " \t":
                pos += 1
            if self.peek(pos) == ":" and self.peek(pos + 1) in _WS_BREAKS:
                return value, pos + 1
            return None
        m = _KEY_COLON.search(s, col)
        comment = _COMMENT.search(s, col)
        if m is None or (comment is not None and comment.start() < m.start()):
            return None
        text = s[col:m.start()].rstrip(" \t")
        if not text:
            self.fail("a mapping key is empty", i)
        if text[0] in _UNSUPPORTED:
            self.fail(f"{_UNSUPPORTED[text[0]]} are not supported", i)
        return self.resolve(text, i), self.offset(i, m.end())

    def mapping(self, i: int, indent: int) -> dict:
        out: dict = {}
        while True:
            if self.is_indicator(self.lines[i][indent:], "?"):
                key = self.after_indicator(i, indent)
                j = self.next_content()
                value = None
                if (j is not None and self.indent_of(self.lines[j]) == indent
                        and self.is_indicator(self.lines[j][indent:], ":")):
                    value = self.after_indicator(j, indent)
                out[self.hashable(key, self.starts[i])] = value
                i = self.next_content()
                if i is None:
                    return out
                n = self.indent_of(self.lines[i])
                if n < indent:
                    return out
                if n > indent:
                    self.fail("unexpected indentation in a mapping", i)
                continue
            found = self.key_end(i, indent)
            if found is None:
                self.fail("expected a 'key: value' line", i)
            key, pos = found
            col = pos - self.starts[i]
            rest = self.lines[i][col:]
            self.i = i + 1
            if self.blank(rest):
                out[key] = self.node(indent, sequence_at_parent=True)
            else:
                out[key] = self.value_at(i, col + self.indent_of(rest), indent)
            i = self.next_content()
            if i is None:
                return out
            n = self.indent_of(self.lines[i])
            if n > indent:
                self.fail("unexpected indentation in a mapping", i)
            if n < indent:
                return out
            if self.is_entry(self.lines[i][n:]):
                self.fail("a sequence entry where a mapping key was expected", i)

    def value_at(self, i: int, col: int, block_indent: int):
        """The scalar or flow collection starting at (i, col); sets
        ``self.i`` to the line after it."""
        s = self.lines[i][col:]
        ch = s[0]
        pos = self.offset(i, col)
        if ch in "[{":
            value, end = self.flow(pos)
        elif ch in "'\"":
            value, end = self.quoted(pos)
        elif ch in _UNSUPPORTED:
            self.fail(f"{_UNSUPPORTED[ch]} are not supported", i)
        elif ch in "-?:" and (len(s) == 1 or s[1] in " \t"):
            self.fail(f"'{ch}' is not allowed here", i)
        elif ch in ",]}":
            self.fail(f"'{ch}' cannot start a value", i)
        else:
            text, end = self.plain(pos, block_indent, flow=False)
            value = self.resolve(text, i)
            line = self.line_of(end)
            rest = self.lines[line][end - self.starts[line]:]
            if rest.lstrip(" \t")[:1] == ":":
                self.fail("a mapping value is not allowed here", line)
        self.i = self.rest_is_blank(end)
        return value

    # -- scalars --------------------------------------------------------
    def line_break(self, pos: int) -> tuple:
        """(normalized break, offset after it) at ``pos``."""
        if self.text[pos:pos + 2] == "\r\n":
            return "\n", pos + 2
        ch = self.text[pos]
        return ("\n" if ch in "\r\n\x85" else ch), pos + 1

    def plain(self, pos: int, block_indent: int, flow: bool) -> tuple:
        """A plain scalar's text and the offset after it (PyYAML's
        ``scan_plain``)."""
        chunks: list = []
        end = pos
        stops = ",?[]{}" if flow else ""
        after_colon = _WS_BREAKS + (",[]{}" if flow else "")
        spaces: list = []
        while True:
            if self.peek(pos) == "#":
                break
            length = 0
            while True:
                ch = self.peek(pos + length)
                if (ch in _WS_BREAKS or (ch == ":" and self.peek(pos + length + 1) in after_colon)
                        or ch in stops):
                    break
                length += 1
            if length == 0:
                break
            chunks.extend(spaces)
            chunks.append(self.text[pos:pos + length])
            pos += length
            end = pos
            spaces, pos = self.plain_spaces(pos)
            if not spaces or self.peek(pos) == "#":
                break
            if not flow and pos - self.starts[self.line_of(pos)] < block_indent + 1:
                break
        return "".join(chunks), end

    def plain_spaces(self, pos: int) -> tuple:
        start = pos
        while self.peek(pos) == " ":
            pos += 1
        whitespace = self.text[start:pos]
        if self.peek(pos) not in _BREAKS:
            return ([whitespace] if whitespace else []), pos
        first, pos = self.line_break(pos)
        if self.at_marker(pos):
            return [], pos
        breaks = []
        while self.peek(pos) in " " + _BREAKS:
            if self.peek(pos) == " ":
                pos += 1
            else:
                brk, pos = self.line_break(pos)
                breaks.append(brk)
                if self.at_marker(pos):
                    return [], pos
        chunks = [first] if first != "\n" else ([] if breaks else [" "])
        return chunks + breaks, pos

    def quoted(self, pos: int) -> tuple:
        """A single- or double-quoted scalar's value and the offset after
        its closing quote (PyYAML's ``scan_flow_scalar``)."""
        quote = self.text[pos]
        double = quote == '"'
        line = self.line_of(pos)
        pos += 1
        chunks: list = []
        while True:
            start = pos
            while self.peek(pos) not in "'\"\\" + _WS_BREAKS:
                pos += 1
            chunks.append(self.text[start:pos])
            ch = self.peek(pos)
            if ch == "\0":
                self.fail("a quoted scalar is not closed", line)
            if ch == quote and not (not double and self.peek(pos + 1) == "'"):
                return "".join(chunks), pos + 1
            if not double and ch == "'":
                chunks.append("'")
                pos += 2
            elif ch in "'\"" or (ch == "\\" and not double):
                chunks.append(ch)
                pos += 1
            elif ch == "\\":
                code = self.peek(pos + 1)
                if code in _ESCAPES:
                    chunks.append(_ESCAPES[code])
                    pos += 2
                elif code in _ESCAPE_CODES:
                    digits = self.text[pos + 2:pos + 2 + _ESCAPE_CODES[code]]
                    if len(digits) != _ESCAPE_CODES[code] or not all(
                            c in "0123456789abcdefABCDEF" for c in digits):
                        self.fail(f"a bad escape '\\{code}{digits}'", self.line_of(pos))
                    chunks.append(chr(int(digits, 16)))
                    pos += 2 + len(digits)
                elif code in _BREAKS:
                    _, pos = self.line_break(pos + 1)
                    breaks, pos = self.quoted_breaks(pos)
                    chunks.extend(breaks)
                else:
                    self.fail(f"an unknown escape '\\{code}'", self.line_of(pos))
            else:  # whitespace, maybe a line break
                start = pos
                while self.peek(pos) in " \t":
                    pos += 1
                if self.peek(pos) in _BREAKS:
                    first, pos = self.line_break(pos)
                    breaks, pos = self.quoted_breaks(pos)
                    if first != "\n":
                        chunks.append(first)
                    elif not breaks:
                        chunks.append(" ")
                    chunks.extend(breaks)
                elif self.peek(pos) == "\0":
                    self.fail("a quoted scalar is not closed", line)
                else:
                    chunks.append(self.text[start:pos])

    def quoted_breaks(self, pos: int) -> tuple:
        breaks = []
        while True:
            if self.at_marker(pos):
                self.fail("a document marker inside a quoted scalar", self.line_of(pos))
            while self.peek(pos) in " \t":
                pos += 1
            if self.peek(pos) in _BREAKS:
                brk, pos = self.line_break(pos)
                breaks.append(brk)
            else:
                return breaks, pos

    # -- flow collections -----------------------------------------------
    def skip_flow_space(self, pos: int) -> int:
        while True:
            ch = self.peek(pos)
            if ch in " \t" + _BREAKS:
                pos += 1
            elif ch == "#" and (pos == 0 or self.text[pos - 1] in " \t" + _BREAKS):
                while self.peek(pos) not in "\0" + _BREAKS:
                    pos += 1
            else:
                return pos

    def flow(self, pos: int) -> tuple:
        """A flow node at ``pos``: its value and the offset after it."""
        pos = self.skip_flow_space(pos)
        ch = self.peek(pos)
        line = self.line_of(pos)
        if ch == "[":
            items: list = []
            pos += 1
            while True:
                pos = self.skip_flow_space(pos)
                if self.peek(pos) == "]":
                    return items, pos + 1
                item, pos = self.flow(pos)
                pos = self.skip_flow_space(pos)
                if self.peek(pos) == ":":  # a single-pair mapping
                    value, pos = self.flow_value(pos + 1)
                    item = {self.hashable(item, pos): value}
                    pos = self.skip_flow_space(pos)
                items.append(item)
                pos = self.flow_separator(pos, "]")
                if self.peek(pos - 1) == "]":
                    return items, pos
        if ch == "{":
            out: dict = {}
            pos += 1
            while True:
                pos = self.skip_flow_space(pos)
                if self.peek(pos) == "}":
                    return out, pos + 1
                key, pos = self.flow(pos)
                pos = self.skip_flow_space(pos)
                value = None
                if self.peek(pos) == ":":
                    value, pos = self.flow_value(pos + 1)
                    pos = self.skip_flow_space(pos)
                out[self.hashable(key, pos)] = value
                pos = self.flow_separator(pos, "}")
                if self.peek(pos - 1) == "}":
                    return out, pos
        if ch in "'\"":
            return self.quoted(pos)
        if ch in _UNSUPPORTED:
            self.fail(f"{_UNSUPPORTED[ch]} are not supported", line)
        if ch in ",]}:?\0" or ch == "-" and self.peek(pos + 1) in _WS_BREAKS:
            self.fail(f"'{ch}' where a flow value was expected", line)
        text, end = self.plain(pos, -1, flow=True)
        if not text:
            self.fail("an empty flow value", line)
        return self.resolve(text, line), end

    def flow_value(self, pos: int) -> tuple:
        """The value after a flow mapping's ':' (None when it is empty)."""
        pos = self.skip_flow_space(pos)
        if self.peek(pos) in ",]}":
            return None, pos
        return self.flow(pos)

    def flow_separator(self, pos: int, close: str) -> int:
        ch = self.peek(pos)
        if ch == ",":
            return pos + 1
        if ch == close:
            return pos + 1
        self.fail(f"expected ',' or '{close}' in a flow collection", self.line_of(pos))

    def hashable(self, key, pos: int):
        try:
            hash(key)
        except TypeError:
            self.fail("a flow mapping key must be a scalar", self.line_of(pos))
        return key


def load(text: str | bytes):
    """The value of the one YAML document in ``text`` (None when it is
    empty), as ``yaml.safe_load`` reads it."""
    if isinstance(text, bytes):
        text = text.decode("utf8")
    if text.startswith("\ufeff"):
        text = text[1:]
    return _Reader(text).document()


# ---------------------------------------------------------------------------
# writing

_PRINTABLE = re.compile("[\x09\x0a\x0d\x20-\x7e\x85\xa0-\ud7ff\ue000-\ufffd\U00010000-\U0010ffff]")
_DOUBLE_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\t": "t", "\n": "n", "\x0b": "v",
                   "\x0c": "f", "\r": "r", "\x1b": "e", '"': '"', "\\": "\\", "\x85": "N",
                   "\xa0": "_", "\u2028": "L", "\u2029": "P"}


def _double_quoted(text: str) -> str:
    out = []
    for ch in text:
        if ch in _DOUBLE_ESCAPES:
            out.append("\\" + _DOUBLE_ESCAPES[ch])
        elif ch == "\ufeff" or not _PRINTABLE.match(ch):
            code = ord(ch)
            out.append(f"\\x{code:02X}" if code <= 0xFF else
                       f"\\u{code:04X}" if code <= 0xFFFF else f"\\U{code:08X}")
        else:
            out.append(ch)
    return '"' + "".join(out) + '"'


def _plain_ok(text: str) -> bool:
    """Whether ``text`` reads back as itself written plain, in block
    context, as a key or a value."""
    if not text or text != text.strip(" ") or text[0] in "-?:,[]{}#&*!|>'\"%@`":
        return False
    if text.startswith("..."):
        return False
    if ": " in text or " #" in text or text.endswith(":"):
        return False
    if any(ch in "\t\ufeff\xa0" or ch in _BREAKS or not _PRINTABLE.match(ch) for ch in text):
        return False
    return _implicit_kind(text) is None


def _float(value: float) -> str:
    if math.isnan(value):
        return ".nan"
    if math.isinf(value):
        return ".inf" if value > 0 else "-.inf"
    text = repr(value).lower()
    if "." not in text and "e" in text:
        text = text.replace("e", ".0e", 1)
    return text


def _scalar(value) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        return _float(value)
    if isinstance(value, datetime.datetime):
        return value.isoformat(" ")
    if isinstance(value, datetime.date):
        return value.isoformat()
    if isinstance(value, str):
        return value if _plain_ok(value) else _double_quoted(value)
    raise TypeError(f"cannot write a {type(value).__name__} as YAML: {value!r}")


def _block(node) -> bool:
    return isinstance(node, (dict, list, tuple)) and len(node) > 0


def _inline(node) -> str:
    if isinstance(node, dict):
        return "{}"
    if isinstance(node, (list, tuple)):
        return "[]"
    return _scalar(node)


def _lines(node, indent: int) -> list:
    pad = " " * indent
    out = []
    if isinstance(node, dict):
        for key, value in node.items():
            if isinstance(key, (dict, list, tuple)):
                raise TypeError(f"cannot write a {type(key).__name__} key as YAML")
            key = _scalar(key)
            if _block(value):
                out.append(f"{pad}{key}:")
                out += _lines(value, indent + 2 if isinstance(value, dict) else indent)
            else:
                out.append(f"{pad}{key}: {_inline(value)}")
        return out
    for value in node:
        if _block(value):
            child = _lines(value, indent + 2)
            child[0] = f"{pad}- {child[0][indent + 2:]}"
            out += child
        else:
            out.append(f"{pad}- {_inline(value)}")
    return out


def dump(data) -> str:
    """``data`` as a block-style YAML document that ``yaml.safe_load`` (and
    ``load``) read back as ``data``; mappings keep their key order."""
    if _block(data):
        return "\n".join(_lines(data, 0)) + "\n"
    return _inline(data) + "\n"

"""A reader for the subset of YAML that the experiment configs use.

``safe_load(text)`` returns what ``yaml.safe_load`` returns for:

- block mappings and block sequences, a sequence's items at the same
  indent as its key or deeper, compact items (``-   key: value``);
- flow lists and flow maps (``[a, b]``, ``{dtype: float, name: label}``),
  nested, and spanning lines after a separator;
- single- and double-quoted strings on one line;
- ``#`` comments, and empty values (``None``).

Plain scalars resolve as PyYAML's YAML 1.1 resolver resolves them:
``0.`` is a float, ``1e-3`` (no dot) a string, ``1.0e-3`` a float,
``yes/no/on/off/true/false`` bools, ``null``/``~``/empty ``None``, and
``0x``/``0b``/leading-zero octal and ``a:b`` sexagesimal ints.

Anything else (anchors, aliases, tags, block scalars ``|``/``>``,
directives, multi-document streams, multi-line plain or quoted scalars,
complex keys, timestamps, merge keys) raises ``ValueError`` naming the
line: nothing outside the subset is guessed.

``dump(obj)`` writes dicts, lists and scalars as text that both this
reader and ``yaml.safe_load`` read back to an equal object: block
mappings with sorted keys and an indent of 4, lists of scalars as flow
lists, other lists as block sequences, floats as PyYAML writes them
(``1.0e-05``), and strings quoted wherever a plain scalar would read
as something else.
"""

import math
import re

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
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

# a plain scalar may not start with these (PyYAML's check_plain); the
# ones that start a construct outside the subset are named
_UNSUPPORTED_START = {"&": "anchor", "*": "alias", "!": "tag", "|": "block scalar",
                      ">": "block scalar", "%": "directive", "@": "reserved indicator",
                      "`": "reserved indicator"}
_DQ_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
               "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
               "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": "\u2028",
               "P": "\u2029"}
_DQ_HEX = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(value, cast):
    total = 0
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def _int(value):
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    if value[0] == "0":
        return sign * int(value, 8)
    return sign * int(value)


def _float(value):
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


class _Reader:
    def __init__(self, text):
        self.lines = [line.rstrip("\r") for line in text.split("\n")]
        self.i = 0

    def fail(self, msg, lineno=None):
        lineno = self.i if lineno is None else lineno
        raise ValueError("YAML line {}: {}".format(lineno + 1, msg))

    # ---- lines ---------------------------------------------------------
    def _meaningful(self, idx):
        """(indent, content) of line idx, or None for a blank or
        comment-only line."""
        line = self.lines[idx]
        stripped = line.lstrip(" ")
        if not stripped.strip() or stripped.startswith("#"):
            return None
        if stripped[0] == "\t":
            self.fail("tab in indentation", idx)
        if line.startswith(("---", "...")) and line[3:4] in ("", " ", "\t"):
            self.fail("document markers are not supported", idx)
        if stripped.startswith("%") and len(line) == len(stripped):
            self.fail("directives are not supported", idx)
        return len(line) - len(stripped), stripped

    def peek(self):
        """(indent, content) of the next meaningful line, skipping blank
        and comment lines; None at the end."""
        while self.i < len(self.lines):
            got = self._meaningful(self.i)
            if got is not None:
                return got
            self.i += 1
        return None

    # ---- scalars -------------------------------------------------------
    @staticmethod
    def _comment_at(text, start=0):
        """Index of a ``#`` comment (at start or after whitespace) in
        ``text`` from ``start``, else len(text)."""
        for j in range(start, len(text)):
            if text[j] == "#" and (j == 0 or text[j - 1] in " \t"):
                return j
        return len(text)

    def resolve_plain(self, value):
        if _NULL.match(value):
            return None
        if _BOOL.match(value):
            return value in _TRUE
        if value[:1] in "-+0123456789.":
            if _INT.match(value):
                return _int(value)
            if _FLOAT.match(value):
                return _float(value)
            if _TIMESTAMP.match(value):
                self.fail("timestamps are not supported: {!r}".format(value))
        if value in ("<<", "="):
            self.fail("merge and value keys are not supported")
        return value

    def check_plain_start(self, text):
        c = text[:1]
        if c in _UNSUPPORTED_START:
            self.fail("{} ({!r}) is not supported".format(_UNSUPPORTED_START[c], c))
        if c in ",]}#" or (c in "?:-" and text[1:2] in ("", " ")):
            self.fail("unexpected {!r}".format(c))

    def quoted(self, text, pos):
        """Parse the quoted scalar starting at text[pos]; returns (str,
        position after the closing quote)."""
        q = text[pos]
        out, j = [], pos + 1
        while j < len(text):
            c = text[j]
            if q == "'" and c == "'":
                if text[j + 1:j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            if q == '"' and c == '"':
                return "".join(out), j + 1
            if q == '"' and c == "\\":
                e = text[j + 1:j + 2]
                if e in _DQ_ESCAPES:
                    out.append(_DQ_ESCAPES[e])
                    j += 2
                    continue
                if e in _DQ_HEX:
                    digits = text[j + 2:j + 2 + _DQ_HEX[e]]
                    if len(digits) != _DQ_HEX[e] or \
                            not all(ch in "0123456789abcdefABCDEF" for ch in digits):
                        self.fail("bad escape in a double-quoted string")
                    out.append(chr(int(digits, 16)))
                    j += 2 + _DQ_HEX[e]
                    continue
                self.fail("unknown escape \\{} (or a line break inside a "
                          "double-quoted string)".format(e))
            if c == "\n":
                self.fail("quoted scalars spanning lines are not supported")
            out.append(c)
            j += 1
        self.fail("unterminated quoted scalar")

    # ---- flow collections ------------------------------------------------
    def flow(self, text, pos):
        """Parse the flow collection at text[pos] (text holds the rest of
        the current line and the lines after it, joined by newlines);
        returns (node, position after it)."""
        base = self.i

        def line_of(p):
            return base + text.count("\n", 0, p)

        def skip(p):
            while p < len(text):
                c = text[p]
                if c in " \t\n":
                    p += 1
                elif c == "#" and (p == 0 or text[p - 1] in " \t\n"):
                    while p < len(text) and text[p] != "\n":
                        p += 1
                else:
                    break
            return p

        def plain(p):
            start = p
            while p < len(text):
                c = text[p]
                if c in ",[]{}\n":
                    break
                if c == ":" and text[p + 1:p + 2] in ("", " ", "\t", "\n", ",", "[",
                                                      "]", "{", "}"):
                    break
                if c == "#" and text[p - 1] in " \t":
                    break
                p += 1
            value = text[start:p].rstrip(" \t")
            if text[p:p + 1] == "\n":
                after = skip(p)
                if after < len(text) and text[after] not in ",]}:":
                    self.i = line_of(p)
                    self.fail("plain scalars spanning lines are not supported")
            return value, p

        def node(p):
            p = skip(p)
            self.i = line_of(p)
            if p >= len(text):
                self.fail("unterminated flow collection", base)
            c = text[p]
            if c in "[{":
                close = "]" if c == "[" else "}"
                items = [] if c == "[" else {}
                p = skip(p + 1)
                while True:
                    if p >= len(text):
                        self.fail("unterminated flow collection", base)
                    if text[p] == close:
                        return items, p + 1
                    if c == "[":
                        value, p = node(p)
                        p = skip(p)
                        if text[p:p + 1] == ":":
                            self.i = line_of(p)
                            self.fail("single-pair mappings in flow lists are not "
                                      "supported")
                        items.append(value)
                    else:
                        key, p = node(p)
                        if isinstance(key, (list, dict)):
                            self.fail("collections as keys are not supported")
                        p = skip(p)
                        value = None
                        if text[p:p + 1] == ":":
                            p = skip(p + 1)
                            if text[p:p + 1] not in (",", "}"):
                                value, p = node(p)
                                p = skip(p)
                        items[key] = value
                    if text[p:p + 1] == ",":
                        p = skip(p + 1)
                    elif text[p:p + 1] != close:
                        self.i = line_of(p)
                        self.fail("expected ',' or {!r} in a flow collection".format(close))
            if c in "'\"":
                return self.quoted(text, p)
            self.check_plain_start(text[p:])
            value, p = plain(p)
            return self.resolve_plain(value), p

        return node(pos)

    # ---- values on one line ------------------------------------------------
    def inline(self, text):
        """The value written on the current line (``text``: the line from
        the value's first column): a quoted or plain scalar, or a flow
        collection that may continue on the lines below. Leaves ``self.i``
        on the next unread line."""
        if text[:1] in "[{":
            joined = "\n".join([text] + self.lines[self.i + 1:])
            start = self.i
            value, end = self.flow(joined, 0)
            last = start + joined.count("\n", 0, end)
            line_end = joined.find("\n", end)
            rest = joined[end:] if line_end < 0 else joined[end:line_end]
            self.i = last
            if rest.strip() and not rest.strip().startswith("#"):
                self.fail("unexpected text after a flow collection: {!r}".format(rest))
            self.i = last + 1
            return value
        if text[:1] in "'\"":
            value, end = self.quoted(text, 0)
            rest = text[end:].strip()
            if rest and not rest.startswith("#"):
                self.fail("unexpected text after a quoted scalar")
        else:
            self.check_plain_start(text)
            value = text[:self._comment_at(text)].rstrip(" \t")
            if ": " in value or value.endswith(":"):
                self.fail("mapping values are not allowed here")
            value = self.resolve_plain(value)
        self.i += 1
        return value

    # ---- block collections ---------------------------------------------------
    def key_split(self, content):
        """(key, rest after ': ') of a mapping line, or None when the line
        is not ``key: ...``."""
        if content[:1] in "'\"":
            key, end = self.quoted(content, 0)
            if content[end:end + 1] != ":" or content[end + 1:end + 2] not in ("", " "):
                return None
            return key, content[end + 1:].lstrip(" ")
        if content.startswith("? ") or content == "?":
            self.fail("complex keys are not supported")
        if content[:1] in "[{":
            return None
        stop = self._comment_at(content)
        for j in range(stop):
            if content[j] == ":" and (j + 1 == len(content) or content[j + 1] == " "):
                key = content[:j].rstrip(" ")
                self.check_plain_start(key or ":")
                return self.resolve_plain(key), content[j + 1:].lstrip(" ")
        return None

    def block(self, indent):
        """The node whose first line is the next meaningful line, at
        ``indent``."""
        got = self.peek()
        if got is None:
            return None
        ind, content = got
        if ind != indent:
            self.fail("bad indentation")
        if content == "-" or content.startswith("- "):
            return self.sequence(indent)
        if self.key_split(content) is not None:
            return self.mapping(indent)
        return self.inline(content)

    def value_below(self, indent, allow_sequence):
        """The value of a key or item whose line ends after its indicator:
        a deeper node, a sequence at the same indent (for a key), or
        None."""
        got = self.peek()
        if got is None:
            return None
        ind, content = got
        if ind > indent:
            return self.block(ind)
        if allow_sequence and ind == indent and (content == "-" or content.startswith("- ")):
            return self.sequence(indent)
        return None

    def mapping(self, indent):
        out = {}
        while True:
            got = self.peek()
            if got is None or got[0] < indent:
                return out
            ind, content = got
            if ind > indent:
                self.fail("bad indentation")
            if content == "-" or content.startswith("- "):
                return out
            split = self.key_split(content)
            if split is None:
                self.fail("expected 'key: value'")
            key, rest = split
            if not rest or rest.startswith("#"):
                self.i += 1
                out[key] = self.value_below(indent, allow_sequence=True)
            else:
                out[key] = self.inline(rest)
                self._no_deeper(indent)

    def sequence(self, indent):
        out = []
        while True:
            got = self.peek()
            if got is None or got[0] < indent:
                return out
            ind, content = got
            if ind > indent:
                self.fail("bad indentation")
            if not (content == "-" or content.startswith("- ")):
                return out
            rest = content[1:].lstrip(" ")
            col = indent + len(content) - len(rest)
            if not rest or rest.startswith("#"):
                self.i += 1
                out.append(self.value_below(indent, allow_sequence=False))
            elif rest == "-" or rest.startswith("- ") or self.key_split(rest) is not None:
                # a compact nested node: read this line again as if the item
                # started on its own line at the item's column
                self.lines[self.i] = " " * col + rest
                out.append(self.block(col))
            else:
                out.append(self.inline(rest))
                self._no_deeper(indent)

    def _no_deeper(self, indent):
        got = self.peek()
        if got is not None and got[0] > indent:
            self.fail("bad indentation (or a plain scalar spanning lines)")


def safe_load(stream):
    """Parse one YAML document of the supported subset (a string or a
    file object). An empty document is None."""
    text = stream.read() if hasattr(stream, "read") else stream
    if text.startswith("\ufeff"):
        text = text[1:]
    reader = _Reader(text)
    got = reader.peek()
    if got is None:
        return None
    node = reader.block(got[0])
    if reader.peek() is not None:
        reader.fail("unexpected content after the document")
    return node


_PLAIN_SAFE = re.compile(r"[A-Za-z0-9_./~+-][A-Za-z0-9_./~+ -]*")


def _reads_as_itself(value):
    """Whether ``value`` written plain reads back as the same string."""
    if not _PLAIN_SAFE.fullmatch(value) or value.endswith(" ") or \
            value.startswith("- ") or value == "-":
        return False
    try:
        return _Reader("").resolve_plain(value) == value
    except ValueError:      # a timestamp, or a merge or value key
        return False


def _scalar(value):
    """One scalar as YAML text that reads back to an equal value."""
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(int(value))
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(float(value)).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if not isinstance(value, str):
        raise TypeError("cannot write {!r} as YAML".format(value))
    if _reads_as_itself(value):
        return value
    if all(c.isprintable() for c in value):
        return "'{}'".format(value.replace("'", "''"))
    out = []
    for c in value:
        if c in ('"', "\\"):
            out.append("\\" + c)
        elif c in "\n\t":
            out.append("\\n" if c == "\n" else "\\t")
        elif c.isprintable():
            out.append(c)
        else:
            out.append("\\x{:02x}".format(ord(c)) if ord(c) < 256
                       else "\\u{:04x}".format(ord(c)) if ord(c) < 65536
                       else "\\U{:08x}".format(ord(c)))
    return '"{}"'.format("".join(out))


def _flow(value):
    """A list of scalars and flow-writable lists on one line, or None."""
    if isinstance(value, list):
        items = [_flow(v) for v in value]
        return None if None in items else "[" + ", ".join(items) + "]"
    if isinstance(value, dict):
        return "{}" if not value else None
    return _scalar(value)


def _dump_node(value, indent, lines):
    """Append the block lines of a dict or list at ``indent``."""
    pad = " " * indent
    if isinstance(value, dict):
        for key in sorted(value, key=lambda k: (str(type(k)), k)):
            head = pad + _scalar(key) + ":"
            child = value[key]
            flow = _flow(child)
            if flow is not None:
                lines.append(head + " " + flow)
            else:
                lines.append(head)
                # a sequence stays at its key's indent, as PyYAML writes it
                _dump_node(child, indent if isinstance(child, list) else indent + 4,
                           lines)
        return
    for item in value:
        flow = _flow(item)
        if flow is not None:
            lines.append(pad + "- " + flow)
            continue
        start = len(lines)
        _dump_node(item, indent + 4, lines)
        lines[start] = pad + "-   " + lines[start][indent + 4:]


def dump(obj):
    """``obj`` (dicts, lists, str, int, float, bool, None) as YAML text."""
    flow = _flow(obj)
    if flow is not None:
        return flow + "\n"
    lines = []
    _dump_node(obj, 0, lines)
    return "\n".join(lines) + "\n"

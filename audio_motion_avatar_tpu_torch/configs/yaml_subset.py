"""A reader for the subset of YAML the configs use, resolving scalars as
PyYAML's `safe_load` does (YAML 1.1).

The port reads its configs without PyYAML, which the machines that run it
need not have. Supported: block mappings and block sequences (also a
sequence at its key's indentation, and `- key: value` items), flow
sequences and mappings (`[a, b]`, `{a: 1}`), comments, single- and
double-quoted scalars, plain scalars. Plain scalars resolve as YAML 1.1
does: null (`~`, `null`, empty), booleans (`true`, `yes`, `on`, ... in
their three spellings), ints (decimal, `0x`, `0b`, a leading 0 for
octal, `_` separators, base 60 `1:30`) and floats (a `.` is required, an
exponent needs its sign: `1e-4` stays the string '1e-4'; `.inf`, `.nan`).
Anything else (anchors, tags, block scalars, multi-line plain scalars,
timestamps, several documents) raises ValueError instead of being read
differently from PyYAML.

`dump` writes a tree of dicts, lists and scalars as PyYAML's
`safe_dump` does (block style, keys sorted, sequences in a mapping not
indented, a string plain only where it reads back as that string, else
quoted; floats as `repr` with `.0` before a bare exponent), so that
`yaml.safe_load` and `loads` read it back equal. Plain scalars are not
folded at 80 columns as PyYAML folds long ones: the text differs there,
the value does not.
"""

from __future__ import annotations

import re
from typing import Any, List, NamedTuple, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
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
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_UNSUPPORTED = (
    (re.compile(r"^[0-9]{4}-[0-9][0-9]?-[0-9][0-9]?"), "a timestamp"),
    (re.compile(r"^(?:<<|=)$"), "a merge or value key"),
)
_TRUE = ("yes", "true", "on")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0", "L": " ",
            "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


class _Line(NamedTuple):
    indent: int
    text: str
    number: int


def _error(msg: str, number: int) -> ValueError:
    return ValueError(f"yaml_subset: line {number}: {msg}")


def _sexagesimal(value: str, cast):
    total = cast(0)
    for part in value.split(":"):
        total = total * 60 + cast(part)
    return total


def resolve_plain(text: str) -> Any:
    """A plain scalar's value, as PyYAML's implicit resolvers give it."""
    for pattern, what in _UNSUPPORTED:
        if pattern.match(text):
            raise ValueError(f"yaml_subset: {text!r} reads as {what}, which is not supported")
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * (_sexagesimal(v, int) if ":" in v else int(v))
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * float("inf")
        if v == ".nan":
            return float("nan")
        return sign * (_sexagesimal(v, float) if ":" in v else float(v))
    return text


def _strip_comment(raw: str, number: int) -> str:
    """The line without its comment (a # at the start or after a blank,
    outside quotes), right-stripped."""
    quote = None
    i = 0
    while i < len(raw):
        c = raw[i]
        if quote == '"':
            if c == "\\":
                i += 1
            elif c == '"':
                quote = None
        elif quote == "'":
            if c == "'":
                if raw[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif c in "\"'" and (i == 0 or raw[i - 1] in " \t[{,:-"):
            quote = c
        elif c == "#" and (i == 0 or raw[i - 1] in " \t"):
            return raw[:i].rstrip()
        i += 1
    if quote is not None:
        raise _error("unterminated quoted scalar (multi-line scalars are not supported)",
                     number)
    return raw.rstrip()


def _lines(text: str) -> List[_Line]:
    out = []
    for number, raw in enumerate(text.splitlines(), 1):
        body = raw.lstrip(" ")
        if body.startswith("\t") or ("\t" in raw[:len(raw) - len(body)]):
            raise _error("tab in indentation", number)
        body = _strip_comment(body, number)
        if not body:
            continue
        if body.startswith("%") or body in ("---", "...") or body.startswith("--- "):
            if body == "---" and not out:
                continue    # an explicit start of the one document
            raise _error(f"{body!r}: directives and several documents are not supported",
                         number)
        out.append(_Line(len(raw) - len(raw.lstrip(" ")), body, number))
    return out


def _quoted(s: str, i: int, number: int) -> Tuple[str, int]:
    """The quoted scalar starting at s[i] -> (value, index after it)."""
    q = s[i]
    out = []
    i += 1
    while i < len(s):
        c = s[i]
        if q == "'" and c == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if q == '"' and c == '"':
            return "".join(out), i + 1
        if q == '"' and c == "\\":
            e = s[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            if e in _HEX:
                n = _HEX[e]
                digits = s[i + 2:i + 2 + n]
                if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                    raise _error(f"bad escape \\{e}{digits}", number)
                out.append(chr(int(digits, 16)))
                i += 2 + n
                continue
            raise _error(f"unknown escape \\{e}", number)
        out.append(c)
        i += 1
    raise _error("unterminated quoted scalar", number)


def _check_plain_start(text: str, number: int) -> None:
    if not text:
        return
    if text[0] in "&*!|>%@`":
        raise _error(f"{text!r}: anchors, aliases, tags and block scalars are not supported",
                     number)
    if text[0] in "?" and (len(text) == 1 or text[1] == " "):
        raise _error("complex keys are not supported", number)


class _Flow:
    """Recursive descent over one line's flow collection."""

    def __init__(self, s: str, number: int):
        self.s, self.i, self.number = s, 0, number

    def skip(self):
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def node(self):
        self.skip()
        c = self.s[self.i:self.i + 1]
        if c == "[":
            return self.seq()
        if c == "{":
            return self.map()
        if c in ("'", '"'):
            v, self.i = _quoted(self.s, self.i, self.number)
            return v
        return self.plain()

    def plain(self):
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            if c in ",[]{}":
                break
            if c == ":" and self.s[self.i + 1:self.i + 2] in ("", " ", ",", "]", "}"):
                break
            self.i += 1
        text = self.s[start:self.i].strip()
        if not text:
            raise _error(f"empty entry in flow collection {self.s!r}", self.number)
        _check_plain_start(text, self.number)
        return resolve_plain(text)

    def expect(self, c):
        self.skip()
        if self.s[self.i:self.i + 1] != c:
            raise _error(f"expected {c!r} at column {self.i} of {self.s!r}", self.number)
        self.i += 1

    def seq(self):
        self.expect("[")
        out = []
        while True:
            self.skip()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            item = self.node()
            self.skip()
            if self.s[self.i:self.i + 1] == ":":
                raise _error("single-pair mappings inside a flow sequence are not supported",
                             self.number)
            out.append(item)
            self.skip()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i:self.i + 1] != "]":
                raise _error(f"expected ',' or ']' in {self.s!r}", self.number)

    def map(self):
        self.expect("{")
        out = {}
        while True:
            self.skip()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            key = self.node()
            self.skip()
            if self.s[self.i:self.i + 1] == ":":
                self.i += 1
                self.skip()
                value = None if self.s[self.i:self.i + 1] in (",", "}") else self.node()
            else:
                value = None
            out[key] = value
            self.skip()
            if self.s[self.i:self.i + 1] == ",":
                self.i += 1
            elif self.s[self.i:self.i + 1] != "}":
                raise _error(f"expected ',' or '}}' in {self.s!r}", self.number)


def _inline(text: str, number: int) -> Any:
    """A value written on one line: flow collection, quoted or plain."""
    if text[0] in "[{":
        f = _Flow(text, number)
        value = f.node()
        f.skip()
        if f.i != len(text):
            raise _error(f"text after the flow collection: {text[f.i:]!r}", number)
        return value
    if text[0] in "'\"":
        value, end = _quoted(text, 0, number)
        if text[end:].strip():
            raise _error(f"text after the quoted scalar: {text[end:]!r}", number)
        return value
    _check_plain_start(text, number)
    if _key_split(text, number) is not None:
        raise _error(f"mapping values are not allowed here: {text!r}", number)
    return resolve_plain(text)


def _key_split(text: str, number: int):
    """'key: rest' -> (key, rest) when the line is a mapping entry, else None."""
    if text[0] in "'\"":
        key, end = _quoted(text, 0, number)
        rest = text[end:]
        if rest == ":" or rest.startswith(": "):
            return key, rest[1:].strip()
        return None
    if text[0] in "[{":
        return None
    for m in re.finditer(r":(?= |$)", text):
        key = text[:m.start()].rstrip()
        _check_plain_start(key, number)
        return resolve_plain(key), text[m.end():].strip()
    return None


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Block:
    def __init__(self, lines: List[_Line]):
        self.lines = lines
        self.i = 0

    def peek(self):
        return self.lines[self.i] if self.i < len(self.lines) else None

    def node(self, indent: int) -> Any:
        line = self.peek()
        if _is_item(line.text):
            return self.seq(line.indent)
        if _key_split(line.text, line.number) is not None:
            return self.map(line.indent)
        self.i += 1
        nxt = self.peek()
        if nxt is not None and nxt.indent >= indent and nxt.indent > 0:
            raise _error("multi-line plain scalars are not supported", nxt.number)
        return _inline(line.text, line.number)

    def seq(self, indent: int) -> list:
        out = []
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            if line.indent == indent and not _is_item(line.text):
                return out      # the next key of a mapping at this indentation
            if line.indent > indent:
                raise _error(f"unexpected {line.text!r} in a sequence", line.number)
            rest = line.text[1:].lstrip(" ")
            if rest:
                if _is_item(rest) or _key_split(rest, line.number) is not None:
                    # a compact nested node: read it as a line of its own
                    offset = len(line.text) - len(rest)
                    self.lines[self.i] = _Line(line.indent + offset, rest, line.number)
                    out.append(self.node(line.indent + offset))
                else:
                    self.i += 1
                    out.append(_inline(rest, line.number))
                continue
            self.i += 1
            nxt = self.peek()
            out.append(self.node(nxt.indent) if nxt is not None and nxt.indent > indent
                       else None)

    def map(self, indent: int) -> dict:
        out = {}
        while True:
            line = self.peek()
            if line is None or line.indent < indent:
                return out
            split = _key_split(line.text, line.number) if line.indent == indent else None
            if split is None:
                if _is_item(line.text) and line.indent == indent:
                    return out      # a sequence at its parent key's indentation ends
                raise _error(f"unexpected {line.text!r} in a mapping", line.number)
            key, rest = split
            if rest:
                if _is_item(rest):
                    raise _error("a sequence may not start on its key's line", line.number)
                self.i += 1
                out[key] = _inline(rest, line.number)
                continue
            self.i += 1
            nxt = self.peek()
            if nxt is not None and (nxt.indent > indent
                                    or (nxt.indent == indent and _is_item(nxt.text))):
                out[key] = self.node(nxt.indent)
            else:
                out[key] = None


def loads(text: str) -> Any:
    """Parse one YAML document of the supported subset (None when empty)."""
    lines = _lines(text)
    if not lines:
        return None
    block = _Block(lines)
    value = block.node(lines[0].indent)
    if block.peek() is not None:
        line = block.peek()
        raise _error(f"unexpected {line.text!r}", line.number)
    return value


def load(path: str) -> Any:
    with open(path) as f:
        return loads(f.read())


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

_BLANKS = "\0 \t\r\n\x85\u2028\u2029"
_BREAKS = "\n\x85\u2028\u2029"
_DQ_ESCAPES = {"\0": "0", "\a": "a", "\b": "b", "\t": "t", "\n": "n", "\v": "v",
               "\f": "f", "\r": "r", "\x1b": "e", '"': '"', "\\": "\\",
               "\x85": "N", "\xa0": "_", "\u2028": "L", "\u2029": "P"}


def _plain_allowed(s: str) -> bool:
    """PyYAML's analysis of a scalar (Emitter.analyze_scalar, ASCII only):
    whether it may be written plain in block context."""
    if not s or s.startswith(("---", "...")):
        return False
    if s[0] in " \n" or s[-1] in " \n" or any(c in _BREAKS for c in s):
        return False
    if any(not (" " <= c <= "~") for c in s):
        return False
    follows = len(s) == 1 or s[1] in _BLANKS
    if s[0] in "#,[]{}&*!|>'\"%@`" or (s[0] in "?:-" and follows):
        return False
    for i in range(1, len(s)):
        follows = i + 1 >= len(s) or s[i + 1] in _BLANKS
        if (s[i] == ":" and follows) or (s[i] == "#" and s[i - 1] in _BLANKS):
            return False
    return True


def _reads_as_itself(s: str) -> bool:
    try:
        return resolve_plain(s) == s and isinstance(resolve_plain(s), str)
    except ValueError:      # a timestamp or merge key: not a plain string
        return False


def _write_string(s: str) -> str:
    if _reads_as_itself(s) and _plain_allowed(s):
        return s
    if all(" " <= c <= "~" for c in s):
        return "'" + s.replace("'", "''") + "'"
    out = []
    for c in s:
        if c in _DQ_ESCAPES:
            out.append("\\" + _DQ_ESCAPES[c])
        elif " " <= c <= "~":
            out.append(c)
        elif c <= "\xff":
            out.append(f"\\x{ord(c):02X}")
        elif c <= "\uffff":
            out.append(f"\\u{ord(c):04X}")
        else:
            out.append(f"\\U{ord(c):08X}")
    return '"' + "".join(out) + '"'


def _write_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    if isinstance(v, str):
        return _write_string(v)
    raise TypeError(f"yaml_subset.dump: cannot write a {type(v).__name__}")


def _write_block(node: Any, indent: int, lines: List[str], lead: str) -> None:
    """Write `node` whose first line starts with `lead` (a key with its
    colon, or the dashes of sequence items) at column `indent`."""
    pad = " " * indent
    if isinstance(node, dict) and node:
        first = True
        for k in sorted(node):
            head = (lead if first else pad) + _write_scalar(k) + ":"
            first = False
            _write_value(node[k], indent, lines, head)
    elif isinstance(node, list) and node:
        first = True
        for item in node:
            head = (lead if first else pad) + "- "
            first = False
            if isinstance(item, (dict, list)) and item:
                _write_block(item, indent + 2, lines, head)
            else:
                lines.append(head + _write_leaf(item))
    else:
        lines.append(lead + _write_leaf(node))


def _write_leaf(node: Any) -> str:
    if isinstance(node, dict):
        return "{}"
    if isinstance(node, list):
        return "[]"
    return _write_scalar(node)


def _write_value(v: Any, indent: int, lines: List[str], head: str) -> None:
    """A mapping entry's value: nested blocks on the next lines (mappings
    indented by 2, sequences at the key's column), else on the key's line."""
    if isinstance(v, dict) and v:
        lines.append(head)
        _write_block(v, indent + 2, lines, " " * (indent + 2))
    elif isinstance(v, list) and v:
        lines.append(head)
        _write_block(v, indent, lines, " " * indent)
    else:
        lines.append(head + " " + _write_leaf(v))


def dump(tree: Any) -> str:
    """`tree` (dicts with string keys, lists, str / int / float / bool /
    None) as YAML text, as `yaml.safe_dump(tree)` writes it."""
    lines: List[str] = []
    if isinstance(tree, (dict, list)) and tree:
        _write_block(tree, 0, lines, "")
        return "\n".join(lines) + "\n"
    if isinstance(tree, (dict, list)):
        return _write_leaf(tree) + "\n"
    return _write_leaf(tree) + "\n...\n"

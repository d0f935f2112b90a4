"""The subset of OpenCV-flavoured YAML that the reference's settings files
use, parsed without PyYAML (which the GPU machine lacks).

The subset:

* the ``%YAML:1.0`` directive line (and a ``---`` document start);
* flat ``Key.name: scalar`` lines at column 0, with comments (``#`` at the
  start of a line or after whitespace);
* plain, single-quoted and double-quoted scalars on one line;
* ``Key: !!opencv-matrix`` followed by an indented mapping of ``rows``,
  ``cols``, ``dt`` and a flow list ``data: [...]`` that may span lines,
  which becomes a ``(rows, cols)`` float64 array.

Plain scalars resolve as PyYAML's YAML 1.1 ``SafeLoader`` resolves them
(the regular expressions and constructors below are its own): unquoted
``1.0`` is a float, ``1e-5`` (no dot) and ``1.0e5`` (no exponent sign)
are strings, ``3.e-03`` is a float, ``010`` is octal, ``yes``/``off`` are
booleans and ``~`` is null. A line the subset cannot read raises
``ValueError`` naming its line; nothing is skipped.
"""

from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np

# PyYAML's implicit resolvers (yaml/resolver.py), in its order; each is
# tried only for plain scalars starting with one of its characters
_RESOLVERS = (
    ("bool", re.compile(r'''^(?:yes|Yes|YES|no|No|NO
                    |true|True|TRUE|false|False|FALSE
                    |on|On|ON|off|Off|OFF)$''', re.X), "yYnNtTfFoO"),
    ("float", re.compile(r'''^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$''', re.X), "-+0123456789."),
    ("int", re.compile(r'''^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$''', re.X),
     "-+0123456789"),
    ("merge", re.compile(r'^(?:<<)$'), "<"),
    ("null", re.compile(r'''^(?: ~
                    |null|Null|NULL
                    | )$''', re.X), "~nN"),
    ("timestamp", re.compile(r'''^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$''',
                             re.X), "0123456789"),
    ("value", re.compile(r'^(?:=)$'), "="),
)

_BOOL = {"yes": True, "no": False, "true": True, "false": False,
         "on": True, "off": False}
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
# characters a plain scalar may not start with (YAML indicators)
_INDICATORS = "[]{}#&*!|>'\"%@`,"
_MATRIX_TAG = "!!opencv-matrix"


def _fail(lineno: int, line: str, why: str):
    raise ValueError(f"settings line {lineno}: {why}: {line.strip()!r}")


def _int(value: str) -> int:
    """PyYAML's construct_yaml_int."""
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
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        out, base = 0, 1
        for digit in reversed([int(p) for p in value.split(":")]):
            out += digit * base
            base *= 60
        return sign * out
    return sign * int(value)


def _float(value: str) -> float:
    """PyYAML's construct_yaml_float."""
    value = value.replace("_", "").lower()
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    if ":" in value:
        out, base = 0.0, 1
        for digit in reversed([float(p) for p in value.split(":")]):
            out += digit * base
            base *= 60
        return sign * out
    return sign * float(value)


def resolve_plain(text: str, lineno: int = 0, line: str = ""):
    """A plain scalar's value, as PyYAML's SafeLoader constructs it."""
    first = text[:1]
    for kind, rx, starts in _RESOLVERS:
        if (first in starts or (kind == "null" and not text)) and \
                rx.match(text):
            if kind == "bool":
                return _BOOL[text.lower()]
            if kind == "float":
                return _float(text)
            if kind == "int":
                return _int(text)
            if kind == "null":
                return None
            _fail(lineno, line, f"a YAML {kind} scalar is not supported")
    return text


def _double_quoted(body: str, lineno: int, line: str) -> str:
    out, i = [], 0
    while i < len(body):
        ch = body[i]
        if ch != "\\":
            out.append(ch)
            i += 1
            continue
        esc = body[i + 1:i + 2]
        if esc in _ESCAPES:
            out.append(_ESCAPES[esc])
            i += 2
        elif esc in _HEX_ESCAPES:
            n = _HEX_ESCAPES[esc]
            digits = body[i + 2:i + 2 + n]
            if len(digits) != n or not re.fullmatch(r"[0-9a-fA-F]+", digits):
                _fail(lineno, line, "bad escape in a double-quoted string")
            out.append(chr(int(digits, 16)))
            i += 2 + n
        else:
            _fail(lineno, line, "bad escape in a double-quoted string")
    return "".join(out)


def _scalar(text: str, lineno: int, line: str, flow: bool = False
            ) -> Tuple[object, str]:
    """One scalar at the start of ``text`` (leading blanks stripped):
    (value, the rest of the text after it)."""
    text = text.lstrip(" ")
    if not text or text[0] == "#":
        return None, text
    if text[:1] == '"':
        m = re.match(r'"((?:[^"\\]|\\.)*)"', text)
        if m is None:
            _fail(lineno, line, "unterminated double-quoted string")
        return _double_quoted(m.group(1), lineno, line), text[m.end():]
    if text[:1] == "'":
        m = re.match(r"'((?:[^']|'')*)'", text)
        if m is None:
            _fail(lineno, line, "unterminated single-quoted string")
        return m.group(1).replace("''", "'"), text[m.end():]
    stop = r"\s#|,|\[|\]|\{|\}" if flow else r"\s#"
    m = re.search(stop, text)
    plain = (text if m is None else text[:m.start()]).rstrip(" ")
    rest = "" if m is None else text[m.start():]
    if plain[:1] and plain[0] in _INDICATORS or re.match(r"[-?:](\s|$)",
                                                         plain):
        _fail(lineno, line, "unsupported YAML syntax")
    if re.search(r":(\s|$)", plain) or "\t" in plain:
        _fail(lineno, line, "unsupported YAML syntax")
    return resolve_plain(plain, lineno, line), rest


def _end_of_line(rest: str, lineno: int, line: str) -> None:
    """Only blanks and a comment may follow a value."""
    rest = rest.strip(" ")
    if rest and not rest.startswith("#"):
        _fail(lineno, line, "unexpected text after the value")


def _key_value(line: str, lineno: int) -> Tuple[object, str]:
    m = re.match(r"([^\s#:'\"][^:#]*?|'[^']*'|\"[^\"]*\")[ ]*:(?:[ ]+|$)",
                 line)
    if m is None:
        _fail(lineno, line, "not a 'key: value' line")
    key, rest = _scalar(m.group(1), lineno, line)
    _end_of_line(rest, lineno, line)
    return key, line[m.end():]


def _is_blank(line: str) -> bool:
    s = line.strip(" ")
    return not s or s.startswith("#")


def _matrix(lines: List[str], i: int, lineno0: int, head: str
            ) -> Tuple[np.ndarray, int]:
    """The indented mapping of an ``!!opencv-matrix`` node starting at
    ``lines[i]``: returns (the matrix, the index of the next line)."""
    fields = {}
    while i < len(lines):
        line = lines[i]
        lineno = i + 1
        if _is_blank(line):
            i += 1
            continue
        if "\t" in line[:len(line) - len(line.lstrip())]:
            _fail(lineno, line, "tab in indentation")
        if not line.startswith(" "):
            break
        key, rest = _key_value(line.lstrip(" "), lineno)
        if key in fields:
            _fail(lineno, line, "repeated matrix field")
        if key == "data":
            items, i = _flow_list(lines, i, rest, lineno, line)
            fields[key] = items
            continue
        if rest.lstrip(" ")[:1] in ("", "#"):
            _fail(lineno, line, "a matrix field needs a value")
        value, tail = _scalar(rest, lineno, line)
        _end_of_line(tail, lineno, line)
        fields[key] = value
        i += 1
    if set(fields) - {"rows", "cols", "dt", "data"} or not \
            {"rows", "cols", "data"} <= set(fields):
        _fail(lineno0, head, "an opencv-matrix needs rows, cols and data "
              "(and at most dt)")
    try:
        data = np.asarray(fields["data"], np.float64)
        return data.reshape(fields["rows"], fields["cols"]), i
    except (TypeError, ValueError) as err:
        _fail(lineno0, head, f"bad opencv-matrix ({err})")


def _flow_list(lines: List[str], i: int, rest: str, lineno: int, line: str
               ) -> Tuple[list, int]:
    """A flow sequence ``[a, b, ...]`` beginning in ``rest`` (the text
    after ``data:`` on ``lines[i]``), possibly spanning lines: returns
    (its scalars, the index of the line after it)."""
    text = rest.lstrip(" ")
    if text[:1] != "[":
        _fail(lineno, line, "matrix data must be a flow list [...]")
    text = text[1:]
    items, expect_item = [], True
    while True:
        text = text.lstrip(" ")
        if not text or text.startswith("#"):
            i += 1
            if i >= len(lines):
                _fail(lineno, line, "unterminated flow list")
            text, lineno, line = lines[i], i + 1, lines[i]
            if not text.startswith(" ") and text.strip():
                _fail(lineno, line, "flow list continuation not indented")
            continue
        if text[0] == "]":
            _end_of_line(text[1:], lineno, line)
            return items, i + 1
        if text[0] == ",":
            if expect_item:
                _fail(lineno, line, "empty item in a flow list")
            expect_item = True
            text = text[1:]
            continue
        if not expect_item:
            _fail(lineno, line, "missing comma in a flow list")
        value, text = _scalar(text, lineno, line, flow=True)
        items.append(value)
        expect_item = False


def parse_settings_yaml(text: str) -> dict:
    """The settings file's top-level mapping, as the JAX package's
    PyYAML loader (with the ``%YAML`` line dropped) gives it."""
    lines = text.splitlines()
    out, i, started = {}, 0, False
    while i < len(lines):
        line = lines[i]
        lineno = i + 1
        if line.strip().startswith("%YAML") or _is_blank(line):
            i += 1
            continue
        if line.rstrip(" ") == "---" and not started:
            started = True
            i += 1
            continue
        if line[0] in " \t":
            _fail(lineno, line, "unexpected indentation")
        started = True
        key, rest = _key_value(line, lineno)
        head = rest.lstrip(" ")
        if head.startswith(_MATRIX_TAG):
            _end_of_line(head[len(_MATRIX_TAG):], lineno, line)
            out[key], i = _matrix(lines, i + 1, lineno, line)
            continue
        if head.startswith("!"):
            _fail(lineno, line, "unsupported YAML tag")
        value, tail = _scalar(rest, lineno, line)
        _end_of_line(tail, lineno, line)
        if value is None and i + 1 < len(lines) and \
                lines[i + 1][:1] in (" ", "\t") and \
                not _is_blank(lines[i + 1]):
            _fail(lineno + 1, lines[i + 1], "nested YAML blocks are not "
                  "supported")
        out[key] = value
        i += 1
    if not out:
        raise ValueError("settings file holds no keys")
    return out

"""Reader for the YAML subset the config files use.

The configs (``configs/*.yaml``, the camera files, and what
``io.synth_dataset`` writes) use block mappings nested by indentation,
plain or quoted scalars, inline lists (``[a, b]``) and ``#`` comments.
:func:`load` reads exactly that subset into the values ``yaml.safe_load``
gives for it, so the package needs no YAML library.  Anything outside the
subset (block sequences, anchors, tags, multi-line scalars) raises
``ValueError`` naming the line.
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple

_INT = re.compile(r"[-+]?[0-9]+")
# YAML 1.1 floats (as PyYAML reads them): a dot, and a signed exponent.
_FLOAT = re.compile(r"[-+]?([0-9]+\.[0-9]*|\.[0-9]+)([eE][-+][0-9]+)?")
_BOOL = {
    "true": True, "True": True, "TRUE": True, "yes": True, "Yes": True,
    "on": True, "On": True,
    "false": False, "False": False, "FALSE": False, "no": False, "No": False,
    "off": False, "Off": False,
}
_NULL = {"", "~", "null", "Null", "NULL"}


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows whitespace,
    outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(tok: str, lineno: int) -> Any:
    tok = tok.strip()
    if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "'\"":
        body = tok[1:-1]
        return body.replace("''", "'") if tok[0] == "'" else body
    if tok[:1] in ("&", "*", "!", "|", ">", "{", "-") and not _INT.fullmatch(
        tok
    ) and not _FLOAT.fullmatch(tok):
        raise ValueError(f"line {lineno}: unsupported YAML value {tok!r}")
    if tok in _NULL:
        return None
    if tok in _BOOL:
        return _BOOL[tok]
    if _INT.fullmatch(tok):
        return int(tok)
    if _FLOAT.fullmatch(tok):
        return float(tok)
    return tok


def _value(tok: str, lineno: int) -> Any:
    tok = tok.strip()
    if tok.startswith("["):
        if not tok.endswith("]"):
            raise ValueError(f"line {lineno}: unterminated inline list")
        inner = tok[1:-1].strip()
        return [_scalar(t, lineno) for t in inner.split(",")] if inner else []
    return _scalar(tok, lineno)


def load(text: str) -> Any:
    """Parse ``text`` (see module docstring); an empty document is None."""
    lines: List[Tuple[int, int, str]] = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        if raw.startswith("%") or raw.strip() in ("---", "..."):
            raise ValueError(f"line {lineno}: YAML directives are not supported")
        body = _strip_comment(raw).rstrip()
        if not body.strip():
            continue
        if "\t" in body[: len(body) - len(body.lstrip())]:
            raise ValueError(f"line {lineno}: tab indentation")
        lines.append((lineno, len(body) - len(body.lstrip()), body.strip()))
    if not lines:
        return None
    out, end = _mapping(lines, 0, lines[0][1])
    if end != len(lines):
        raise ValueError(f"line {lines[end][0]}: bad indentation")
    return out


def _mapping(lines, i: int, indent: int):
    out: dict = {}
    while i < len(lines):
        lineno, ind, body = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise ValueError(f"line {lineno}: bad indentation")
        if body.startswith("- "):
            raise ValueError(f"line {lineno}: block sequences are not supported")
        key, sep, rest = body.partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            raise ValueError(f"line {lineno}: expected 'key: value'")
        key = _scalar(key, lineno)
        i += 1
        if rest.strip():
            out[key] = _value(rest, lineno)
        elif i < len(lines) and lines[i][1] > indent:
            out[key], i = _mapping(lines, i, lines[i][1])
        else:
            out[key] = None
    return out, i

"""A reader of ``config/srl_models.yaml`` without PyYAML.

The file maps env ids to ``{log_folder, model name: checkpoint path}``: a
two-level block mapping of plain or quoted scalars with comments. This
reads that subset and raises on anything outside it (sequences, flow
collections, anchors, deeper nesting), so that it never returns a
different tree than ``yaml.safe_load`` would.
"""
from __future__ import annotations

import re

_KEY = re.compile(r"^(?P<key>[^\s#'\"{}\[\]&*!|>%@`,][^:#]*?)\s*:(?:\s+(?P<value>.*))?$")
_INT = re.compile(r"^[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"^[-+]?(\.[0-9]+|[0-9][0-9_]*(\.[0-9_]*)?)([eE][-+]?[0-9]+)?$")


def _strip_comment(line: str) -> str:
    """The line without its comment: a '#' at the start or after
    whitespace, outside quotes."""
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


def _scalar(text: str, where: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    if not text or text[0] in "[]{}&*!|>%@`'\"":
        raise ValueError(f"{where}: unsupported YAML value {text!r}")
    low = text.lower()
    if low in ("null", "~"):
        return None
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    return text


def parse_srl_models(text: str, name: str = "<yaml>") -> dict:
    """``{env: {key: value}}`` of a two-level block mapping."""
    out: dict = {}
    section, indent = None, None
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        if "\t" in line[: len(line) - len(line.lstrip())]:
            raise ValueError(f"{where}: tab indentation")
        width = len(line) - len(line.lstrip(" "))
        m = _KEY.match(line.strip())
        if m is None:
            raise ValueError(f"{where}: not a 'key: value' line: {raw!r}")
        key, value = m.group("key").strip(), m.group("value")
        if not width:
            if value is None:
                section, indent = {}, None
                out[key] = section
            else:
                section, out[key] = None, _scalar(value, where)
            continue
        if section is None or value is None or width != (indent or width):
            raise ValueError(f"{where}: only two levels of mapping are supported")
        indent = width
        section[key] = _scalar(value, where)
    # A key with nothing under it is null, as in YAML.
    return {k: None if v == {} else v for k, v in out.items()}


def read_srl_models(path: str) -> dict:
    with open(path) as f:
        return parse_srl_models(f.read(), path)

"""A reader of the port's YAML files without PyYAML.

Two kinds of file are read: ``config/srl_models.yaml``, which maps env ids
to ``{log_folder, model name: checkpoint path}``, and the ROS
``camera_info`` files of ``camera_calibration``, which hold the intrinsics
as top-level scalars (``image_width``, ``camera_name``,
``distortion_model``) and blocks of ``rows`` / ``cols`` / ``data`` whose
``data`` is a flow list of numbers, which may run over several lines:

    camera_matrix:
      rows: 3
      cols: 3
      data: [500.0, 0.0, 320.0, 0.0, 500.0, 240.0, 0.0, 0.0, 1.0]

This reads that subset: block mappings two levels deep, plain or quoted
scalars, and flow lists of plain scalars. Scalars resolve as PyYAML's
``safe_load`` resolves them (YAML 1.1: ``yes`` is True, ``1e5`` is a
string, ``1.0e+5`` a float). Anything outside the subset raises a
ValueError: anchors and aliases, tags, block lists, nested flow
collections, block scalars, deeper nesting, octal or sexagesimal numbers,
timestamps. So it never returns a different tree than ``yaml.safe_load``.
"""
from __future__ import annotations

import re

_KEY = re.compile(r"^(?P<key>[A-Za-z0-9_][^:#]*?)\s*:(?:\s+(?P<value>.*))?$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
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
_DECIMAL = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_INDICATORS = ",[]{}#&*!|>%@`"


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


def _plain(text: str, where: str):
    """A plain scalar, resolved as PyYAML's implicit resolvers do."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        clean = text.replace("_", "").lower()
        if ":" in clean:
            raise ValueError(f"{where}: sexagesimal number {text!r}")
        if clean.endswith(".inf"):
            return float("-inf") if clean[0] == "-" else float("inf")
        if clean == ".nan":
            return float("nan")
        return float(clean)
    if _INT.match(text):
        if not _DECIMAL.match(text):
            raise ValueError(f"{where}: non-decimal integer {text!r}")
        return int(text.replace("_", ""))
    if _TIMESTAMP.match(text) or text in ("<<", "="):
        raise ValueError(f"{where}: unsupported YAML value {text!r}")
    if (text[0] in _INDICATORS or text[0] in "-?:" and (len(text) == 1 or text[1] == " ")
            or ": " in text or text.endswith(":")):
        raise ValueError(f"{where}: unsupported YAML value {text!r}")
    return text


def _quoted(text: str, where: str) -> str:
    quote, body = text[0], text[1:-1]
    if len(text) < 2 or text[-1] != quote:
        raise ValueError(f"{where}: unterminated quoted scalar {text!r}")
    if quote == '"':
        if "\\" in body or '"' in body:
            raise ValueError(f"{where}: escapes in a double-quoted scalar {text!r}")
        return body
    if "'" in body.replace("''", ""):
        raise ValueError(f"{where}: unbalanced quotes in {text!r}")
    return body.replace("''", "'")


def _flow_list(text: str, where: str) -> list:
    body = text[1:-1].strip()
    if not body:
        return []
    items = []
    for item in body.split(","):
        item = item.strip()
        if not item or any(c in item for c in "[]{}'\":"):
            raise ValueError(f"{where}: unsupported flow list item {item!r} in {text!r}")
        items.append(_plain(item, where))
    return items


def _value(text: str, where: str):
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]") or text.count("[") != 1 or text.count("]") != 1:
            raise ValueError(f"{where}: unsupported flow list {text!r}")
        return _flow_list(text, where)
    if text[:1] in "'\"":
        return _quoted(text, where)
    return _plain(text, where)


def _lines(text: str, name: str):
    """(line number, indent, content) of each line that holds something, a
    flow list that runs over several lines joined into its first."""
    pending = None
    for n, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{n}"
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        lead = line[: len(line) - len(line.lstrip())]
        if "\t" in lead:
            raise ValueError(f"{where}: tab indentation")
        if pending is not None:
            if len(lead) <= pending[1]:
                raise ValueError(f"{where}: flow list continued at its key's indentation")
            pending[2] += " " + line.strip()
            if "]" in line:
                yield tuple(pending)
                pending = None
            continue
        entry = [n, len(lead), line.strip()]
        m = _KEY.match(entry[2])
        value = (m.group("value") or "").strip() if m else ""
        if value.startswith("[") and "]" not in value:
            pending = entry
            continue
        yield tuple(entry)
    if pending is not None:
        raise ValueError(f"{name}:{pending[0]}: unterminated flow list")


def parse_yaml_subset(text: str, name: str = "<yaml>"):
    """The tree of a YAML document in the subset the module's docstring
    sets out."""
    out: dict = {}
    section, indent = None, None
    for n, width, line in _lines(text, name):
        where = f"{name}:{n}"
        if line in ("---", "...") or line.startswith("%"):
            raise ValueError(f"{where}: document markers and directives are not supported")
        m = _KEY.match(line)
        if m is None:
            raise ValueError(f"{where}: not a 'key: value' line: {line!r}")
        key, value = m.group("key").strip(), m.group("value")
        if not isinstance(_plain(key, where), str):
            raise ValueError(f"{where}: key {key!r} does not resolve to a string")
        if not width:
            if value is None:
                section, indent = {}, None
                out[key] = section
            else:
                section, out[key] = None, _value(value, where)
            continue
        if section is None or value is None or width != (indent or width):
            raise ValueError(f"{where}: only two levels of mapping are supported")
        indent = width
        section[key] = _value(value, where)
    # A key with nothing under it is null, and so is an empty document.
    return {k: None if v == {} else v for k, v in out.items()} or None


def read_yaml_subset(path: str):
    with open(path) as f:
        return parse_yaml_subset(f.read(), path)

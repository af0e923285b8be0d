"""The morphology pipeline's config (reference:
wheatheadsmorphology/main.py:29-141).

Counterpart of wheat3dgs_tpu/morphology/config.py without pydantic or
yaml. `MorphologyConfig` is a dataclass whose checks follow the JAX
package's pydantic model field by field (DirectoryPath, StrictInt, the
Literal, the lax int/float and bool coercions, and its three validators);
each raises ValueError where that model fails. `load_config` reads a subset
of YAML with `read_yaml_subset`: mappings nested by indentation; quoted and
bare strings, ints, floats and true/false; `#` comments. Anything outside
the subset raises, so no file is misparsed silently.
"""

from __future__ import annotations

import dataclasses
import os
import re
from pathlib import Path
from typing import Any, Dict, Union

_BOOL_WORDS = {"0": False, "off": False, "f": False, "false": False,
               "n": False, "no": False, "1": True, "on": True, "t": True,
               "true": True, "y": True, "yes": True}
_INT_RE = re.compile(r"[-+]?(0|[1-9][0-9]*)")
_FLOAT_RE = re.compile(r"[-+]?[0-9]+\.[0-9]*([eE][-+][0-9]+)?")


def _directory(name: str, v) -> Path:
    if not isinstance(v, (str, os.PathLike)):
        raise ValueError(f"{name}: input is not a valid path")
    p = Path(v)
    if not p.is_dir():
        raise ValueError(f"{name}: path {str(p)!r} does not point to a "
                         "directory")
    return p


def _number(name: str, v) -> Union[int, float]:
    """pydantic's lax `Union[int, float]`: int and float as given, a bool
    as its int, a numeric string as an int, else as a float."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)):
        return v
    if isinstance(v, str):
        s = v.strip()
        try:
            return int(s)
        except ValueError:
            pass
        try:
            return float(s)
        except ValueError:
            pass
    raise ValueError(f"{name}: input should be a valid number, got {v!r}")


def _bool(name: str, v) -> bool:
    """pydantic's lax bool: bools, 0 / 1 (int or float) and its words."""
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)) and v in (0, 1):
        return bool(v)
    if isinstance(v, str) and v.strip().lower() in _BOOL_WORDS:
        return _BOOL_WORDS[v.strip().lower()]
    raise ValueError(f"{name}: input should be a valid boolean, got {v!r}")


@dataclasses.dataclass
class MorphologyConfig:
    data_folder: Path
    output_folder: Path
    file_format: str
    subsampling_threshold: int
    clusterer_definition: Dict[str, Any]
    sor_parameters: Dict[str, Any]
    splines_smoothing_value: Union[int, float]
    distance_percentile: Union[int, float]
    get_bboxes: bool
    get_processed_pcd: bool

    def __post_init__(self):
        self.data_folder = _directory("data_folder", self.data_folder)
        self.output_folder = _directory("output_folder", self.output_folder)
        if not (isinstance(self.file_format, str)
                and self.file_format in ("ply", "txt")):
            raise ValueError("file_format: input should be 'ply' or 'txt'")
        if (isinstance(self.subsampling_threshold, bool)
                or not isinstance(self.subsampling_threshold, int)):
            raise ValueError("subsampling_threshold: input should be a "
                             "valid integer")
        for name in ("clusterer_definition", "sor_parameters"):
            if not isinstance(getattr(self, name), dict):
                raise ValueError(f"{name}: input should be a valid "
                                 "dictionary")
        self.splines_smoothing_value = _number(
            "splines_smoothing_value", self.splines_smoothing_value)
        self.distance_percentile = _number("distance_percentile",
                                           self.distance_percentile)
        self.get_bboxes = _bool("get_bboxes", self.get_bboxes)
        self.get_processed_pcd = _bool("get_processed_pcd",
                                       self.get_processed_pcd)
        _check_clusterer(self.clusterer_definition)
        _check_sor(self.sor_parameters)
        if not 1 <= float(self.distance_percentile) <= 100:
            raise ValueError("distance_percentile must be in [1, 100]")


def _check_clusterer(v: dict) -> None:
    if v.get("type") not in ("dbscan", "hdbscan"):
        raise ValueError('clusterer_definition.type must be "dbscan" or '
                         '"hdbscan"')
    if v["type"] == "dbscan" and not isinstance(v.get("epsilon"),
                                                (int, float)):
        raise ValueError("dbscan needs a numeric epsilon")
    if v["type"] == "hdbscan":
        if not isinstance(v.get("min_cluster_size"), int):
            raise ValueError("hdbscan needs int min_cluster_size")
        if not isinstance(v.get("epsilon_hdbscan"), (int, float)):
            raise ValueError("hdbscan needs numeric epsilon_hdbscan")
    if not isinstance(v.get("min_samples"), int):
        raise ValueError("min_samples must be an int")


def _check_sor(v: dict) -> None:
    if not isinstance(v.get("k"), int):
        raise ValueError('sor_parameters must include int "k"')
    if not isinstance(v.get("std_ratio"), (int, float)):
        raise ValueError('sor_parameters must include numeric "std_ratio"')


# ------------------------------------------------------------- YAML subset

def _strip_comment(line: str) -> str:
    """The line without a `#` comment (a `#` at the start or after a
    blank, outside quotes)."""
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
    s = text.strip()
    if s[0] == '"':
        if len(s) < 2 or s[-1] != '"' or '"' in s[1:-1] or "\\" in s:
            raise ValueError(f"{where}: unsupported double-quoted string")
        return s[1:-1]
    if s[0] == "'":
        body = s[1:-1]
        if len(s) < 2 or s[-1] != "'" or "'" in body.replace("''", ""):
            raise ValueError(f"{where}: unsupported single-quoted string")
        return body.replace("''", "'")
    if s in ("true", "True", "TRUE"):
        return True
    if s in ("false", "False", "FALSE"):
        return False
    if _INT_RE.fullmatch(s):
        return int(s)
    if _FLOAT_RE.fullmatch(s):
        return float(s)
    # Bare scalars that YAML 1.1 reads as something other than a string
    # (null, yes/no/on/off, .inf, octal or hex or 1e3-style numbers,
    # dates, sexagesimals) and YAML's indicators are outside the subset.
    if (s[0] in "-?:,[]{}#&*!|>%@`"
            or s.lower() in ("null", "~", "yes", "no", "on", "off", "y", "n")
            or re.fullmatch(r"[-+]?[.0-9][0-9a-zA-Z_.:+-]*", s)
            or re.match(r"\d{4}-\d\d?-\d\d?", s)
            or ": " in s or s.endswith(":")):
        raise ValueError(f"{where}: scalar {s!r} is outside the YAML subset")
    return s


def read_yaml_subset(text: str) -> dict:
    """`yaml.safe_load` for the subset in the module docstring; raises
    ValueError on anything else (lists, anchors, flow style, tags, block
    scalars, tabs, duplicate keys, empty values)."""
    root: dict = {}
    stack = [(-1, root)]          # (indent, mapping)
    pending = None                # (indent, key, parent) awaiting a block
    for no, raw in enumerate(text.splitlines(), 1):
        where = f"line {no}"
        if "\t" in raw:
            raise ValueError(f"{where}: tabs are outside the YAML subset")
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if body in ("---", "...") or body.startswith("%"):
            raise ValueError(f"{where}: YAML directives and document "
                             "markers are outside the subset")
        m = re.fullmatch(r"([A-Za-z_][A-Za-z0-9_]*):(?:[ ]+(.*))?", body)
        if m is None:
            raise ValueError(f"{where}: {body!r} is not a `key: value` "
                             "line of the YAML subset")
        if pending is not None:
            p_indent, p_key, p_parent = pending
            if indent <= p_indent:
                raise ValueError(f"line {no - 1}: empty value for "
                                 f"{p_key!r} (null) is outside the subset")
            child: dict = {}
            p_parent[p_key] = child
            stack.append((indent, child))
            pending = None
        if stack[0][0] < 0:
            stack[0] = (indent, root)
        while len(stack) > 1 and indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"{where}: inconsistent indentation")
        mapping = stack[-1][1]
        key, value = m.group(1), m.group(2)
        if key in mapping:
            raise ValueError(f"{where}: duplicate key {key!r}")
        if value is None:
            pending = (indent, key, mapping)
            mapping[key] = None
        else:
            mapping[key] = _scalar(value, where)
    if pending is not None:
        raise ValueError(f"empty value for {pending[1]!r} (null) is outside "
                         "the YAML subset")
    return root


def load_config(config_path) -> MorphologyConfig:
    """Read the YAML subset, resolve paths relative to the config file,
    validate."""
    config_path = Path(config_path).resolve()
    raw = read_yaml_subset(config_path.read_text())
    base = config_path.parent
    if "data_folder" in raw:
        raw["data_folder"] = (
            base / os.path.expandvars(str(raw["data_folder"]))).resolve()
    if "output_folder" in raw:
        out = (base / os.path.expandvars(str(raw["output_folder"]))).resolve()
        os.makedirs(out, exist_ok=True)
        raw["output_folder"] = out
    names = [f.name for f in dataclasses.fields(MorphologyConfig)]
    missing = [k for k in names if k not in raw]
    if missing:
        raise ValueError(f"config {config_path}: missing fields {missing}")
    return MorphologyConfig(**{k: raw[k] for k in names})

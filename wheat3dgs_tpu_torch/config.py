"""Config / flag system (reference: arguments/__init__.py).

A stdlib-only copy of the JAX package's config module: the two packages
read and write the same `cfg_args` files.

Dataclass-based rebuild of the reflection ParamGroup system: field defaults
become CLI flags (leading-underscore names gain one-letter shorthands in the
reference; we accept both long and the same short flags), and a trained
model's flags are persisted to `<model_path>/cfg_args` in the reference's
`Namespace(...)` repr format so artifacts stay interchangeable. Parsing the
stored file uses ast.literal_eval on the kwargs rather than eval().
"""

from __future__ import annotations

import ast
import dataclasses
import os
from argparse import ArgumentParser, Namespace


@dataclasses.dataclass(frozen=True)
class ModelParams:
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    resolution: int = 1
    white_background: bool = False
    data_device: str = "cuda"
    eval: bool = True

    _shorthands = {"source_path": "-s", "model_path": "-m", "images": "-i",
                   "resolution": "-r", "white_background": "-w"}


@dataclasses.dataclass(frozen=True)
class PipelineParams:
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False

    _shorthands = {}


@dataclasses.dataclass(frozen=True)
class OptimizationParams:
    iterations: int = 15_000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30_000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 11_000
    densify_grad_threshold: float = 0.0002
    random_background: bool = False

    _shorthands = {}


def add_params(parser: ArgumentParser, params_cls, fill_none: bool = False):
    """Register a params dataclass's fields as CLI flags."""
    group = parser.add_argument_group(params_cls.__name__)
    shorthands = getattr(params_cls, "_shorthands", {})
    for f in dataclasses.fields(params_cls):
        default = None if fill_none else f.default
        names = ["--" + f.name]
        if f.name in shorthands:
            names.append(shorthands[f.name])
        if f.type in (bool, "bool"):
            group.add_argument(*names, default=default, action="store_true")
        else:
            t = {int: int, float: float, str: str,
                 "int": int, "float": float, "str": str}[f.type]
            group.add_argument(*names, default=default, type=t)
    return params_cls


def extract(params_cls, args: Namespace):
    """Build a params dataclass from parsed args (ignoring extra flags)."""
    kwargs = {}
    for f in dataclasses.fields(params_cls):
        if hasattr(args, f.name) and getattr(args, f.name) is not None:
            kwargs[f.name] = getattr(args, f.name)
    obj = params_cls(**kwargs)
    if isinstance(obj, ModelParams) and obj.source_path:
        obj = dataclasses.replace(obj,
                                  source_path=os.path.abspath(obj.source_path))
    return obj


def save_cfg_args(model_path: str, model: ModelParams) -> None:
    """Persist model flags in the reference's cfg_args format
    (train_vanilla_3dgs.py:134-135)."""
    os.makedirs(model_path, exist_ok=True)
    ns = Namespace(**dataclasses.asdict(model))
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(str(ns))


def _parse_namespace_repr(text: str) -> dict:
    """Parse `Namespace(k=v, ...)` safely (no eval)."""
    text = text.strip()
    if not text.startswith("Namespace(") or not text.endswith(")"):
        raise ValueError("not a Namespace repr")
    call = ast.parse(text, mode="eval").body
    if not isinstance(call, ast.Call):
        raise ValueError("not a call expression")
    return {kw.arg: ast.literal_eval(kw.value) for kw in call.keywords}


def get_combined_args(parser: ArgumentParser, argv=None) -> Namespace:
    """Merge CLI flags over a stored cfg_args file
    (reference: arguments/__init__.py:92-112)."""
    args_cmdline = parser.parse_args(argv)
    merged = {}
    cfgfilepath = os.path.join(args_cmdline.model_path or "", "cfg_args")
    try:
        with open(cfgfilepath) as f:
            merged = _parse_namespace_repr(f.read())
        print(f"Config file found: {cfgfilepath}")
    except OSError:
        print(f"Config file not found at {cfgfilepath}")
    except (ValueError, SyntaxError):
        print(f"Config file at {cfgfilepath} is malformed; ignoring it")
    for k, v in vars(args_cmdline).items():
        if v is not None:
            merged[k] = v
    return Namespace(**merged)

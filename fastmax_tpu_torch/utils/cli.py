"""Signature-derived CLI: a copy of ``fastmax_tpu/utils/cli.py`` (the role of
jsonargparse's CLI in the reference, lit_gpt/utils.py:373-379).

``CLI(fn)`` builds an argparse parser from ``fn``'s signature: parameter
names become ``--flags``, annotations drive type conversion (int, float,
bool, str, Path, Optional[...] thereof), defaults are honored, and dataclass
parameters expand to dotted flags (``--train.micro_batch_size``), matching
the reference's CLI surface.
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import typing
from pathlib import Path


def _base_type(ann):
    origin = typing.get_origin(ann)
    if origin is typing.Union:
        args = [a for a in typing.get_args(ann) if a is not type(None)]
        if len(args) == 1:
            return _base_type(args[0])
        return str
    if ann in (int, float, str, bool, Path):
        return ann
    if ann is inspect.Parameter.empty:
        return str
    return str


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"invalid bool {v!r}")


def _add_param(parser, name: str, ann, default):
    t = _base_type(ann)
    kwargs = {}
    if default is not inspect.Parameter.empty:
        kwargs["default"] = default
    else:
        kwargs["required"] = True
    if t is bool:
        parser.add_argument(f"--{name}", type=_str2bool, **kwargs)
    else:
        parser.add_argument(f"--{name}", type=t, **kwargs)


def CLI(fn, args=None):
    """Parse CLI flags from ``fn``'s signature and invoke it."""
    return fn(**parse_kwargs(fn, args))


def parse_kwargs(fn, args=None) -> dict:
    """The keyword arguments that ``CLI(fn, args)`` would call ``fn`` with."""
    sig = inspect.signature(fn)
    try:
        fn_hints = typing.get_type_hints(fn)
    except Exception:
        fn_hints = {}
    parser = argparse.ArgumentParser(description=fn.__doc__, prog=fn.__name__)
    dataclass_params = {}
    for name, p in sig.parameters.items():
        ann = fn_hints.get(name, p.annotation)
        if dataclasses.is_dataclass(ann) or (
            p.default is not inspect.Parameter.empty and dataclasses.is_dataclass(type(p.default))
        ):
            dc_type = ann if dataclasses.is_dataclass(ann) else type(p.default)
            dataclass_params[name] = (dc_type, p.default)
            # field annotations may be strings under `from __future__ import
            # annotations` — resolve them to real types
            hints = typing.get_type_hints(dc_type)
            for f in dataclasses.fields(dc_type):
                fdef = (
                    getattr(p.default, f.name)
                    if p.default is not inspect.Parameter.empty
                    else (f.default if f.default is not dataclasses.MISSING else inspect.Parameter.empty)
                )
                _add_param(parser, f"{name}.{f.name}", hints.get(f.name, f.type), fdef)
        else:
            _add_param(parser, name, ann, p.default)

    ns = vars(parser.parse_args(args))
    call_kwargs = {}
    for name, p in sig.parameters.items():
        if name in dataclass_params:
            dc_type, _ = dataclass_params[name]
            field_names = [f.name for f in dataclasses.fields(dc_type)]
            call_kwargs[name] = dc_type(**{fn_: ns[f"{name}.{fn_}"] for fn_ in field_names})
        else:
            call_kwargs[name] = ns[name]
    return call_kwargs

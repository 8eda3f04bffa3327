"""State carried across from the JAX package, and the type guard that
keeps foreign state out.

This system has no weights: what crosses between the two packages is the
search configuration, the compiled pattern and the results.  The port owns
its copies of those classes, and it compares their enums by identity
(``cfg.semantics is MatchSemantics.REFERENCE``), so a JAX object handed to
the port would match no branch and take the wrong route silently.  Hence:

- :func:`carry_over` turns a JAX ``SearchConfig``, ``CompiledPattern``,
  ``SearchResult``, ``SearchStats`` or ``FusedInfo`` (or a list of them)
  into the port's: dataclass and NamedTuple fields are read by name, enums
  are mapped by ``.name``, numpy arrays are copied.  It imports nothing of
  the JAX package; classes are matched by name.  A JAX config whose
  ``devices`` is set raises ``TypeError``: JAX devices have no torch
  counterpart, so the port's config takes its mesh explicitly.
- :func:`require_own` and :func:`require_config` raise ``TypeError`` on an
  object that is not the port's own; the port's entry points call them.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from .config import (
    Endianness,
    MatchSemantics,
    SearchConfig,
    SearchResult,
    SearchStep,
)
from .ops.host import FusedInfo
from .pattern import CompiledPattern, SearchMode
from .profiling import SearchStats

__all__ = ["carry_over", "require_own", "require_config"]

_ENUMS = {cls.__name__: cls
          for cls in (Endianness, MatchSemantics, SearchStep, SearchMode)}
_CLASSES = {cls.__name__: cls
            for cls in (SearchConfig, SearchResult, CompiledPattern,
                        SearchStats, FusedInfo)}


def carry_over(obj):
    """The port's equivalent of *obj*, a JAX-package (or port) object of
    one of the carried classes, an enum member of one of their enums, or a
    list, tuple or dict of those; plain values pass through.  Raises
    ``TypeError`` on another dataclass, NamedTuple or enum."""
    if isinstance(obj, enum.Enum):
        cls = _ENUMS.get(type(obj).__name__)
        if cls is None:
            raise TypeError(f"carry_over: no counterpart of enum {type(obj)}")
        return cls[obj.name]
    if isinstance(obj, np.ndarray):
        return obj.copy()
    if isinstance(obj, dict):
        return {carry_over(k): carry_over(v) for k, v in obj.items()}
    is_record = dataclasses.is_dataclass(obj) and not isinstance(obj, type)
    is_named = isinstance(obj, tuple) and hasattr(type(obj), "_fields")
    if is_record or is_named:
        cls = _CLASSES.get(type(obj).__name__)
        if cls is None:
            raise TypeError(f"carry_over: no counterpart of {type(obj)}")
        if (cls is SearchConfig and type(obj) is not SearchConfig
                and obj.devices is not None):
            raise TypeError(
                "carry_over: SearchConfig.devices holds JAX devices; set "
                "the port's config's devices to torch devices instead"
            )
        names = ([f.name for f in dataclasses.fields(obj) if f.init]
                 if is_record else type(obj)._fields)
        return cls(**{name: carry_over(getattr(obj, name)) for name in names})
    if isinstance(obj, (list, tuple)):
        return type(obj)(carry_over(v) for v in obj)
    return obj


def _foreign(value, cls, what: str) -> TypeError:
    kind = type(value)
    return TypeError(
        f"{what} must be a monkey_moore_tpu_torch {cls.__name__}, not "
        f"{kind.__module__}.{kind.__qualname__}; convert it with "
        "monkey_moore_tpu_torch.carry_over"
    )


def require_own(value, cls, what: str):
    """*value* if it is an instance of the port's *cls*, else ``TypeError``."""
    if not isinstance(value, cls):
        raise _foreign(value, cls, what)
    return value


def require_config(cfg, what: str) -> SearchConfig:
    """*cfg* if it is the port's ``SearchConfig`` holding the port's
    ``Endianness`` and ``MatchSemantics``, else ``TypeError``."""
    require_own(cfg, SearchConfig, what)
    require_own(cfg.endianness, Endianness, f"{what}: endianness")
    require_own(cfg.semantics, MatchSemantics, f"{what}: semantics")
    return cfg

"""Global flag system — the port's copy of paddle_tpu/framework/flags.py.

A process-wide registry of typed flags (the reference's PD_DEFINE_*
registry, paddle/common/flags.h:38,93), overridable from ``FLAGS_*``
environment variables and from Python via set_flags/get_flags
(python/paddle/base/framework.py:132,157). The port keeps its own
registry: its flags are read by its own modules (``serving/offload.py``
registers the ``serve_kv_offload_*`` flags) and never by the JAX
package's, so the two packages' flags do not see each other's values.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

_lock = threading.Lock()
_registry: Dict[str, "_Flag"] = {}


class _Flag:
    __slots__ = ("name", "default", "value", "type", "help")

    def __init__(self, name, default, type_, help_):
        self.name = name
        self.default = default
        self.value = default
        self.type = type_
        self.help = help_


def _coerce(type_, raw):
    if type_ is bool:
        if isinstance(raw, str):
            return raw.lower() in ("1", "true", "yes", "on")
        return bool(raw)
    return type_(raw)


def define_flag(name: str, default: Any, help: str = "", type_=None):
    """Register a flag; ``FLAGS_<name>`` in the environment overrides the default."""
    if type_ is None:
        type_ = type(default)
    with _lock:
        if name in _registry:
            return _registry[name].value
        flag = _Flag(name, default, type_, help)
        env = os.environ.get("FLAGS_" + name)
        if env is not None:
            flag.value = _coerce(type_, env)
        _registry[name] = flag
        return flag.value


def set_flags(flags: Dict[str, Any]):
    """paddle.set_flags parity. Validation is all-or-nothing: an unknown
    name or uncoercible value raises before any flag is applied."""
    with _lock:
        staged = []
        for k, v in flags.items():
            if k.startswith("FLAGS_"):
                k = k[len("FLAGS_"):]
            if k not in _registry:
                raise ValueError(f"unknown flag: {k}")
            staged.append((k, _coerce(_registry[k].type, v)))
        for k, v in staged:
            _registry[k].value = v


def get_flags(flags=None) -> Dict[str, Any]:
    """paddle.get_flags parity."""
    with _lock:
        if flags is None:
            return {"FLAGS_" + k: f.value for k, f in _registry.items()}
        if isinstance(flags, str):
            flags = [flags]
        out = {}
        for k in flags:
            key = k[len("FLAGS_"):] if k.startswith("FLAGS_") else k
            if key not in _registry:
                raise ValueError(f"unknown flag: {k}")
            out["FLAGS_" + key] = _registry[key].value
        return out


def get_flag(name: str):
    with _lock:
        return _registry[name].value

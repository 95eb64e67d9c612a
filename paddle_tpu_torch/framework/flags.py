"""Global flag system — the port's copy of paddle_tpu/framework/flags.py.

A process-wide registry of typed flags (the reference's PD_DEFINE_*
registry, paddle/common/flags.h:38,93), overridable from ``FLAGS_*``
environment variables and from Python via set_flags/get_flags
(python/paddle/base/framework.py:132,157). The port keeps its own
registry: its flags are read by its own modules (``serving/offload.py``
registers the ``serve_kv_offload_*`` flags, ``observability`` the
``obs_*`` ones) and never by the JAX package's, so the two packages'
flags do not see each other's values. Watchers (:func:`watch_flag`,
:func:`watch_all_flags`) run after a :func:`set_flags` commits, as in the
reference: observability keeps its hot-path switch and its ring sizes in
step with the flags through them.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict

_lock = threading.Lock()
_registry: Dict[str, "_Flag"] = {}
# flag-change observers: fn(new_value) per watched name
_watchers: Dict[str, list] = {}
# global observers: fn(name, new_value) for every actual value change (the
# flight recorder logs flag flips as incident evidence through this)
_global_watchers: list = []


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
    name or uncoercible value raises before any flag is applied, so a
    partial dict never commits some values while skipping their watcher
    notifications."""
    changed = []
    really_changed = []
    with _lock:
        staged = []
        for k, v in flags.items():
            if k.startswith("FLAGS_"):
                k = k[len("FLAGS_"):]
            if k not in _registry:
                raise ValueError(f"unknown flag: {k}")
            staged.append((k, _coerce(_registry[k].type, v)))
        for k, v in staged:
            if _registry[k].value != v:
                really_changed.append((k, v))
            _registry[k].value = v
            if k in _watchers:
                changed.append((k, v))
    # watchers run outside the lock: one may call back into this module
    for k, v in changed:
        for fn in list(_watchers.get(k, ())):
            fn(v)
    # global watchers see only actual value changes
    for k, v in really_changed:
        for fn in list(_global_watchers):
            fn(k, v)


def watch_flag(name: str, fn):
    """Register ``fn(new_value)`` to run whenever :func:`set_flags`
    changes ``name``. Returns ``fn``."""
    with _lock:
        _watchers.setdefault(name, []).append(fn)
    return fn


def watch_all_flags(fn):
    """Register ``fn(name, new_value)`` to run on every :func:`set_flags`
    change of any flag. Returns ``fn``."""
    with _lock:
        _global_watchers.append(fn)
    return fn


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


def flag_entries(prefix: str = ""):
    """``{name: (value, default, help)}`` for every registered flag whose
    name starts with ``prefix``."""
    with _lock:
        return {k: (f.value, f.default, f.help)
                for k, f in sorted(_registry.items())
                if k.startswith(prefix)}


"""Persistent artifact cache — the port's copy of paddle_tpu/jit/cache.py.

Artifacts whose recomputation is *measured* rather than traced — the
grouped-GEMM tile widths (:mod:`paddle_tpu_torch.kernels.gmm_autotune`)
and the MoE dispatch-form winners
(:func:`paddle_tpu_torch.kernels.moe_dispatch.pick_dispatch_form`) — are
worth keeping across runs. This module is the one place that knows where
such artifacts live and how to write them without torn files:

* ``cache_dir()`` — ``FLAGS_jit_cache_dir`` > ``$PADDLE_TPU_CACHE_DIR/torch``
  > ``$XDG_CACHE_HOME/paddle_tpu_torch`` > ``~/.cache/paddle_tpu_torch``:
  the JAX package's order, with the port's documents kept apart from the
  JAX package's (both write a ``gmm_tilings.json`` whose entries mean
  different kernels), so neither package rewrites the other's;
* ``load_json(name)`` / ``store_json(name, obj)`` — JSON documents
  committed with the temp+fsync+rename idiom, so a crash mid-write leaves
  the previous version, never a truncated one. Corrupt or missing files
  read as ``{}``.

Documents may carry a **schema version**: ``store_json(name, obj,
schema=N)`` stamps the document with ``{"__schema__": N}`` and
``load_json(name, schema=N)`` returns ``{}`` for any document whose stamp
does not match, so a process running other code starts from an empty
cache instead of misreading entries whose key format changed.
``schema=None`` (the default) reads and writes unversioned documents.

Stdlib only: callers treat persistence as best-effort (a read-only file
system never breaks a run).
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict

from ..framework.flags import define_flag, get_flag

define_flag("jit_cache_dir", "",
            "directory for persistent measured artifacts (grouped-GEMM "
            "tile widths, MoE dispatch forms); empty = "
            "$PADDLE_TPU_CACHE_DIR/torch or $XDG_CACHE_HOME/paddle_tpu_torch "
            "or ~/.cache/paddle_tpu_torch")

__all__ = ["cache_dir", "cache_path", "load_json", "store_json",
           "SCHEMA_KEY"]

SCHEMA_KEY = "__schema__"


def cache_dir() -> str:
    d = get_flag("jit_cache_dir")
    if d:
        return d
    env = os.environ.get("PADDLE_TPU_CACHE_DIR")
    if env:
        return os.path.join(env, "torch")
    xdg = os.environ.get("XDG_CACHE_HOME")
    base = xdg if xdg else os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(base, "paddle_tpu_torch")


def cache_path(name: str) -> str:
    return os.path.join(cache_dir(), name + ".json")


def load_json(name: str, schema: int = None) -> Dict[str, Any]:
    """Read a cached JSON document; missing or corrupt → ``{}``.

    With ``schema=N`` the document must carry ``{"__schema__": N}``
    (written by ``store_json(..., schema=N)``): any other stamp, or an
    unstamped file, reads as ``{}``. The stamp is stripped from the
    returned mapping."""
    try:
        with open(cache_path(name), "r") as f:
            obj = json.load(f)
        if not isinstance(obj, dict):
            return {}
    except (OSError, ValueError):
        return {}
    if schema is not None and obj.get(SCHEMA_KEY) != schema:
        return {}
    obj.pop(SCHEMA_KEY, None)
    return obj


def store_json(name: str, obj: Dict[str, Any], schema: int = None) -> bool:
    """Atomically commit ``obj`` (temp file + fsync + rename). Returns False
    instead of raising on an I/O failure: persistence is an optimization,
    never a requirement. ``schema=N`` stamps the document for
    :func:`load_json`'s check."""
    if schema is not None:
        obj = dict(obj, **{SCHEMA_KEY: schema})
    path = cache_path(name)
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                                   prefix=".tmp-" + name)
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(obj, f, indent=1, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)      # the commit point (atomic on POSIX)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return True
    except OSError:
        return False

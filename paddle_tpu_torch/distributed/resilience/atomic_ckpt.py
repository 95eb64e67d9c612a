"""Atomic, checksummed training checkpoints — the port's copy of
paddle_tpu/distributed/resilience/atomic_ckpt.py, on torch tensors.

Failure model: the writer can die at ANY byte (preempted VM, OOM-killed
process, full disk) and a reader may race a concurrent GC. The format
guarantees a reader only ever sees (a) complete, checksum-verified
snapshots or (b) nothing — never a torn one:

    root/
      step-00000008/            <- one complete snapshot
        manifest.json           <- written LAST, fsync'd; lists every array
        a00000.bin              <- raw leaf bytes (shape/dtype/crc in manifest)
        ...
      step-00000016/
      .tmp-00000024-4711/       <- in-flight write (invisible to readers)

The writer stages everything in ``.tmp-*``, fsyncs each file (``WORKERS``
threads checksum and write the leaves while the next ones come off the
card; a reader checksums its files the same way), writes the manifest
last, fsyncs the directory, then ``os.rename``s it to its final
name and fsyncs the parent — rename is the commit point (atomic on POSIX).
``load_latest_valid`` walks snapshots newest-first, re-checksums every
array, and falls back to the previous snapshot on any mismatch, so a
corrupt newest checkpoint costs one checkpoint interval, not the job.

The layout, the manifest (format 1) and the leaf order are the
reference's, so each package loads the other's snapshots:

- **Leaf order** is jax's flatten order: dict keys sorted (a loaded
  dict keeps the template's key order), lists and tuples in order, ``None`` an empty subtree, and an object with the
  ``tree_flatten`` / ``tree_unflatten`` protocol (the models'
  ``TrainState``: params, mu, nu, step) a custom node of its children.
- **The structure string** (``manifest["treedef"]``) is rendered as jax
  prints a ``PyTreeDef`` (:func:`treedef_str`); a template whose string
  differs is refused, as in the reference.
- **Leaf bytes** are the tensor's raw little-endian bytes under numpy's
  dtype name, a 0-d leaf's shape written as ``[1]`` as the reference's
  ``np.ascontiguousarray`` writes it (a 0-d template leaf gets its shape
  back); bf16 is written as its raw 16-bit words named
  ``"bfloat16"`` and read back into a byte buffer viewed as bf16 (no
  ``ml_dtypes``). Loaded leaves land on the template leaf's device.

Not ported yet: restoring the reference's core ``Tensor`` leaves in place
(ROADMAP A11) — such a leaf raises ``NotImplementedError``.
"""
from __future__ import annotations

import collections
import json
import os
import re
import shutil
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["CheckpointCorrupt", "save_checkpoint", "load_checkpoint",
           "load_latest_valid", "list_checkpoints", "validate_checkpoint",
           "flatten", "unflatten", "treedef_str", "tree_nbytes"]

MANIFEST = "manifest.json"
_STEP_RE = re.compile(r"^step-(\d{8})$")
_FORMAT = 1

# files are checksummed and written (or read and checksummed) by this many
# threads at once: zlib.crc32 and file I/O release the GIL, so a snapshot
# of a few large leaves is not held to one core's crc rate
WORKERS = min(8, os.cpu_count() or 1)
# host bytes of leaves copied off the card and queued for writing at once
_INFLIGHT_BYTES = 4 << 30

# torch dtype <-> the numpy dtype name the reference writes
_NAMES = {torch.float64: "float64", torch.float32: "float32",
          torch.float16: "float16", torch.bfloat16: "bfloat16",
          torch.int64: "int64", torch.int32: "int32", torch.int16: "int16",
          torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool",
          torch.uint16: "uint16", torch.uint32: "uint32",
          torch.uint64: "uint64", torch.complex64: "complex64",
          torch.complex128: "complex128"}
_DTYPES = {v: k for k, v in _NAMES.items()}


class CheckpointCorrupt(RuntimeError):
    """A snapshot failed validation (missing file, bad checksum, torn
    manifest). Recoverable: the loader falls back to an older snapshot."""


def _step_dirname(step: int) -> str:
    return f"step-{step:08d}"


def _fsync_path(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# flatten / unflatten in jax's order, and jax's PyTreeDef string
# ---------------------------------------------------------------------------

def _is_custom(tree) -> bool:
    return hasattr(type(tree), "tree_unflatten") \
        and hasattr(tree, "tree_flatten")


def flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, structure)`` of a nested dict / list / tuple / None /
    custom-node tree, the leaves in ``jax.tree_util.tree_flatten``'s
    order."""
    leaves: List[Any] = []

    def walk(t):
        if t is None:
            return ("none",)
        if isinstance(t, dict):
            keys = sorted(t)
            return ("dict", keys, [walk(t[k]) for k in keys], list(t))
        if isinstance(t, (list, tuple)):
            return (type(t).__name__, [walk(v) for v in t])
        if _is_custom(t):
            children, aux = t.tree_flatten()
            return ("custom", type(t), aux, [walk(c) for c in children])
        leaves.append(t)
        return ("leaf",)

    return leaves, walk(tree)


def unflatten(structure, leaves):
    """The tree of ``structure`` (from :func:`flatten`) over ``leaves``."""
    it = iter(leaves)

    def build(node):
        kind = node[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            # leaves come in sorted-key order; the dict keeps the
            # template's own key order (the order a step sums leaves in)
            got = {k: build(c) for k, c in zip(node[1], node[2])}
            return {k: got[k] for k in node[3]}
        if kind == "custom":
            return node[1].tree_unflatten(node[2],
                                          [build(c) for c in node[3]])
        seq = [build(c) for c in node[1]]
        return seq if kind == "list" else tuple(seq)

    return build(structure)


def treedef_str(structure) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for the tree whose
    structure :func:`flatten` returned."""
    def render(node):
        kind = node[0]
        if kind == "leaf":
            return "*"
        if kind == "none":
            return "None"
        if kind == "dict":
            return "{" + ", ".join(f"{k!r}: {render(c)}"
                                   for k, c in zip(node[1], node[2])) + "}"
        if kind == "custom":
            return (f"CustomNode({node[1].__name__}[{node[2]!r}], ["
                    + ", ".join(render(c) for c in node[3]) + "])")
        body = ", ".join(render(c) for c in node[1])
        if kind == "list":
            return f"[{body}]"
        return f"({body},)" if len(node[1]) == 1 else f"({body})"

    return f"PyTreeDef({render(structure)})"


def tree_nbytes(tree) -> int:
    """Bytes the leaves of ``tree`` occupy in a snapshot."""
    return sum(_leaf_nbytes(leaf) for leaf in flatten(tree)[0])


def _leaf_nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return np.asarray(leaf).nbytes


# ---------------------------------------------------------------------------
# leaf bytes
# ---------------------------------------------------------------------------

def _check_leaf(leaf) -> None:
    if hasattr(leaf, "_replace_value"):
        raise NotImplementedError(
            "checkpointing core Tensor leaves (restored in place) is not "
            "ported yet (ROADMAP A11); pass torch tensors")


def _host(leaf) -> Tuple[np.ndarray, str, List[int]]:
    """``(uint8 view of the leaf's bytes, dtype name, shape)``: a torch
    tensor is copied to the host if it lives on the card and viewed, never
    converted; anything else goes through ``np.asarray`` as in the
    reference."""
    _check_leaf(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype not in _NAMES:
            raise TypeError(f"cannot checkpoint a {t.dtype} tensor")
        t = t.to("cpu").contiguous()
        raw = t.reshape(-1).view(torch.uint8).numpy()
        # the reference's np.ascontiguousarray makes a 0-d leaf shape [1]
        return raw, _NAMES[t.dtype], list(t.shape) or [1]
    arr = np.ascontiguousarray(np.asarray(leaf))
    return arr.reshape(-1).view(np.uint8), arr.dtype.name, list(arr.shape)


def _from_bytes(buf: torch.Tensor, spec: Dict) -> torch.Tensor:
    """The leaf of ``spec`` over the uint8 buffer ``buf`` (its bytes)."""
    name = spec["dtype"]
    if name not in _DTYPES:
        raise CheckpointCorrupt(f"unknown dtype {name!r} in manifest")
    dt = _DTYPES[name]
    if buf.numel() == 0:
        return torch.empty(spec["shape"], dtype=dt)
    return buf.view(dt).reshape(spec["shape"])


# ---------------------------------------------------------------------------
# write
# ---------------------------------------------------------------------------

def save_checkpoint(tree, root: str, step: int, *, meta: Optional[Dict] = None,
                    keep: int = 3, fail_hook=None) -> str:
    """Write ``tree`` (a nested dict / list / tuple / custom-node tree of
    torch tensors or arrays) as snapshot ``step`` under ``root``; returns
    the final snapshot path.

    ``meta`` is a JSON dict stored in the manifest (step counters, RNG,
    dataloader position). ``keep`` > 0 garbage-collects all but the newest
    ``keep`` snapshots after the commit. ``fail_hook(i)`` is a test seam:
    called before array ``i`` is written, it may raise to simulate a
    storage failure mid-write — the commit rename never happens, so the
    previous snapshot stays authoritative."""
    root = os.path.abspath(root)
    os.makedirs(root, exist_ok=True)
    leaves, structure = flatten(tree)
    for leaf in leaves:
        _check_leaf(leaf)
    tmp = os.path.join(root, f".tmp-{step:08d}-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        arrays = _write_leaves(leaves, tmp, fail_hook)
        manifest = {"format": _FORMAT, "step": int(step),
                    "treedef": treedef_str(structure),
                    "num_leaves": len(leaves),
                    "meta": meta or {}, "arrays": arrays}
        mpath = os.path.join(tmp, MANIFEST)
        with open(mpath, "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(tmp)
        final = os.path.join(root, _step_dirname(step))
        if os.path.exists(final):
            # same-step collision (an emergency save racing a periodic
            # one). A valid existing snapshot with the same meta makes the
            # new write redundant; differing meta (a batch skip moved the
            # loader without a new step) replaces the stale dir — losing
            # step N in the rmtree->rename window degrades to the previous
            # snapshot, while resuming from stale meta would not be safe
            try:
                existing = validate_checkpoint(final)
                if existing.get("meta") == manifest["meta"]:
                    shutil.rmtree(tmp, ignore_errors=True)
                    return final
            except CheckpointCorrupt:
                pass
            shutil.rmtree(final)
        os.rename(tmp, final)       # <- commit point (single atomic rename)
        _fsync_path(root)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if keep > 0:
        _gc(root, keep)
    return final


def _write_file(path: str, raw) -> int:
    """Write one leaf's bytes, fsync'd; returns their crc32."""
    view = memoryview(raw)
    crc = zlib.crc32(view) & 0xFFFFFFFF
    with open(path, "wb") as f:
        f.write(view)
        f.flush()
        os.fsync(f.fileno())
    return crc


def _write_leaves(leaves, tmp: str, fail_hook) -> List[Dict]:
    """Every leaf to ``tmp/aNNNNN.bin``: copied to the host in order on
    the calling thread (``fail_hook(i)`` first), checksummed and written
    by ``WORKERS`` threads, at most ``_INFLIGHT_BYTES`` queued. Returns
    the manifest's array specs; an error propagates after every started
    write has ended."""
    arrays, futures = [], []
    pending = collections.deque()
    inflight = 0
    with ThreadPoolExecutor(max_workers=WORKERS) as pool:
        try:
            for i, leaf in enumerate(leaves):
                if fail_hook is not None:
                    fail_hook(i)
                raw, name, shape = _host(leaf)
                fname = f"a{i:05d}.bin"
                arrays.append({"file": fname, "shape": shape, "dtype": name,
                               "nbytes": int(raw.nbytes), "crc32": None})
                fut = pool.submit(_write_file, os.path.join(tmp, fname), raw)
                futures.append(fut)
                pending.append((fut, raw.nbytes))
                inflight += raw.nbytes
                while inflight > _INFLIGHT_BYTES and len(pending) > 1:
                    done, n = pending.popleft()
                    done.result()
                    inflight -= n
            for spec, fut in zip(arrays, futures):
                spec["crc32"] = fut.result()
        except BaseException:
            for fut in futures:
                fut.cancel()
            raise
    return arrays


def _gc(root: str, keep: int) -> None:
    ckpts = list_checkpoints(root)
    for _, path in ckpts[:-keep] if keep else []:
        shutil.rmtree(path, ignore_errors=True)
    # stale temp dirs from dead writers are garbage the moment the writer
    # is gone; ours was just renamed, so any .tmp-* here is orphaned
    for name in os.listdir(root):
        if name.startswith(".tmp-"):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)


def list_checkpoints(root: str) -> List[Tuple[int, str]]:
    """(step, path) of committed snapshots, oldest first. Temp dirs and
    foreign files are ignored."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _STEP_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(root, name)))
    out.sort()
    return out


# ---------------------------------------------------------------------------
# read
# ---------------------------------------------------------------------------

def _read_file(path: str, spec: Dict, keep: bool) -> Optional[torch.Tensor]:
    """One array file's bytes in a uint8 tensor (None unless ``keep``),
    checked against its spec (size, crc32) with the reference's
    messages."""
    fpath = os.path.join(path, spec["file"])
    try:
        with open(fpath, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size != spec["nbytes"]:
                raise CheckpointCorrupt(
                    f"{path}: {spec['file']} truncated "
                    f"({size} != {spec['nbytes']} bytes)")
            buf = torch.empty(size, dtype=torch.uint8)
            view = buf.numpy()
            got = f.readinto(view) if size else 0
    except OSError as e:
        raise CheckpointCorrupt(f"{path}: missing {spec['file']}: {e}")
    if got != spec["nbytes"]:
        raise CheckpointCorrupt(
            f"{path}: {spec['file']} truncated "
            f"({got} != {spec['nbytes']} bytes)")
    if (zlib.crc32(memoryview(view)) & 0xFFFFFFFF) != spec["crc32"]:
        raise CheckpointCorrupt(f"{path}: {spec['file']} checksum mismatch")
    return buf if keep else None


def _read_checked(path: str, keep: bool):
    """Read and re-checksum every array of one snapshot (``WORKERS``
    files at once): ``(manifest, buffers)`` with each file's bytes in a
    uint8 tensor when ``keep`` (one read serves validation and the load),
    else ``[]``. Raises :class:`CheckpointCorrupt` on the reference's
    conditions, for the first bad file in the manifest's order."""
    mpath = os.path.join(path, MANIFEST)
    try:
        with open(mpath) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorrupt(f"{path}: unreadable manifest: {e}")
    if manifest.get("format") != _FORMAT:
        raise CheckpointCorrupt(
            f"{path}: unknown format {manifest.get('format')!r}")
    bufs = []
    with ThreadPoolExecutor(max_workers=WORKERS) as pool:
        futures = [pool.submit(_read_file, path, spec, keep)
                   for spec in manifest["arrays"]]
        try:
            for fut in futures:
                buf = fut.result()
                if keep:
                    bufs.append(buf)
        except BaseException:
            for fut in futures:
                fut.cancel()
            raise
    return manifest, bufs


def validate_checkpoint(path: str) -> Dict:
    """Re-checksum every array of one snapshot; returns the manifest or
    raises :class:`CheckpointCorrupt`."""
    return _read_checked(path, keep=False)[0]


def load_checkpoint(path: str, template) -> Tuple[Any, Dict]:
    """Load one validated snapshot into the structure of ``template``
    (same tree the writer saved: leaf count and structure are checked).
    Each leaf comes back as a torch tensor in the saved dtype, on the
    template leaf's device (the CPU for a template leaf that is not a
    tensor). Returns ``(tree, manifest)``."""
    manifest, bufs = _read_checked(path, keep=True)
    t_leaves, structure = flatten(template)
    for leaf in t_leaves:
        _check_leaf(leaf)
    if len(t_leaves) != manifest["num_leaves"]:
        raise CheckpointCorrupt(
            f"{path}: template has {len(t_leaves)} leaves, snapshot has "
            f"{manifest['num_leaves']}")
    treedef = treedef_str(structure)
    if manifest.get("treedef") and manifest["treedef"] != treedef:
        # same leaf COUNT but different structure would load weights into
        # the WRONG leaves positionally — silent model corruption
        raise CheckpointCorrupt(
            f"{path}: template pytree structure differs from the saved "
            f"one:\n  saved:    {manifest['treedef']}\n"
            f"  template: {treedef}")
    out = []
    for old, spec, buf in zip(t_leaves, manifest["arrays"], bufs):
        t = _from_bytes(buf, spec)
        if isinstance(old, torch.Tensor):
            if old.dim() == 0 and t.shape == (1,):
                t = t.reshape(())          # a 0-d leaf, written as [1]
            if old.device.type != "cpu":
                t = t.to(old.device)
        out.append(t)
    return unflatten(structure, out), manifest


def load_latest_valid(root: str, template) -> Optional[Tuple[Any, Dict]]:
    """Newest snapshot that passes full validation, or ``None`` when no
    valid snapshot exists. A torn/corrupt newer snapshot is reported on
    stderr and skipped — recovery degrades by one checkpoint interval
    instead of failing."""
    for step, path in reversed(list_checkpoints(root)):
        try:
            return load_checkpoint(path, template)
        except CheckpointCorrupt as e:
            sys.stderr.write(
                f"[paddle_tpu_torch resilience] skipping corrupt checkpoint "
                f"step {step}: {e}\n")
    return None

"""Deterministic fault injection for recovery-path testing — the port's
copy of paddle_tpu/distributed/resilience/faults.py.

Every recovery path is exercised by injecting the failure on purpose, on
the CPU in the tests and on the card in ``chip_smoke.py``, instead of
waiting for a machine to demonstrate it. The injector is seeded and
schedule-driven, so a chaos run is exactly reproducible.

Schedules come from code or from the port's flag registry::

    FLAGS_ft_fault_schedule="readback_fail@5,pool_squeeze@9" python serve.py

Each entry fires ONCE: a retry of the same step does not re-trip the
fault. The realizations :meth:`FaultInjector.poison` and
:meth:`FaultInjector.poison_layer` work on nested dicts (and lists,
tuples or ``TrainState`` s) of torch tensors.
"""
from __future__ import annotations

import random
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ...framework.flags import define_flag, get_flag

__all__ = ["FaultInjector", "SimulatedCrash", "FAULT_KINDS",
           "SERVING_FAULT_KINDS"]

# serving-path kinds (LLMEngine(injector=...)): readback_fail crashes the
# decode readback (SimulatedCrash — ResilientEngine's recovery surface),
# slow_step stalls one engine step host-side, pool_squeeze steals half
# the free KV blocks for two steps (external pool pressure — the
# preemption/swap path's trigger), spec_verify_fail crashes a
# speculative wave between its verify dispatch and readback (nothing of
# the wave is host-visible yet), offload_crash crashes the engine's
# offload tick while async KV transfers may be in flight (abandoned
# spills release their reservations and return their custody blocks; no
# half-landed payload ever commits)
SERVING_FAULT_KINDS = ("readback_fail", "slow_step", "pool_squeeze",
                       "spec_verify_fail", "offload_crash")

# nan_inject poisons ONE named layer group of the model state for one
# attempt; its schedule entry carries the target as
# "nan_inject:<layer>@<step>" (default layer 0)
FAULT_KINDS = ("nan_grad", "inf_grad", "nan_inject", "crash",
               "collective_timeout", "storage_fail") + SERVING_FAULT_KINDS

define_flag("ft_fault_schedule", "",
            "comma list of kind@step faults to inject, e.g. "
            "'nan_grad@5,crash@9'; kinds: " + ", ".join(FAULT_KINDS))
define_flag("ft_fault_seed", 0,
            "seed for FaultInjector.random_schedule when a rate-based "
            "schedule is requested")


class SimulatedCrash(RuntimeError):
    """Stand-in for sudden worker death. Raised (not ``os._exit``) so an
    in-process harness can observe the crash and prove the recovery."""


# kinds that carry a ":<arg>" payload, with their arg validator — the
# only one is nan_inject's target layer index
_ARG_KINDS = {"nan_inject": lambda a: a == "" or a.isdigit()}


def _validate_kind(kind: str) -> None:
    """Reject unknown kinds and payloads on kinds that take none, at
    schedule-construction time: a typo'd schedule fails loudly instead
    of never firing."""
    base, sep, arg = kind.partition(":")
    if base not in FAULT_KINDS:
        raise ValueError(
            f"unknown fault kind {base!r} (have: {FAULT_KINDS})")
    if sep:
        check = _ARG_KINDS.get(base)
        if check is None:
            raise ValueError(
                f"fault kind {base!r} takes no ':<arg>' payload "
                f"(got {kind!r})")
        if not check(arg):
            raise ValueError(
                f"bad arg {arg!r} for fault kind {base!r} "
                f"(nan_inject wants a layer index, e.g. 'nan_inject:3')")


def _parse_schedule(spec: str) -> List[Tuple[str, int]]:
    out = []
    for item in filter(None, (s.strip() for s in spec.split(","))):
        kind, _, step = item.partition("@")
        if not step.isdigit():
            raise ValueError(f"bad fault entry {item!r}: want kind@step")
        out.append((kind, int(step)))
    return out                 # kinds validate in FaultInjector.__init__


def _map_leaves(fn, tree, path=()):
    """``fn(path, leaf)`` over a nested dict/list/tuple, or an object with
    the ``tree_flatten``/``tree_unflatten`` protocol (the models'
    ``TrainState``); ``path`` holds the keys and indices from the root."""
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    if hasattr(tree, "tree_flatten") and hasattr(type(tree),
                                                 "tree_unflatten"):
        children, aux = tree.tree_flatten()
        return type(tree).tree_unflatten(
            aux, [_map_leaves(fn, c, path + (i,))
                  for i, c in enumerate(children)])
    return fn(path, tree)


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


class FaultInjector:
    """Fires scheduled faults at chosen global steps, each at most once.

    ``schedule`` is a ``"kind@step,..."`` string or an iterable of
    ``(kind, step)`` pairs; ``None`` reads ``FLAGS_ft_fault_schedule``.
    """

    def __init__(self, schedule=None):
        if schedule is None:
            schedule = get_flag("ft_fault_schedule")
        if isinstance(schedule, str):
            schedule = _parse_schedule(schedule)
        self._pending: Dict[int, List[str]] = {}
        for kind, step in schedule:
            _validate_kind(str(kind))
            self._pending.setdefault(int(step), []).append(kind)
        self.fired: List[Tuple[str, int]] = []   # audit log, in fire order

    @classmethod
    def random_schedule(cls, seed: Optional[int] = None, n_steps: int = 0,
                        kinds: Sequence[str] = ("nan_grad", "crash",
                                                "storage_fail"),
                        rate: float = 0.15,
                        min_step: int = 1) -> "FaultInjector":
        """Seeded random schedule: each step in [min_step, n_steps) draws
        one fault with probability ``rate``. Same seed, same chaos."""
        rng = random.Random(get_flag("ft_fault_seed") if seed is None
                            else seed)
        sched = [(rng.choice(list(kinds)), step)
                 for step in range(min_step, n_steps)
                 if rng.random() < rate]
        return cls(sched)

    @property
    def pending(self) -> List[Tuple[str, int]]:
        return sorted((k, s) for s, ks in self._pending.items() for k in ks)

    def take(self, step: int) -> List[str]:
        """Pop and return the faults scheduled for ``step`` (one-shot:
        the same step asked again gets nothing)."""
        kinds = self._pending.pop(int(step), [])
        self.fired.extend((k, int(step)) for k in kinds)
        return kinds

    def fires(self, kind: str, step: int) -> bool:
        """Pop one specific fault if scheduled at ``step``."""
        kinds = self._pending.get(int(step), [])
        if kind in kinds:
            kinds.remove(kind)
            if not kinds:
                self._pending.pop(int(step), None)
            self.fired.append((kind, int(step)))
            return True
        return False

    def take_arg(self, kind: str, step: int) -> Optional[str]:
        """Pop one ``kind`` (or ``kind:<arg>``) fault scheduled at
        ``step``; returns its arg string (``""`` when none) or ``None``
        when nothing is scheduled — one-shot like :meth:`fires`."""
        kinds = self._pending.get(int(step), [])
        for entry in kinds:
            base, _, arg = entry.partition(":")
            if base != kind:
                continue
            kinds.remove(entry)
            if not kinds:
                self._pending.pop(int(step), None)
            self.fired.append((entry, int(step)))
            return arg
        return None

    # -- fault realizations (what a loop applies when a kind fires) -------
    @staticmethod
    def poison(tree, kind: str = "nan_grad"):
        """The observable effect of a NaN/Inf gradient: every float leaf
        of the tree is non-finite (a new tree; other leaves are shared)."""
        bad = float("inf") if kind == "inf_grad" else float("nan")
        return _map_leaves(
            lambda _p, x: torch.full_like(x, bad) if _is_float(x) else x,
            tree)

    @staticmethod
    def poison_layer(tree, layer: int, kind: str = "nan_grad"):
        """The targeted realization behind ``nan_inject``: NaN (or Inf)
        the ``layer``-th slice of every stacked float leaf under a
        ``"layers"`` key. Returns a poisoned COPY (poisoned leaves are
        cloned, the rest shared); leaves outside a ``layers`` key are
        untouched. A target no leaf covers raises — a drill that poisons
        nothing must not pass for one that did."""
        if layer < 0:
            raise ValueError(f"poison_layer: layer must be >= 0, got "
                             f"{layer} (negative indices would poison "
                             "the wrong layer)")
        bad = float("inf") if kind == "inf_grad" else float("nan")
        hits = []

        def p(path, x):
            if ("layers" in path and _is_float(x) and x.dim() >= 1
                    and x.shape[0] > layer):
                hits.append(path)
                x = x.clone()
                x[layer] = bad
            return x

        out = _map_leaves(p, tree)
        if not hits:
            raise ValueError(
                f"poison_layer: no stacked float leaf under a 'layers' "
                f"mapping covers layer {layer} — wrong target or wrong "
                "state tree")
        return out

    def storage_hook(self, step: int):
        """A ``fail_hook`` for a checkpoint writer: raises ``OSError``
        midway through the write (after the first array) when
        ``storage_fail`` is scheduled at ``step``."""
        if not self.fires("storage_fail", step):
            return None

        def hook(i: int):
            if i >= 1:
                raise OSError(
                    f"injected storage failure at step {step} (array {i})")
        return hook

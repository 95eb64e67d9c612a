"""Lock-safe metrics registry: Counter / Gauge / Histogram with labels —
the port's copy of paddle_tpu/observability/metrics.py.

Design points (reference analogue: the stats layer over
paddle/fluid/platform/profiler — always-on counters the host tracer's
scheduled captures cannot provide):

- **near-zero when disabled**: every mutation checks ``state.enabled()``
  first and returns; the instrument objects themselves are created once at
  import of the instrumented module, so the steady-state cost of a
  disabled counter is one global read + one attribute call.
- **lock-safe**: Python's ``+=`` on a float is a read-modify-write — NOT
  atomic under threads. Each label-set child carries its own lock, so
  concurrent increments from loader workers / watchdog threads never lose
  updates, and contention stays per-series.
- **label cardinality cap**: a family stops minting children at
  ``FLAGS_obs_max_series`` distinct label sets; the overflow collapses
  into one ``{overflow="true"}`` series (the job stays observable when a
  caller labels by request id by mistake).
- **histograms**: fixed log-spaced buckets chosen at construction
  (:func:`log_buckets`), Prometheus ``le`` semantics (inclusive upper
  bound, cumulative on exposition).
- **scoped views**: ``registry.scoped(replica="r0")`` returns a
  :class:`ScopedView` whose :meth:`~ScopedView.activate` installs a
  THREAD-LOCAL label set that family-level mutations auto-merge — the
  replica router activates one per step thread, so every instrument an
  engine touches from that thread lands in a ``{replica="r0"}`` series
  without the engine knowing it runs behind a router. The scope check
  sits AFTER the ``state.enabled()`` early return (disabled cost is
  unchanged) and behind one module-global read that stays False until
  the first scope ever activates (unscoped enabled cost is one extra
  global read). Direct child access (``fam.labels()``) bypasses the
  scope on purpose — process-global series stay reachable from scoped
  threads (perf's fleet-wide SLO gauges use this).
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple

from ..framework.flags import get_flag
from . import state

__all__ = ["Registry", "Counter", "Gauge", "Histogram", "ScopedView",
           "log_buckets", "time_buckets", "get_registry", "counter",
           "gauge", "histogram"]

# Thread-scoped auto-labels. _SCOPES_SEEN stays False until the
# FIRST ScopedView ever activates, so processes that never scope (every
# engine outside a router) pay one module-global read per enabled
# mutation and nothing else; the thread-local lookup only happens once
# a scope exists somewhere in the process.
_SCOPES_SEEN = False
_tls_scope = threading.local()


def _scope_labels() -> Optional[Dict[str, str]]:
    if not _SCOPES_SEEN:
        return None
    return getattr(_tls_scope, "labels", None)


def log_buckets(lo: float, hi: float, per_decade: int = 4) -> List[float]:
    """Fixed log-spaced bucket bounds covering [lo, hi]."""
    if not (lo > 0 and hi > lo):
        raise ValueError(f"log_buckets: need 0 < lo < hi, got {lo}, {hi}")
    n = int(math.ceil(math.log10(hi / lo) * per_decade))
    out = [float(f"{lo * 10 ** (i / per_decade):.6g}") for i in range(n + 1)]
    return out


def time_buckets() -> List[float]:
    """Default duration buckets: 100 us .. 100 s, 4 per decade."""
    return log_buckets(1e-4, 100.0, per_decade=4)


def _label_key(labels: Dict[str, str]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class _Child:
    __slots__ = ("labels", "_lock")

    def __init__(self, labels):
        self.labels = dict(labels)
        self._lock = threading.Lock()


class _CounterChild(_Child):
    __slots__ = ("value",)

    def __init__(self, labels):
        super().__init__(labels)
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if not state.enabled():
            return
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class _GaugeChild(_Child):
    # `updated` distinguishes an explicit set(0) (e.g. 0% SLO attainment,
    # which MUST surface) from a never-touched instrument created at import
    # (which renderers may hide).
    __slots__ = ("value", "updated")

    def __init__(self, labels):
        super().__init__(labels)
        self.value = 0.0
        self.updated = False

    def set(self, value: float) -> None:
        if not state.enabled():
            return
        self.value = float(value)    # single store: atomic under the GIL
        self.updated = True

    def inc(self, amount: float = 1.0) -> None:
        if not state.enabled():
            return
        with self._lock:
            self.value += amount
            self.updated = True

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)


class _HistogramChild(_Child):
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, labels, bounds):
        super().__init__(labels)
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float) -> None:
        if not state.enabled():
            return
        # Prometheus le is an INCLUSIVE upper bound: value == bound lands
        # in that bound's bucket (bisect_left finds the first bound >= v)
        i = bisect.bisect_left(self.bounds, value)
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1


_CHILD_TYPES = {"counter": _CounterChild, "gauge": _GaugeChild,
                "histogram": _HistogramChild}


class _Family:
    """One named metric; children are its label sets."""

    kind: str = ""

    def __init__(self, name: str, help: str = "", *,  # noqa: A002
                 buckets: Optional[Sequence[float]] = None,
                 max_series: Optional[int] = None):
        self.name = name
        self.help = help
        self.bounds = sorted(float(b) for b in buckets) if buckets else None
        self._max_series = max_series
        self._children: Dict[Tuple, _Child] = {}
        self._lock = threading.Lock()
        # observations routed to the overflow series (approximate: bumped
        # lock-free on the capped fast path, races may undercount — a
        # diagnostic, not a metric)
        self._overflow_observations = 0
        self._overflow: Optional[_Child] = None
        self._default = self._make(())       # the labelless fast path

    def _make(self, key) -> _Child:
        cls = _CHILD_TYPES[self.kind]
        labels = dict(key)
        child = (cls(labels, self.bounds) if self.kind == "histogram"
                 else cls(labels))
        self._children[key] = child
        return child

    @property
    def max_series(self) -> int:
        if self._max_series is not None:
            return self._max_series
        return int(get_flag("obs_max_series"))

    def labels(self, **labels) -> _Child:
        """The child for this label set (created on first use, capped)."""
        if not labels:
            return self._default
        key = _label_key(labels)
        child = self._children.get(key)
        if child is not None:
            return child
        if self._overflow is not None:
            # capped family on a hot path (the exact mistake the cap
            # defends against, e.g. labeling by request id): stay off the
            # family lock — route straight to the cached overflow series
            self._overflow_observations += 1
            return self._overflow
        with self._lock:
            child = self._children.get(key)
            if child is not None:
                return child
            if len(self._children) >= self.max_series:
                self._overflow_observations += 1
                okey = (("overflow", "true"),)
                self._overflow = self._children.get(okey) \
                    or self._make(okey)
                return self._overflow
            return self._make(key)

    def _target(self, labels: Dict) -> _Child:
        """Resolve a family-level mutation to its child, merging the
        calling thread's scope labels (explicit labels win on a key
        collision). Runs AFTER the enabled() check — disabled cost is
        untouched, unscoped enabled cost is one global read."""
        sl = _scope_labels()
        if sl:
            merged = dict(sl)
            if labels:
                merged.update(labels)
            return self.labels(**merged)
        return self._default if not labels else self.labels(**labels)

    def series(self) -> List[_Child]:
        with self._lock:
            return list(self._children.values())

    def reset(self) -> None:
        """Zero every series (test isolation; call sites keep their family
        references, so children are zeroed in place and extras dropped)."""
        with self._lock:
            self._children = {}
            self._overflow_observations = 0
            self._overflow = None
            self._default = self._make(())


class Counter(_Family):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not state.enabled():
            return
        self._target(labels).inc(amount)


class Gauge(_Family):
    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        if not state.enabled():
            return
        self._target(labels).set(value)

    def inc(self, amount: float = 1.0, **labels) -> None:
        if not state.enabled():
            return
        self._target(labels).inc(amount)

    def dec(self, amount: float = 1.0, **labels) -> None:
        self.inc(-amount, **labels)


class Histogram(_Family):
    kind = "histogram"

    def __init__(self, name, help="", *, buckets=None, max_series=None):  # noqa: A002
        super().__init__(name, help,
                         buckets=list(buckets) if buckets else time_buckets(),
                         max_series=max_series)

    def observe(self, value: float, **labels) -> None:
        if not state.enabled():
            return
        self._target(labels).observe(value)


class ScopedView:
    """Label-scoped view of a registry (fleet observability).

    Two uses: (1) :meth:`activate` installs the labels as the calling
    thread's scope — every family-level mutation from that thread then
    auto-merges them (and spans recorded from it carry them as args) —
    this is what the replica router does per step thread; (2) the bound
    ``counter/gauge/histogram`` accessors stamp the labels explicitly,
    for cross-thread writes on a replica's behalf. Also usable as a
    context manager around a scoped block on the current thread.
    """

    __slots__ = ("_registry", "labels", "_prev")

    def __init__(self, registry: "Registry", labels: Dict[str, str]):
        if not labels:
            raise ValueError("ScopedView needs at least one label")
        self._registry = registry
        self.labels = {k: str(v) for k, v in labels.items()}
        self._prev: Optional[Dict[str, str]] = None

    def activate(self) -> "ScopedView":
        """Install the scope on the CURRENT thread (replacing any prior
        scope, which :meth:`deactivate` restores). Also stamps the same
        labels as thread-local span attrs so Chrome-trace exports stay
        attributable per replica."""
        global _SCOPES_SEEN
        _SCOPES_SEEN = True
        self._prev = getattr(_tls_scope, "labels", None)
        _tls_scope.labels = dict(self.labels)
        from . import tracing
        tracing.set_thread_attrs(self.labels)
        return self

    def deactivate(self) -> None:
        _tls_scope.labels = self._prev
        self._prev = None
        from . import tracing
        tracing.set_thread_attrs(getattr(_tls_scope, "labels", None))

    def __enter__(self) -> "ScopedView":
        return self.activate()

    def __exit__(self, *exc) -> bool:
        self.deactivate()
        return False

    def counter(self, name: str, help: str = "") -> "_BoundInstrument":  # noqa: A002
        return _BoundInstrument(self._registry.counter(name, help),
                                self.labels)

    def gauge(self, name: str, help: str = "") -> "_BoundInstrument":  # noqa: A002
        return _BoundInstrument(self._registry.gauge(name, help),
                                self.labels)

    def histogram(self, name: str, help: str = "",  # noqa: A002
                  **kw) -> "_BoundInstrument":
        return _BoundInstrument(self._registry.histogram(name, help, **kw),
                                self.labels)


class _BoundInstrument:
    """A family with a scope's labels pre-applied (explicit labels on a
    call still win on key collisions — same merge rule as the
    thread-scope path)."""

    __slots__ = ("_fam", "_labels")

    def __init__(self, fam: _Family, labels: Dict[str, str]):
        self._fam = fam
        self._labels = dict(labels)

    def _merged(self, labels: Dict) -> Dict:
        merged = dict(self._labels)
        merged.update(labels)
        return merged

    def inc(self, amount: float = 1.0, **labels) -> None:
        self._fam.inc(amount, **self._merged(labels))

    def dec(self, amount: float = 1.0, **labels) -> None:
        self._fam.dec(amount, **self._merged(labels))

    def set(self, value: float, **labels) -> None:
        self._fam.set(value, **self._merged(labels))

    def observe(self, value: float, **labels) -> None:
        self._fam.observe(value, **self._merged(labels))

    def child(self, **labels) -> _Child:
        return self._fam.labels(**self._merged(labels))


class Registry:
    """Process-wide family registry. ``counter/gauge/histogram`` are
    get-or-create: instrumented modules can declare the same metric
    independently and share one family (names are the identity; a kind
    mismatch is a bug and raises)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _get_or_create(self, cls, name, help, **kw):  # noqa: A002
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind}")
                return fam
            fam = cls(name, help, **kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "") -> Counter:  # noqa: A002
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:  # noqa: A002
        return self._get_or_create(Gauge, name, help)

    def histogram(self, name: str, help: str = "", *,  # noqa: A002
                  buckets: Optional[Sequence[float]] = None,
                  max_series: Optional[int] = None) -> Histogram:
        return self._get_or_create(Histogram, name, help, buckets=buckets,
                                   max_series=max_series)

    def scoped(self, **labels) -> ScopedView:
        """A cheap label-scoped child view: ``registry.scoped(
        replica="r0")``. See :class:`ScopedView`."""
        return ScopedView(self, labels)

    def families(self) -> List[_Family]:
        with self._lock:
            return list(self._families.values())

    def reset(self) -> None:
        """Zero all series in place (families stay registered — live call
        sites hold references to them)."""
        for fam in self.families():
            fam.reset()


_default_registry = Registry()


def get_registry() -> Registry:
    return _default_registry


def counter(name: str, help: str = "") -> Counter:  # noqa: A002
    return _default_registry.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:  # noqa: A002
    return _default_registry.gauge(name, help)


def histogram(name: str, help: str = "", **kw) -> Histogram:  # noqa: A002
    return _default_registry.histogram(name, help, **kw)
